"""The plain operations the reference families share.

Every product of a weight goes through :func:`mm`, which computes in the
reference's precision: ``"f32"`` (float32, TF32 off), or a lower-precision
control whose operands are rounded before a float32 product: ``"fp8"``
(float8 e4m3, one scale per tensor; the control of a bf16
configuration) or ``"bf16"`` (the control of a float32 one).
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

PRECISIONS = ("f32", "bf16", "fp8")
#: the largest finite float8 e4m3 value
FP8_MAX = 448.0


def strict_f32() -> None:
    """Float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class _RoundFP8(torch.autograd.Function):
    """A tensor rounded to float8 e4m3 under one scale (its absolute max
    to 448); the gradient passes straight through."""

    @staticmethod
    def forward(ctx, x):
        scale = FP8_MAX / x.detach().abs().amax().clamp(min=1e-30)
        return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundBF16(torch.autograd.Function):
    """A tensor rounded to bfloat16; the gradient passes straight through."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def mm(a, w, prec: str):
    """``a @ w`` in the precision ``prec``."""
    if prec == "fp8":
        a, w = _RoundFP8.apply(a), _RoundFP8.apply(w)
    elif prec == "bf16":
        a, w = _RoundBF16.apply(a), _RoundBF16.apply(w)
    elif prec != "f32":
        raise ValueError(f"precision {prec!r}: not one of {PRECISIONS}")
    return a @ w


def rms_norm(x, scale, eps: float):
    """``x / rms(x) * (1 + scale)``."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale)


def rope(x, theta: float):
    """Rotary embedding of ``x [B, S, H, hd]`` at positions ``0 .. S-1``:
    the first and second halves of each head rotate as pairs."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freq
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v, q0: int, k0: int, window):
    """Softmax attention of queries at positions ``q0 ..`` on keys at
    ``k0 ..``: each query sees the keys at or before it, and within
    ``window`` of it when given.  q ``[B, Sq, H, hd]``, k and v ``[B, Sk,
    H, hd]``."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    qpos = q0 + torch.arange(q.shape[1], device=q.device)[:, None]
    kpos = k0 + torch.arange(k.shape[1], device=q.device)[None, :]
    seen = kpos <= qpos
    if window is not None:
        seen = seen & (kpos > qpos - window)
    s = s.masked_fill(~seen, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def attention(q, k, v, window=None, chunk: int = 512):
    """Causal GQA attention: q ``[B, S, H, hd]``, k and v ``[B, S, KV,
    hd]`` (query head ``h`` reads key head ``h // (H / KV)``), in chunks of
    ``chunk`` queries against the keys they can see; with autograd on,
    each chunk is recomputed in the backward pass.  Returns ``[B, S, H *
    hd]``."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    k, v = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
    outs = []
    for q0 in range(0, S, chunk):
        q1 = min(q0 + chunk, S)
        k0 = max(0, q0 - window + 1) if window is not None else 0
        args = (q[:, q0:q1], k[:, k0:q1], v[:, k0:q1], q0, k0, window)
        outs.append(checkpoint(_attend, *args, use_reentrant=False)
                    if torch.is_grad_enabled() else _attend(*args))
    return torch.cat(outs, dim=1).reshape(B, S, H * hd)


def self_attention(h, p, c, prec: str):
    """The attention branch on the normed input ``h [B, S, D]``."""
    B, S, _ = h.shape
    H, KV, hd = c.heads, c.kv_heads, c.head_dim
    q = rope(mm(h, p["mixer.wq"], prec).reshape(B, S, H, hd), c.theta)
    k = rope(mm(h, p["mixer.wk"], prec).reshape(B, S, KV, hd), c.theta)
    v = mm(h, p["mixer.wv"], prec).reshape(B, S, KV, hd)
    return mm(attention(q, k, v, c.window), p["mixer.wo"], prec)


def swiglu(x, wg, wu, wd, prec: str):
    return mm(torch.nn.functional.silu(mm(x, wg, prec)) * mm(x, wu, prec),
              wd, prec)
