"""Pure-torch oracle for flash attention."""
from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal: bool = True, window=None):
    """q,k,v: [B,H,S,d]; full-matrix softmax attention."""
    return _attend(q, k, v, causal, window, 0)


def attention_chunked(q, k, v, *, causal: bool = True, window=None,
                      q_chunk: int = 512):
    """:func:`attention_ref` over chunks of ``q_chunk`` query rows, each
    against every key: the JAX model's plain attention
    (``_mha_chunked_fwd``'s chunks of 512), whose scores never exceed
    ``[B, H, q_chunk, Sk]`` at a time."""
    Sq = q.shape[2]
    return torch.cat([_attend(q[:, :, q0:q0 + q_chunk], k, v, causal,
                              window, q0)
                      for q0 in range(0, Sq, q_chunk)], dim=2)


def _attend(q, k, v, causal, window, q0: int):
    """Attention of the queries at positions ``q0 ..`` on every key."""
    p = _probs(q, k, causal, window, q0, 0)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.to(p.dtype)).to(q.dtype)


def _probs(q, k, causal, window, q0: int, k0: int):
    """The normalized probabilities ``[B, H, Sq, Sk]`` of the queries at
    positions ``q0 ..`` on the keys at ``k0 ..`` (the JAX model's
    ``_attn_probs``: masked scores, the row max clamped at -1e30, the sum
    at 1e-30), in f32, or f64 for f64 operands (a model's f64 run)."""
    Sq, d = q.shape[2], q.shape[3]
    Sk = k.shape[2]
    wt = torch.float64 if q.dtype == torch.float64 else torch.float32
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(wt), k.to(wt)) / math.sqrt(d)
    qpos = q0 + torch.arange(Sq, device=q.device)[:, None]
    kpos = k0 + torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    s = torch.where(mask[None, None], s, -torch.inf)
    m = torch.clamp(torch.amax(s, dim=-1, keepdim=True), min=-1e30)
    p = torch.exp(s - m)
    l = torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    return p / l


def attention_chunked_bwd(q, k, v, do, *, causal: bool = True, window=None,
                          q_chunk: int = 512):
    """``(dq, dk, dv)`` of :func:`attention_ref` for the cotangent ``do``,
    in the inputs' types: the JAX model's flash backward
    (``_mha_chunked_bwd``) over chunks of ``q_chunk`` query rows, the last
    one shorter where ``q_chunk`` does not divide ``Sq``.  Each chunk
    recomputes its probabilities ``p`` and takes ``dv += pᵀ·do``, ``dp =
    do·vᵀ``, ``ds = p·(dp − rowsum(p·dp))``, ``dq = ds·k·scale`` and ``dk
    += dsᵀ·q·scale``, in f32 (f64 for f64 operands), on the keys its rows
    can see (causal: none past its last row; windowed: none left of its
    first row's band).  No chunk's tensors outlive its iteration, so the
    scores never exceed ``[B, H, q_chunk, Sk]`` at a time."""
    B, H, Sq, d = q.shape
    Sk = k.shape[2]
    wt = torch.float64 if q.dtype == torch.float64 else torch.float32
    scale = 1.0 / math.sqrt(d)
    kf, vf = k.to(wt), v.to(wt)
    dq = torch.zeros((B, H, Sq, d), dtype=wt, device=q.device)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for q0 in range(0, Sq, q_chunk):
        q1 = min(q0 + q_chunk, Sq)
        k1 = min(Sk, q1) if causal else Sk
        k0 = min(max(0, q0 - window + 1), k1) if window is not None else 0
        if k0 == k1:   # every key masked: p = 0, no gradient
            continue
        qc, doc = q[:, :, q0:q1].to(wt), do[:, :, q0:q1].to(wt)
        kc, vc = kf[:, :, k0:k1], vf[:, :, k0:k1]
        p = _probs(qc, kc, causal, window, q0, k0)
        dv[:, :, k0:k1] += p.transpose(-1, -2) @ doc
        ds = doc @ vc.transpose(-1, -2)                     # dp
        ds -= (p * ds).sum(-1, keepdim=True)
        ds *= p
        del p
        dq[:, :, q0:q1] = (ds @ kc) * scale
        dk[:, :, k0:k1] += (ds.transpose(-1, -2) @ qc) * scale
        del ds
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
