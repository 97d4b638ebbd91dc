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
    B, H, Sq, d = q.shape
    Sk = k.shape[2]
    # f32, or f64 for f64 operands (a model's f64 run)
    wt = torch.float64 if q.dtype == torch.float64 else torch.float32
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(wt), k.to(wt)) / math.sqrt(d)
    qpos = q0 + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    s = torch.where(mask[None, None], s, -torch.inf)
    m = torch.clamp(torch.amax(s, dim=-1, keepdim=True), min=-1e30)
    p = torch.exp(s - m)
    l = torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bhqk,bhkd->bhqd", p / l, v.to(wt))
    return o.to(q.dtype)
