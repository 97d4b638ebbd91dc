"""Pure-torch oracle for flash attention."""
from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal: bool = True, window=None):
    """q,k,v: [B,H,S,d]; full-matrix softmax attention."""
    B, H, Sq, d = q.shape
    Sk = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
    qpos = torch.arange(Sq, device=q.device)[:, None]
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
    o = torch.einsum("bhqk,bhkd->bhqd", p / l, v.float())
    return o.to(q.dtype)
