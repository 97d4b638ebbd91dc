"""Pure-torch oracle for the RG-LRU recurrence."""
from __future__ import annotations

import torch


def rglru_scan_ref(a, x, h0):
    """h_t = a_t * h_{t-1} + x_t.  a,x: [B,S,D]; h0: [B,D].
    Returns (h [B,S,D], h_final [B,D] f32)."""
    h = h0.float()
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t].float() * h + x[:, t].float()
        hs.append(h)
    return torch.stack(hs, 1).to(a.dtype), h
