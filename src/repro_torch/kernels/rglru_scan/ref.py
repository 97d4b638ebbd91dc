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


def rglru_scan_assoc(a, x, h0):
    """The same recurrence as a log-depth associative scan
    (Hillis–Steele): ``ceil(log2 S)`` rounds of whole-tensor ops compose
    each step's ``(a, x)`` with the step ``2^r`` before it, so the op count
    does not grow with ``S`` (a dry run's trace on ``meta``, where a
    per-step loop would dispatch ``S`` ops).  Returns (h [B,S,D],
    h_final [B,D] f32)."""
    A, X = a.float(), x.float()
    X = torch.cat([A[:, :1] * h0.float()[:, None] + X[:, :1], X[:, 1:]], 1)
    S, shift = a.shape[1], 1
    while shift < S:
        X = torch.cat([X[:, :shift], A[:, shift:] * X[:, :-shift]
                       + X[:, shift:]], 1)
        A = torch.cat([A[:, :shift], A[:, shift:] * A[:, :-shift]], 1)
        shift *= 2
    return X.to(a.dtype), X[:, -1]
