"""Pure-torch oracle for the RG-LRU recurrence."""
from __future__ import annotations

import torch


def rglru_scan_ref(a, x, h0):
    """h_t = a_t * h_{t-1} + x_t.  a,x: [B,S,D]; h0: [B,D].
    Returns (h [B,S,D], h_final [B,D] f32; f64 for f64 ``a``: a model's
    f64 run)."""
    wt = torch.float64 if a.dtype == torch.float64 else torch.float32
    h = h0.to(wt)
    hs = []
    # the steps taken apart once: autograd then stacks their gradients in
    # one op, where a slice a step would fill a zero gradient of the whole
    # [B,S,D] each step (3072 steps of 63 MB in recurrentgemma-2b's)
    for at, xt in zip(a.to(wt).unbind(1), x.to(wt).unbind(1)):
        h = at * h + xt
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
