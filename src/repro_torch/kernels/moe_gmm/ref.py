"""Pure-torch oracle for the grouped matmul."""
from __future__ import annotations

import torch


def moe_gmm_ref(x, w, counts):
    """x: [E,C,D]; w: [E,D,F]; counts: [E].  Rows past counts[e] are
    treated as dead (zeroed), matching the kernel's tile skipping."""
    E, C, D = x.shape
    rows = torch.arange(C, device=x.device)[None, :, None]
    live = rows < counts.to(x.device)[:, None, None]
    xz = torch.where(live, x, torch.zeros_like(x))
    out = torch.einsum("ecd,edf->ecf", xz.float(), w.float())
    return out.to(x.dtype)
