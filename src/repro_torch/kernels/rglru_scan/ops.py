"""Public op: RG-LRU scan with a custom backward (recomputed through the
oracle — linear recurrences transpose cleanly, and the forward kernel
already bounds activation traffic)."""
from __future__ import annotations

import torch

from .kernel import rglru_scan_fwd
from .ref import rglru_scan_assoc, rglru_scan_ref


class _RglruScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, x, h0):
        ctx.save_for_backward(a, x, h0)
        return rglru_scan_fwd(a, x, h0)

    @staticmethod
    def backward(ctx, dh, dh_final):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        # on meta (a dry run's trace) the same function in few ops
        ref = rglru_scan_assoc if inputs[0].device.type == "meta" \
            else rglru_scan_ref
        with torch.enable_grad():
            outs = ref(*inputs)
        return torch.autograd.grad(outs, inputs, (dh, dh_final))


def rglru_scan(a, x, h0):
    """a, x: [B,S,D]; h0: [B,D] f32.  Returns (h [B,S,D], h_final [B,D])."""
    return _RglruScan.apply(a, x, h0)
