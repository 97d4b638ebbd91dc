"""Public op: grouped expert matmul with a backward recomputed through the
oracle."""
from __future__ import annotations

import torch

from .kernel import moe_gmm_fwd
from .ref import moe_gmm_ref


class _MoeGmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, counts):
        ctx.save_for_backward(x, w, counts)
        return moe_gmm_fwd(x, w, counts)

    @staticmethod
    def backward(ctx, ct):
        x, w, counts = ctx.saved_tensors
        inputs = [x.detach().requires_grad_(), w.detach().requires_grad_()]
        with torch.enable_grad():
            out = moe_gmm_ref(*inputs, counts)
        dx, dw = torch.autograd.grad(out, inputs, ct)
        return dx, dw, None


def moe_gmm(x, w, counts):
    """x: [E,C,D]; w: [E,D,F]; counts: [E] int32.  Returns [E,C,F]."""
    return _MoeGmm.apply(x, w, counts)
