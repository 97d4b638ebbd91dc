"""Public op: chunked gated linear attention (mLSTM core) with a backward
recomputed through the oracle."""
from __future__ import annotations

import torch

from .kernel import mlstm_chunk_fwd, mlstm_chunk_plain
from .ref import mlstm_chunk_ref


class _MlstmChunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, lf, gi, bt):
        ctx.save_for_backward(q, k, v, lf, gi)
        ctx.bt = bt
        return mlstm_chunk_fwd(q, k, v, lf, gi, bt=bt)

    @staticmethod
    def backward(ctx, dy, dc):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            # on meta (a dry run's trace) the chunked plain version: the
            # same function in few ops
            outs = mlstm_chunk_plain(*inputs, bt=ctx.bt) \
                if inputs[0].device.type == "meta" else \
                mlstm_chunk_ref(*inputs)
        return (*torch.autograd.grad(outs, inputs, (dy, dc)), None)


def mlstm_chunk(q, k, v, lf, gi, bt: int = 128):
    """q,k: [BH,S,dk]; v: [BH,S,dv]; lf, gi: [BH,S,1]; chunks of ``bt``
    steps.  Returns (y [BH,S,dv], C_final [BH,dk,dv] f32)."""
    return _MlstmChunk.apply(q, k, v, lf, gi, bt)
