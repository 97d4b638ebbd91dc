"""Public op: flash attention with a custom backward.

Forward runs the kernel; backward recomputes through the oracle (a flash
backward kernel is a further optimization — the recompute keeps activation
memory at flash levels)."""
from __future__ import annotations

import torch

from .kernel import flash_attention_fwd
from .ref import attention_ref


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return flash_attention_fwd(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, do):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            o = attention_ref(*inputs, causal=ctx.causal, window=ctx.window)
        return (*torch.autograd.grad(o, inputs, do), None, None)


def flash_attention(q, k, v, causal: bool = True, window=None):
    """q,k,v: [B,H,S,d] (repeat GQA kv to H heads first)."""
    return _FlashAttention.apply(q, k, v, causal, window)
