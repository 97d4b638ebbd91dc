"""Public op: flash attention with a custom backward.

Forward runs the kernel.  The backward recomputes through the oracle, as
the config's ``attn_vjp`` says: ``"flash"`` (the JAX model's
``_mha_chunked`` VJP) recomputes and differentiates chunks of ``q_chunk``
query rows one at a time (:func:`~.ref.attention_chunked_bwd`: the
scores never exceed one chunk's); ``"autodiff"`` takes autograd of the
whole ``attention_ref`` at once, whose graph keeps the whole ``[B, H, Sq,
Sk]`` score matrix several times, as the JAX model's autodiff through its
chunk scan keeps every chunk's."""
from __future__ import annotations

import torch

from .kernel import flash_attention_fwd
from .ref import attention_chunked_bwd, attention_ref

#: the backward routes, by the config's ``attn_vjp``
VJPS = ("autodiff", "flash")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, vjp, q_chunk):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        ctx.vjp, ctx.q_chunk = vjp, q_chunk
        return flash_attention_fwd(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, do):
        if ctx.vjp == "flash":
            grads = attention_chunked_bwd(
                *ctx.saved_tensors, do, causal=ctx.causal,
                window=ctx.window, q_chunk=ctx.q_chunk)
        else:
            inputs = [t.detach().requires_grad_()
                      for t in ctx.saved_tensors]
            with torch.enable_grad():
                o = attention_ref(*inputs, causal=ctx.causal,
                                  window=ctx.window)
            grads = torch.autograd.grad(o, inputs, do)
        return (*grads, None, None, None, None)


def flash_attention(q, k, v, causal: bool = True, window=None,
                    vjp: str = "autodiff", q_chunk: int = 512):
    """q,k,v: [B,H,S,d] (repeat GQA kv to H heads first); ``vjp``: the
    backward's route (:data:`VJPS`), ``q_chunk`` the query rows of a
    ``"flash"`` backward's chunk."""
    if vjp not in VJPS:
        raise ValueError(f"attn_vjp={vjp!r}: not one of {VJPS}")
    return _FlashAttention.apply(q, k, v, causal, window, vjp, q_chunk)
