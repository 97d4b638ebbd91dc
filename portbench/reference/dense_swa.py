"""The dense decoder with (optionally sliding-window) GQA attention:
pre-norm attention and pre-norm SwiGLU FFN, each added to the residual
stream (h2o-danube-3-4b: full causal attention, no window)."""
from __future__ import annotations

from .layout import attention_weights, decoder_groups, swiglu_groups
from .ops import rms_norm, self_attention, swiglu


def groups(c) -> list:
    """The weights' groups (:mod:`.layout`)."""
    return decoder_groups(c) + swiglu_groups(c)


def active_weights(c) -> int:
    """One layer's weights that one token passes through."""
    return attention_weights(c) + 3 * c["hidden_size"] \
        * c["intermediate_size"]


def block(x, p, c, prec: str):
    """One layer on ``x [B, S, D]`` (float32); returns ``(x, None)``: the
    dense family adds no auxiliary loss."""
    x = x + self_attention(rms_norm(x, p["norm1.scale"], c.eps), p, c, prec)
    h = rms_norm(x, p["norm2.scale"], c.eps)
    return x + swiglu(h, p["ffn.wg"], p["ffn.wu"], p["ffn.wd"], prec), None
