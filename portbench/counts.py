"""Work counted from a configuration's sizes: attention pairs and the
weights a token passes through.  ``c`` is a configuration file's mapping
(``configs/<name>.json``: Hugging Face key names)."""
from __future__ import annotations

from .reference import family
from .reference.layout import head_dim


def attn_pairs(S: int, window=None) -> int:
    """(query, key) pairs of causal attention over ``S`` positions, each
    query seeing at most ``window`` keys (itself included) when given."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def block_weights_active(c) -> int:
    """Every layer's weights that one token passes through (norms left
    out: they are no product); the family counts a layer's."""
    return c["num_hidden_layers"] * family(c).active_weights(c)


def head_weights(c) -> int:
    """The output head over the published vocabulary."""
    return c["hidden_size"] * c["vocab_size"]


def attention_flops(c, B: int, S: int, backward: bool) -> float:
    """Attention's score and value products over causal (windowed) pairs
    in every layer: 2 products of 2 operations a pair a head dimension,
    three times that with the backward's four products."""
    per = 4.0 * attn_pairs(S, c.get("sliding_window")) * head_dim(c) \
        * c["num_attention_heads"] * c["num_hidden_layers"] * B
    return per * 3 if backward else per
