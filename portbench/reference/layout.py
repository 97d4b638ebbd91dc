"""The weights of a decoder-only family, by the port's parameter names:
groups of like weights (one matrix kind over every layer, the embedding,
the head), each drawn as one tensor (:mod:`portbench.weights`), and the
weights one token passes through (:mod:`portbench.counts`)."""
from __future__ import annotations

import math

#: the scale of the norms' scales (applied as ``1 + scale``)
NORM_SCALE = 0.1


def padded_vocab(c) -> int:
    pad = c.get("vocab_pad", 1)
    return -(-c["vocab_size"] // pad) * pad


def head_dim(c) -> int:
    return c.get("head_dim") or c["hidden_size"] // c["num_attention_heads"]


def inv_sqrt(n: int) -> float:
    return 1.0 / math.sqrt(n)


def decoder_groups(c) -> list:
    """``(name, layers, shape, scale)`` of the embedding, the head, the
    norms and the attention projections: weights ``N(0, 1 / fan_in)``,
    norm scales ``NORM_SCALE * N(0, 1)``.  A group of ``layers`` (not
    None) is one tensor ``[layers, *shape]`` whose slice ``i`` is the
    parameter ``name.format(i)``."""
    D, H, KV = (c["hidden_size"], c["num_attention_heads"],
                c["num_key_value_heads"])
    hd, Vp, L = head_dim(c), padded_vocab(c), c["num_hidden_layers"]
    out = [("embed", None, (Vp, D), inv_sqrt(D))]
    if not c.get("tie_word_embeddings"):
        out.append(("lm_head", None, (D, Vp), inv_sqrt(D)))
    return out + [("final_norm.scale", None, (D,), NORM_SCALE),
                  ("blocks.{}.norm1.scale", L, (D,), NORM_SCALE),
                  ("blocks.{}.mixer.wq", L, (D, H * hd), inv_sqrt(D)),
                  ("blocks.{}.mixer.wk", L, (D, KV * hd), inv_sqrt(D)),
                  ("blocks.{}.mixer.wv", L, (D, KV * hd), inv_sqrt(D)),
                  ("blocks.{}.mixer.wo", L, (H * hd, D), inv_sqrt(H * hd)),
                  ("blocks.{}.norm2.scale", L, (D,), NORM_SCALE)]


def swiglu_groups(c, experts: int = 0) -> list:
    """The SwiGLU FFN's three matrices of every layer, ``[experts, ...]``
    where given."""
    D, F = c["hidden_size"], c["intermediate_size"]
    L = c["num_hidden_layers"]
    lead = (experts,) if experts else ()
    return [("blocks.{}.ffn.wg", L, (*lead, D, F), inv_sqrt(D)),
            ("blocks.{}.ffn.wu", L, (*lead, D, F), inv_sqrt(D)),
            ("blocks.{}.ffn.wd", L, (*lead, F, D), inv_sqrt(F))]


def attention_weights(c) -> int:
    """One layer's q, k, v and output projections."""
    D, H, KV, hd = (c["hidden_size"], c["num_attention_heads"],
                    c["num_key_value_heads"], head_dim(c))
    return D * H * hd + 2 * D * KV * hd + H * hd * D
