"""The MoE decoder: pre-norm causal GQA attention and a pre-norm top-k
mixture of SwiGLU experts (granite-moe-3b-a800m: 8 of 40).

Routing, within each batch row: the router's ``E`` logits of a token, its
``k`` highest (ties to the lower expert), gates the softmax over those
``k``.  An expert keeps at most ``C = ceil(capacity_factor * S * k / E)``
(at least 1, at most ``S * k``) of the entries routed to it, in the order
of token then rank; the others are dropped.  A token's output is the sum
of its kept entries' gates times their experts' outputs.  The layer's
load-balancing loss is ``E * sum_e (share of the top-k entries routed to
e) * (mean router probability of e)``, over the whole batch.
"""
from __future__ import annotations

import math

import torch

from .layout import (attention_weights, decoder_groups, inv_sqrt,
                     swiglu_groups)
from .ops import mm, rms_norm, self_attention, swiglu


def groups(c) -> list:
    """The weights' groups (:mod:`.layout`): the router ``[D, E]`` and
    every expert's SwiGLU matrices ``[E, ...]``."""
    D, E, L = c["hidden_size"], c["num_local_experts"], \
        c["num_hidden_layers"]
    return decoder_groups(c) + [
        ("blocks.{}.ffn.router", L, (D, E), inv_sqrt(D))] \
        + swiglu_groups(c, E)


def active_weights(c) -> int:
    """One layer's weights that one token passes through: attention, the
    router and ``num_experts_per_tok`` experts."""
    D, F = c["hidden_size"], c["intermediate_size"]
    return attention_weights(c) + D * c["num_local_experts"] \
        + c["num_experts_per_tok"] * 3 * D * F


def _top_k(logits, k: int):
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(h, p, c, prec: str):
    """The experts' sum on the normed input ``h [B, S, D]``; returns
    ``(y, router logits [B, S, E])``."""
    B, S, D = h.shape
    E, K = c.experts, c.top_k
    C = max(1, min(math.ceil(S * K / E * c.capacity_factor), S * K))
    logits = mm(h, p["ffn.router"], prec)
    rows = []
    for b in range(B):
        vals, idx = _top_k(logits[b], K)
        gates = torch.softmax(vals, dim=-1).reshape(-1)        # [S*K]
        flat = idx.reshape(-1)
        order = torch.sort(flat, stable=True).indices           # by expert
        routed = torch.bincount(flat, minlength=E)
        start = torch.cumsum(routed, 0) - routed
        rank = torch.arange(S * K, device=h.device) - start[flat[order]]
        kept = order[rank < C]
        y = torch.zeros_like(h[b])
        for e, entries in enumerate(torch.split(
                kept, routed.clamp(max=C).tolist())):
            if entries.numel() == 0:
                continue
            tok = entries // K
            out = swiglu(h[b, tok], p["ffn.wg"][e], p["ffn.wu"][e],
                         p["ffn.wd"][e], prec)
            y = y.index_add(0, tok, out * gates[entries, None])
        rows.append(y)
    return torch.stack(rows), logits


def aux_loss(logits, K: int):
    """The load-balancing loss of router logits ``[B, S, E]``."""
    E = logits.shape[-1]
    flat = logits.reshape(-1, E)
    _, idx = _top_k(flat, K)
    share = torch.bincount(idx.reshape(-1), minlength=E).float() \
        / (flat.shape[0] * K)
    return E * torch.sum(share * torch.softmax(flat, dim=-1).mean(0))


def block(x, p, c, prec: str):
    """One layer on ``x [B, S, D]`` (float32); returns ``(x, the layer's
    load-balancing loss)``."""
    x = x + self_attention(rms_norm(x, p["norm1.scale"], c.eps), p, c, prec)
    y, logits = moe_ffn(rms_norm(x, p["norm2.scale"], c.eps), p, c, prec)
    return x + y, aux_loss(logits, c.top_k)
