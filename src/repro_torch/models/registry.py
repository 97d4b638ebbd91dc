"""Registry utilities: exact parameter counts and abstract inputs per
(architecture x shape) cell.  Port of ``src/repro/models/registry.py``.

Everything abstract is a tensor on the ``meta`` device (a shape and a
type, nothing allocated): :func:`abstract_params` is the ``meta``
:class:`~repro_torch.models.model.Model`'s parameters in the JAX
package's tree (:func:`~repro_torch.models.convert.params_to_jax`), the
input specs are the reference's shapes and types, and
:func:`make_concrete` draws the reference's values for any spec tree of
the reference's structure.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeCfg
from .convert import params_to_jax
from .model import Model

#: the encoder's length that an encoder–decoder model serves: whisper's
#: receptive field, 30 s of audio (the port's copy of the JAX registry's)
WHISPER_CROSS_LEN = 1500


def abstract_params(cfg: ModelConfig):
    """The parameter tree of ``Model(cfg)`` in the JAX package's layout,
    its leaves ``meta`` tensors."""
    return params_to_jax(Model(cfg, device="meta").state_dict(), cfg)


def param_count(cfg: ModelConfig) -> int:
    """Exact parameter count of ``Model(cfg)`` (an encoder's included)."""
    model = Model(cfg, device="meta")
    return sum(p.numel() for p in model.parameters())


def active_param_count(cfg: ModelConfig) -> int:
    """Params touched per token: MoE counts top_k of n_experts experts."""
    total = param_count(cfg)
    if cfg.moe is None:
        return total
    m = cfg.moe
    n_mats = 3 if cfg.act == "swiglu" else 2
    per_expert = n_mats * cfg.d_model * m.d_ff_expert
    n_moe_layers = sum(1 for s in cfg.blocks() if s.ffn == "moe")
    return total - (m.n_experts - m.top_k) * per_expert * n_moe_layers


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ModelConfig, shape: ShapeCfg
                      ) -> Dict[str, torch.Tensor]:
    """Abstract batch for train/prefill-style full-sequence forward."""
    B, S = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.compute_dtype)
    if cfg.encoder_decoder:
        # audio stub: precomputed frame embeddings; decoder gets text tokens
        return {"enc_embeds": _meta((B, S, cfg.d_model), dt),
                "tokens": _meta((B, S), torch.int32)}
    if cfg.frontend == "patch":
        F = cfg.frontend_tokens
        return {"embeds": _meta((B, F, cfg.d_model), dt),
                "tokens": _meta((B, S - F), torch.int32)}
    return {"tokens": _meta((B, S), torch.int32)}


def decode_input_specs(cfg: ModelConfig, shape: ShapeCfg
                       ) -> Tuple[Any, Any, Any]:
    """(tokens, caches, pos) for one decode step with a cache of
    ``shape.seq_len`` tokens: the caches are the port's, one dict per
    layer (``Model.init_caches``; the reference stacks each group's)."""
    B, S = shape.global_batch, shape.seq_len
    enc_len = WHISPER_CROSS_LEN if cfg.encoder_decoder else 0
    caches = Model(cfg, device="meta").init_caches(B, S, enc_len)
    return _meta((B, 1), torch.int32), caches, _meta((), torch.int32)


def make_concrete(spec_tree, seed: int = 0):
    """Instantiate a spec tree with deterministic synthetic data on the
    CPU: the reference's draws from ``np.random.default_rng(seed)``
    (integers in ``[0, 255)``, else ``normal * 0.02``), leaf by leaf in its
    order (``jax.tree.map`` visits dict keys sorted, lists and tuples in
    order), each cast to the leaf's type from float64 (bf16 rounds as the
    reference's does)."""
    rng = np.random.default_rng(seed)

    def one(s):
        if not s.dtype.is_floating_point:
            return torch.from_numpy(np.asarray(
                rng.integers(0, 255, size=tuple(s.shape)))).to(s.dtype)
        return torch.from_numpy(np.asarray(
            rng.normal(size=tuple(s.shape)) * 0.02)).to(s.dtype)

    def walk(node):
        if isinstance(node, dict):
            out = {k: walk(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return one(node)

    return walk(spec_tree)
