"""Exact parameter counts of the port's models, from the parameters a
:class:`~repro_torch.models.model.Model` holds when built on the ``meta``
device (nothing is allocated).  Port of ``param_count`` and
``active_param_count`` of ``src/repro/models/registry.py``; the abstract
input specs there (``train_input_specs``, ``decode_input_specs``,
``make_concrete``) come with ``launch/dryrun`` (ROADMAP.md)."""
from __future__ import annotations

from ..configs.base import ModelConfig
from .model import Model

#: the encoder's length that an encoder–decoder model serves: whisper's
#: receptive field, 30 s of audio (the port's copy of the JAX registry's)
WHISPER_CROSS_LEN = 1500


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
