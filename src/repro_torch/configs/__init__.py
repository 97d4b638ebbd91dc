"""Architecture registry: one module per assigned architecture (the port's
own copy of the JAX package's ``configs``, equal config for config)."""
from typing import Callable, Dict

from .base import (ATTN, CROSS_ATTN, DENSE_FFN, MLSTM, MOE_FFN, NO_FFN,
                   RGLRU, SHAPES, SLSTM, SWA, BlockSpec, ModelConfig, MoECfg,
                   ParallelCfg, ShapeCfg, default_parallel, shape_applicable)

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}
_SMOKE_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def register_smoke(name: str):
    def deco(fn):
        _SMOKE_REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    return _REGISTRY[name]()


def get_smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    _ensure_loaded()
    return _SMOKE_REGISTRY[name]()


# best-known §Perf switches (semantics-preserving; see EXPERIMENTS.md):
# chunked mLSTM, group-local MoE dispatch, flash-recompute attention VJP
OPTIMIZED_PROFILE = {
    "mlstm_impl": "chunked",
    "moe_impl": "grouped",
    "attn_vjp": "flash",
}


def get_optimized_config(name: str) -> ModelConfig:
    """The production profile: baseline config + §Perf switches."""
    import dataclasses
    return dataclasses.replace(get_config(name), **OPTIMIZED_PROFILE)


def get_optimized_smoke_config(name: str) -> ModelConfig:
    import dataclasses
    return dataclasses.replace(get_smoke_config(name),
                               **OPTIMIZED_PROFILE)


def list_archs():
    _ensure_loaded()
    return sorted(_REGISTRY)


_LOADED = False


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    from . import (glm4_9b, granite_moe_3b_a800m, h2o_danube_3_4b,  # noqa
                   internvl2_2b, llama3_2_3b, llama3_405b, mixtral_8x22b,
                   recurrentgemma_2b, whisper_large_v3, xlstm_125m)
    _LOADED = True
