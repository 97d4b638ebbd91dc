"""The model stack: layers, the model (training forward, prefill and
decode), parameter counts and the JAX-tree converters (decoder-only,
recurrent and encoder–decoder families)."""
from .convert import params_from_jax, params_to_jax
from .model import Model
from .registry import WHISPER_CROSS_LEN, active_param_count, param_count

__all__ = ["Model", "params_from_jax", "params_to_jax", "param_count",
           "active_param_count", "WHISPER_CROSS_LEN"]
