"""The model stack's serving path: layers, the model, parameter counts and
the JAX-tree converter (decoder-only, recurrent and encoder–decoder
families)."""
from .convert import params_from_jax
from .model import Model
from .registry import WHISPER_CROSS_LEN, active_param_count, param_count

__all__ = ["Model", "params_from_jax", "param_count", "active_param_count",
           "WHISPER_CROSS_LEN"]
