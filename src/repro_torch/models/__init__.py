"""The model stack's serving path: layers, the model, parameter counts and
the JAX-tree converter (decoder-only attention families)."""
from .convert import params_from_jax
from .model import Model
from .registry import active_param_count, param_count

__all__ = ["Model", "params_from_jax", "param_count", "active_param_count"]
