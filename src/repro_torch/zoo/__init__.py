"""Model zoo: real attention/MoE/recurrent kernels as hetIR modules.

Importing this package registers the four zoo kernels under the
``"zoo"`` namespace of :mod:`repro_torch.core.kernels_suite`, making them
reachable through ``example_launch``/``lookup``/``registered_examples``
exactly like the built-in suite.
"""
from .kernels import (  # noqa: F401
    ZOO,
    ZOO_EXAMPLES,
    ATTN_D,
    ATTN_T,
    MOE_E,
    MOE_F,
    RGLRU_T,
    MLSTM_D,
    attn_decode,
    moe_route_gmm,
    rglru_step,
    mlstm_cell,
)

__all__ = [
    "ZOO", "ZOO_EXAMPLES", "ATTN_D", "ATTN_T", "MOE_E", "MOE_F",
    "RGLRU_T", "MLSTM_D", "attn_decode", "moe_route_gmm", "rglru_step",
    "mlstm_cell",
]
