"""Hand-written CUDA kernels for Hopper, the port of ``src/repro/kernels``:
flash attention (prefill), the RG-LRU scan, chunked gated linear attention
(the mLSTM core), the grouped expert matmul (MoE), and hetIR-generated
kernels (the paper's compiler feeding the kernel layer).

Each kernel package holds ``kernel.py`` (the wrapper ``<name>_fwd`` with
its launch count, and the plain PyTorch version ``<name>_plain``),
``ops.py`` (a ``torch.autograd.Function`` whose backward recomputes
through the oracle) and ``ref.py`` (the pure-torch oracle); the CUDA C++
sources are ``csrc/kernels/<name>.cu``.
"""
from .flash_attention import flash_attention
from .mlstm_chunk import mlstm_chunk
from .moe_gmm import moe_gmm
from .rglru_scan import rglru_scan

__all__ = ["flash_attention", "mlstm_chunk", "moe_gmm", "rglru_scan"]
