"""hetGPU backends — the runtime's per-target code-generation modules.

* :mod:`interp`       — scalar per-thread interpreter on the host (MIMD
  independent-thread mode; the correctness oracle);
* :mod:`vectorized`   — masked lane-vector execution in eager PyTorch on
  the session's device (the plain version of the CUDA kernels);
* :mod:`cuda_backend` — translates each segment to CUDA C++ kernels for
  Hopper (the SIMT-hardware target; "each segment is a separate kernel").
"""
from ..cache import TranslationCache
from .cuda_backend import CudaBackend
from .interp import InterpBackend
from .vectorized import VectorizedBackend

BACKENDS = {
    "interp": InterpBackend,
    "vectorized": VectorizedBackend,
    "cuda": CudaBackend,
}


def get_backend(name: str, cache: TranslationCache = None, device=None):
    """Instantiate a backend on ``device`` (default ``cuda:0``, which needs
    a GPU; pass ``"cpu"`` for the plain versions); ``cache``
    overrides the process-wide shared translation cache (tests pass a
    fresh one for counter isolation)."""
    return BACKENDS[name](cache=cache, device=device)
