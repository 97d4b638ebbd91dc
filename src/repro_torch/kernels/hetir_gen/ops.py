"""hetIR-generated kernels — the paper's compiler feeding ``kernels/``.

``het_kernel(program, grid, block)`` runs a hetIR "binary" through the
CUDA backend (one CUDA C++ kernel per barrier segment, see
:mod:`repro_torch.core.backends.cuda_backend`) and returns a callable with
numpy-array semantics.  The same portable binary that runs on the
interpreter and the eager backend lowers to kernels for the card here.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ...core import Engine, get_backend
from ...core import hetir as ir


def het_kernel(program: ir.Program, grid: int, block: int, device=None):
    """Returns fn(**args) -> dict of output buffers (numpy), executed on
    the CUDA backend on ``device`` (default ``cuda:0``, which needs a GPU;
    ``"cpu"`` runs the plain version of the segment kernels).  The
    backend, with its launch counts, is ``fn.backend``."""
    backend = get_backend("cuda", device=device)

    def run(**args) -> Dict[str, np.ndarray]:
        eng = Engine(program, backend, grid, block, dict(args))
        if not eng.run():
            raise RuntimeError(f"{program.name}: launch did not finish")
        return {p.name: eng.result(p.name) for p in program.buffers()}

    run.backend = backend    # its segment-kernel launch counts
    return run
