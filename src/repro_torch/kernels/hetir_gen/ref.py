"""Oracle for hetIR-generated kernels: the scalar interpreter backend."""
from __future__ import annotations

from typing import Dict

import numpy as np

from ...core import Engine, get_backend
from ...core import hetir as ir


def het_kernel_ref(program: ir.Program, grid: int, block: int):
    backend = get_backend("interp", device="cpu")

    def run(**args) -> Dict[str, np.ndarray]:
        eng = Engine(program, backend, grid, block, dict(args))
        if not eng.run():
            raise RuntimeError(f"{program.name}: launch did not finish")
        return {p.name: eng.result(p.name) for p in program.buffers()}

    return run
