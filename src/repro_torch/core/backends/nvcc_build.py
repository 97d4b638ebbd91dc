"""Build helper for generated CUDA sources: ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.

Every library lands in ``build/repro_torch/`` at the root of the checkout,
named by a hash of the generated source, the device-runtime header, the
compiler flags and the runtime tag — so a second process (or a second launch of the same
program) finds the library and skips ``nvcc``.  Several sources build
concurrently through :func:`build_many`, one ``nvcc`` process each.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Sequence

from ..cache import runtime_tag

#: ``src/repro_torch/csrc``: the hand-written device runtime header
CSRC = Path(__file__).resolve().parents[2] / "csrc"
HEADER = CSRC / "hetir_rt.cuh"
#: ``<checkout>/build/repro_torch``
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"

#: Hopper, one IEEE rounding per op, no flush to zero, no fast math
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
              "-ftz=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA backend builds its segment "
                       "kernels with the CUDA toolkit's nvcc")


def library_path(source: str) -> Path:
    """Where the library built from ``source`` lives (built or not): the
    name hashes the source, the header, the flags and the runtime tag
    (torch and CUDA versions, device capability)."""
    h = hashlib.sha256()
    h.update(runtime_tag().encode())
    h.update(b"\0")
    h.update(source.encode())
    h.update(b"\0")
    h.update(HEADER.read_bytes())
    h.update(b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"het_{h.hexdigest()[:24]}.so"


def _start(source: str, so: Path) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = so.with_suffix(".cu")
    cu.write_text(source)
    fd, tmp = tempfile.mkstemp(dir=str(BUILD_DIR), suffix=".so.tmp")
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(cu)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.het_tmp = tmp       # type: ignore[attr-defined]
    proc.het_so = so         # type: ignore[attr-defined]
    return proc


def _finish(proc: subprocess.Popen) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        try:
            os.unlink(proc.het_tmp)
        except OSError:
            pass
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for "
                           f"{proc.het_so.with_suffix('.cu')}:\n{out}")
    os.replace(proc.het_tmp, proc.het_so)   # atomic publish


def build_many(sources: Sequence[str]) -> Dict[str, object]:
    """Build every source not built yet, one ``nvcc`` process per CPU core
    at a time.  Returns ``{"paths": [...], "built": n,
    "seconds": wall time}``; raises on the first failed build."""
    t0 = time.perf_counter()
    paths: List[Path] = [library_path(s) for s in sources]
    todo = []
    seen = set()
    for src, so in zip(sources, paths):
        if not so.exists() and so not in seen:
            seen.add(so)
            todo.append((src, so))
    jobs = os.cpu_count() or 1
    running: List[subprocess.Popen] = []
    try:
        for src, so in todo:
            if len(running) >= jobs:
                _finish(running.pop(0))
            running.append(_start(src, so))
        while running:
            _finish(running.pop(0))
    finally:
        for proc in running:         # a failed build stops the others
            proc.kill()
            proc.wait()
    return {"paths": paths, "built": len(todo),
            "seconds": time.perf_counter() - t0}

