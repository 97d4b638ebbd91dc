"""Build helper for CUDA sources: ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``.

Two kinds of source build here, each a job of :func:`build`:

* the segment kernels the CUDA backend generates from hetIR, over the
  device-runtime header ``csrc/hetir_rt.cuh`` (:func:`segment_job`), with
  hetIR's one-rounding-per-op flags (:data:`NVCC_FLAGS`);
* the hand-written kernels of :mod:`repro_torch.kernels`, one fixed file
  ``csrc/kernels/<name>.cu`` each (:func:`kernel_job`), with
  :data:`KERNEL_NVCC_FLAGS`.

Every library lands in ``build/repro_torch/`` at the root of the checkout,
named by a hash of its source, the headers of ``csrc/`` it includes, the
compiler flags and the runtime tag — so a second process on the same
checkout (or a second launch of the same program) finds the library and
skips ``nvcc``.  One :func:`build` call runs one ``nvcc`` per missing
library, as many at once as there are CPU cores.

The hashed directory serves one checkout.  The translation cache's stores
(:mod:`~repro_torch.core.cache`) carry a segment library further: the CUDA
backend persists each one as a ``"cuda-module"`` entry (its bytes, its
hashed name and its launch metadata), so another node, a fleet worker or a
migration destination with an empty ``build/`` revives it —
:func:`install_library` writes it back under the same name — and runs no
``nvcc``; the cache counts those restores, and fleet-wide single-flight
makes one ``nvcc`` per module across the processes sharing a fabric.
"""
from __future__ import annotations

import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

from ..cache import runtime_tag

#: ``src/repro_torch/csrc``: the device runtime header ``hetir_rt.cuh`` and
#: the hand-written kernels with their shared header ``kernels/sm90.cuh``
CSRC = Path(__file__).resolve().parents[2] / "csrc"
#: ``<checkout>/build/repro_torch``
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"

#: Hopper, one IEEE rounding per op, no flush to zero, no fast math
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
              "-ftz=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC")
#: the hand-written kernels carry no one-rounding-per-op contract, so the
#: compiler may contract multiply-adds; still IEEE division and square
#: root, no flush to zero, no fast math; ``ptxas`` reports each kernel's
#: registers and spills (:func:`build`'s ``logs``)
KERNEL_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                     "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
                     "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v")
#: ``src/repro_torch/csrc/kernels``: one self-contained ``.cu`` per kernel
KERNEL_DIR = CSRC / "kernels"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA backend builds its segment "
                       "kernels with the CUDA toolkit's nvcc")


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def local_headers(source: str) -> List[Path]:
    """The headers of ``csrc/`` that ``source`` includes with ``#include
    "..."``, directly or through one another, in first-include order."""
    found: List[Path] = []
    todo = [source]
    while todo:
        for name in _INCLUDE.findall(todo.pop()):
            path = CSRC / name
            if path.is_file() and path not in found:
                found.append(path)
                todo.append(path.read_text())
    return found


def library_path(source: str, flags: Sequence[str] = NVCC_FLAGS,
                 prefix: str = "het") -> Path:
    """Where the library built from ``source`` with ``flags`` lives (built
    or not): ``<prefix>_<hash>.so``, the hash over the source, every header
    of ``csrc/`` it includes, the flags and the runtime tag (torch and CUDA
    versions, device capability)."""
    h = hashlib.sha256()
    h.update(runtime_tag().encode())
    h.update(b"\0")
    h.update(source.encode())
    for path in local_headers(source):
        h.update(b"\0")
        h.update(path.read_bytes())
    h.update(b"\0")
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{prefix}_{h.hexdigest()[:24]}.so"


def segment_job(source: str) -> Tuple[str, Path, Sequence[str]]:
    """The :func:`build` job of a generated segment source."""
    return source, library_path(source), NVCC_FLAGS


def kernel_job(name: str) -> Tuple[str, Path, Sequence[str]]:
    """The :func:`build` job of the hand-written kernel
    ``csrc/kernels/<name>.cu``."""
    source = (KERNEL_DIR / f"{name}.cu").read_text()
    return (source, library_path(source, KERNEL_NVCC_FLAGS, name),
            KERNEL_NVCC_FLAGS)


def _start(source: str, so: Path, flags: Sequence[str]) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = so.with_suffix(".cu")
    cu.write_text(source)
    fd, tmp = tempfile.mkstemp(dir=str(BUILD_DIR), suffix=".so.tmp")
    os.close(fd)
    cmd = [nvcc_path(), *flags, "-I", str(CSRC), "-o", tmp, str(cu)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.het_tmp = tmp       # type: ignore[attr-defined]
    proc.het_so = so         # type: ignore[attr-defined]
    return proc


def _finish(proc: subprocess.Popen) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        try:
            os.unlink(proc.het_tmp)
        except OSError:
            pass
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for "
                           f"{proc.het_so.with_suffix('.cu')}:\n{out}")
    os.replace(proc.het_tmp, proc.het_so)   # atomic publish
    return out


def build(jobs_in: Sequence[tuple]) -> Dict[str, object]:
    """Run ``nvcc`` for every job ``(source, library path, flags)`` whose
    library is missing, one process per CPU core at a time.  Returns
    ``{"paths": [...], "built": n, "seconds": wall time, "logs": {path:
    compiler output}}``, a path per job and a log per library built;
    raises on the first failed build."""
    t0 = time.perf_counter()
    paths: List[Path] = [so for _, so, _ in jobs_in]
    todo = []
    seen = set()
    for src, so, flags in jobs_in:
        if not so.exists() and so not in seen:
            seen.add(so)
            todo.append((src, so, flags))
    jobs = os.cpu_count() or 1
    running: List[subprocess.Popen] = []
    logs: Dict[Path, str] = {}

    def finish() -> None:
        proc = running.pop(0)
        logs[proc.het_so] = _finish(proc)

    try:
        for src, so, flags in todo:
            if len(running) >= jobs:
                finish()
            running.append(_start(src, so, flags))
        while running:
            finish()
    finally:
        for proc in running:         # a failed build stops the others
            proc.kill()
            proc.wait()
    return {"paths": paths, "built": len(todo),
            "seconds": time.perf_counter() - t0, "logs": logs}


def codegen_sources() -> List[Path]:
    """What a generated segment library depends on besides its program and
    lane count: every module of :mod:`repro_torch.core` (the emitter and
    all it calls — passes, alias forms, liveness, staging, segmentation,
    the op semantics; ``core`` imports nothing outside itself) and the
    device runtime header."""
    core = Path(__file__).resolve().parents[1]
    return sorted(core.rglob("*.py")) + [CSRC / "hetir_rt.cuh"]


def digest_sources(paths: Sequence[Path], root: Path) -> str:
    """Hash of the flags and of ``paths`` (their names under ``root`` and
    their bytes)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in paths:
        h.update(b"\0" + str(path.relative_to(root)).encode() + b"\0")
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def codegen_tag() -> str:
    """Hash of :func:`codegen_sources` and the flags — part of every
    persisted module's cache key, so a store written by another version of
    the translator is a miss and never revives a library (or launch
    metadata) that this one would not emit."""
    return digest_sources(codegen_sources(), CSRC.parent)


def install_library(name: str, data: bytes) -> Tuple[Path, bool]:
    """Put a library revived from a store into :data:`BUILD_DIR` under its
    content-addressed ``name``, unless a file of that name is there
    already: written to a temp file and published by ``os.replace``, so a
    library a process has loaded is never rewritten in place.  Returns the
    path and whether it was written."""
    if Path(name).name != name or not name.endswith(".so"):
        raise ValueError(f"not a library file name: {name!r}")
    path = BUILD_DIR / name
    if path.exists():
        return path, False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=str(BUILD_DIR), suffix=".so.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path, True
