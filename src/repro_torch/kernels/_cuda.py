"""What the hand-written kernels of :mod:`repro_torch.kernels` share.

Each kernel is one CUDA C++ file ``csrc/kernels/<name>.cu`` (the ones on
Hopper's tensor cores over the shared header ``csrc/kernels/sm90.cuh``)
with an ``extern "C"`` launcher that returns ``cudaGetLastError()``.  The
library is built by ``nvcc`` for ``sm_90a`` at first use
(:func:`~repro_torch.core.backends.nvcc_build.kernel_job`, hash-named in
``build/repro_torch/``) and loaded with ``ctypes``.  A wrapper takes the
route from its tensors' device: CPU tensors go through the plain PyTorch
version, CUDA tensors launch the kernel or raise — nothing falls back.
On the card a wrapper first takes its tensors as the kernels take them
(:func:`prepare`): contiguous, and of one type the kernel computes in.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from ..core.backends import nvcc_build

#: every kernel package, by the name of its ``.cu`` file
KERNELS = ("flash_attention", "moe_gmm", "rglru_scan", "mlstm_chunk")
#: every ``.cu`` file of the package: the packages' kernels and the bf16
#: flash attention and grouped matmul kernels for Hopper's tensor cores
SOURCES = KERNELS + ("flash_attention_sm90", "moe_gmm_sm90")
#: the element-type code the launchers take
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
FLOATS = tuple(DTYPE_CODE)

P, I, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

_FNS: Dict[str, object] = {}


def _launcher(name: str, argtypes: Sequence) -> object:
    """``launch_<name>`` of kernel ``name``'s library, built and loaded at
    the first call; its last argument is the stream."""
    fn = _FNS.get(name)
    if fn is None:
        path = nvcc_build.build([nvcc_build.kernel_job(name)])["paths"][0]
        fn = getattr(ctypes.CDLL(str(path)), f"launch_{name}")
        fn.argtypes = [*argtypes, P]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def launch(name: str, argtypes: Sequence, device: torch.device,
           *args) -> None:
    """Launch kernel ``name`` with ``args`` on ``device``'s current
    PyTorch stream; raise if the launch was refused or failed."""
    fn = _launcher(name, argtypes)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError {err}")


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device, False when all lie
    on the CPU (the plain version's route); raises for anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError("tensors on several devices: "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"tensors on {dev}: the kernels take CUDA tensors "
                         "and the plain versions CPU tensors")
    return dev.type == "cuda"


def prepare(operands: Sequence[torch.Tensor],
            f32: Sequence[torch.Tensor] = (),
            i32: Sequence[torch.Tensor] = ()) -> Tuple[list, list, list]:
    """The tensors of a call as the kernels take them: ``(operands, f32,
    i32)``, each tensor contiguous (a non-contiguous one is copied).

    ``operands`` (floating tensors) keep their type when they share one
    the kernels compute in (:data:`FLOATS`); otherwise — another floating
    type such as float16, or mixed types — each is taken in float32, as
    the Pallas bodies take every operand (``.astype(jnp.float32)``), and
    the wrapper casts its result back to the first operand's type, as they
    cast on the store (``.astype(o_ref.dtype)``).  ``f32`` tensors (gates,
    initial states) are taken in float32 and ``i32`` ones (counts) in
    int32, whatever their type."""
    for t in operands:
        if not t.is_floating_point():
            raise ValueError(f"got a {t.dtype} operand: the kernels take "
                             "floating-point tensors")
    types = {t.dtype for t in operands}
    work = operands[0].dtype if len(types) == 1 and types <= set(FLOATS) \
        else torch.float32
    return ([t.to(work).contiguous() for t in operands],
            [t.float().contiguous() for t in f32],
            [t.to(torch.int32).contiguous() for t in i32])


def require(t: torch.Tensor, what: str, dtypes: Sequence[torch.dtype],
            shape: Tuple[int, ...]) -> None:
    """Refuse a tensor the kernel does not take: wrong type, shape, an
    empty dimension, or not contiguous (after :func:`prepare`, only a
    wrong shape or an empty dimension)."""
    if t.dtype not in dtypes or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or 0 in shape:
        raise ValueError(
            f"{what}: got {t.dtype}{tuple(t.shape)}"
            f"{'' if t.is_contiguous() else ' non-contiguous'}; the kernel "
            f"takes a contiguous, non-empty {'/'.join(map(str, dtypes))}"
            f"{tuple(shape)}")
