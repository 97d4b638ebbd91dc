"""Backend interface: a backend executes one *segment* at a time.

Between segments all state lives in :class:`HostState` as torch tensors on
the session's device — the paper's design where segment kernels
communicate registers and shared memory "via memory".  Snapshots move the
state to host numpy (:meth:`~repro_torch.core.engine.Engine.snapshot`), which
is what keeps them backend- and package-neutral.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import hetir as ir
from ..cache import TranslationCache, global_cache
from ..segments import SegNode

#: hetIR dtype code -> torch dtype of the tensors that hold it
TORCH_DTYPES = {
    ir.F32: torch.float32,
    ir.I32: torch.int32,
    ir.U32: torch.uint32,
    ir.BOOL: torch.bool,
}


def torch_dtype(t: str) -> torch.dtype:
    return TORCH_DTYPES[t]


def to_tensor(value, dtype: str, device: torch.device) -> torch.Tensor:
    """A fresh tensor holding ``value`` (tensor, array or scalar) as hetIR
    dtype ``dtype`` on ``device``.  NumPy does the conversion for host
    values, so the casting rules are the interpreter's."""
    if isinstance(value, torch.Tensor):
        if value.dtype != torch_dtype(dtype):
            value = torch.from_numpy(
                value.detach().cpu().numpy().astype(ir.np_dtype(dtype)))
        return value.detach().to(device=device, copy=True)
    arr = np.array(value, dtype=ir.np_dtype(dtype), copy=True)
    return torch.from_numpy(arr).to(device)


def to_numpy(value) -> np.ndarray:
    """A host numpy copy of a tensor (or array-like)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy().copy()
    return np.array(value, copy=True)


def resolve_device(device=None) -> torch.device:
    """A session's or backend's device: ``cuda:0`` by default — which needs
    a GPU — or whatever the caller names (``"cpu"`` runs the plain
    versions)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on cuda:0 unless the caller "
            "passes device='cpu'")
    return torch.device("cuda", 0)


@dataclass
class Launch:
    program: ir.Program
    num_blocks: int
    block_size: int
    scalars: Dict[str, object] = field(default_factory=dict)
    opt_level: int = 0  # pass-pipeline level the body was optimized at
    # launch-time specialization key: the (name, value) uniform scalars
    # bound into the optimized body, () for the generic variant.  Part of
    # every translation-cache key
    spec_key: Tuple = ()
    # buffer name -> shape tuple for every global buffer bound at launch;
    # feeds the specialization policy and the block lowering's proof
    buffer_shapes: Dict[str, Tuple[int, ...]] = field(default_factory=dict)
    # stream-scheduler metadata, set by the session.  Diagnostic only —
    # never part of a translation-cache key
    stream_id: Optional[int] = None
    launch_seq: Optional[int] = None


@dataclass
class HostState:
    regs: Dict[str, torch.Tensor]            # [num_blocks, block_size]
    shared: Optional[torch.Tensor]           # [num_blocks, shared_size]
    globals_: Dict[str, torch.Tensor]        # 1-D buffers


class Backend:
    name = "abstract"

    def __init__(self, cache: Optional[TranslationCache] = None,
                 device: Optional[torch.device] = None):
        # all backends share one translation cache (paper §4.2: "the runtime
        # caches these translated kernels") unless handed a private one
        self.cache = cache if cache is not None else global_cache()
        self.device = resolve_device(device)

    def run_segment(self, seg: SegNode, state: HostState,
                    launch: Launch) -> None:
        raise NotImplementedError

    def _cache_key(self, seg: SegNode, launch: Launch,
                   *extra) -> Tuple:
        """Content-addressed translation key: backend, program fingerprint,
        opt level, segment index, the launch-time specialization's
        bound-scalar vector (() = generic), plus backend-specific
        specialization."""
        return (self.name, ir.program_fingerprint(launch.program),
                launch.opt_level, seg.index,
                tuple(launch.spec_key)) + tuple(extra)

    def translation_cache_size(self) -> int:
        return self.cache.size(self.name)

    def cache_stats(self) -> Dict[str, object]:
        return self.cache.stats()


def state_signature(state: HostState) -> Tuple[Tuple, Tuple, Optional[Tuple]]:
    """(reg, global, shared) shape+dtype signatures of the incoming state."""
    reg_sig = tuple((n, tuple(state.regs[n].shape), str(state.regs[n].dtype))
                    for n in sorted(state.regs))
    glb_sig = tuple((n, tuple(state.globals_[n].shape),
                     str(state.globals_[n].dtype))
                    for n in sorted(state.globals_))
    shared_sig = None if state.shared is None else \
        (tuple(state.shared.shape), str(state.shared.dtype))
    return reg_sig, glb_sig, shared_sig
