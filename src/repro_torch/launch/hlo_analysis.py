"""Per-device FLOPs, bytes and collective traffic of a step, counted over
the ATen ops that it dispatches.

Port of ``src/repro/launch/hlo_analysis.py``.  The port emits no HLO, so
there is no HLO text to parse: this module counts the ops that PyTorch
dispatches while a function runs (:class:`OpCounter`, a
``TorchDispatchMode``) on one rank, and reports the reference's totals
under the reference's keys.  The name is kept so that a reader finds the
counterpart.

* **FLOPs**: ``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions and the
  attention ops count by ``torch.utils.flop_counter``'s formulas
  (``2·M·N·K`` for a product); every other op that does work counts
  ``numel(out)``, the reference's elementwise rule.  Views, aliases,
  ``detach``, ``empty*``, ``arange``, ``wait_tensor`` and the like are
  free (the counterpart of the reference's ``_FREE_OPS``).
* **Bytes**: the inputs plus the outputs of every op that is not free,
  each distinct tensor once per op.  Eager PyTorch fuses nothing, so this
  is an upper bound on the fused count that XLA reports for the same
  function (a fusion's internals move no bytes there).
* **Collectives**: the reference's per-device ring model, with ``n`` the
  size of the op's own process group::

    all-reduce         2·bytes(out)·(n-1)/n
    all-gather         bytes(out)·(n-1)/n
    reduce-scatter     bytes(out)·(n-1)
    all-to-all         bytes(out)·(n-1)/n
    collective-permute bytes(out)

  Both the functional collectives (``_c10d_functional.*``, which
  ``DTensor`` issues) and the in-place ``c10d.*_`` ops (which
  ``dist.all_gather`` and the like dispatch) are counted; a received
  point-to-point buffer (``dist.recv``, GPipe's ``batch_isend_irecv``)
  counts as a collective-permute.

Eager execution unrolls every loop, so the counts are weighted by trip
count by construction, which the reference's analyzer reconstructs from
``known_trip_count``.  An op on ``DTensor`` operands is counted by their
local blocks.  The counter also keeps the bytes of live tensor storages
on the rank, and their peak (:attr:`OpCounter.peak_bytes`): storages
made by the counted ops, and those handed to :meth:`OpCounter.track`
before (the state).  Nothing here needs a device: on ``meta`` tensors and
a fake process group it counts a rank of a mesh of any size.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Callable, Dict

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

#: ops that move no data and do no work, by name (views and aliases are
#: recognised from their schema)
FREE_OPS = {
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "arange", "detach", "lift_fresh", "alias",
    "wait_tensor", "_wrap_tensor_autograd", "_local_scalar_dense",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
    "is_same_size",
}

#: the kind of each collective op, by its qualified name: the functional
#: ops return their output, the in-place ops write their first operand
_FUNCTIONAL = {
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
}
_INPLACE = {
    "c10d.allreduce_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.recv_": "collective-permute",
    "c10d.recv_any_source_": "collective-permute",
}
#: point-to-point sends: their bytes are the peer's permute
_SENDS = {"c10d.send"}


def ring_bytes(kind: str, nbytes: float, n: int) -> float:
    """Per-device bytes a collective of ``kind`` moves in the ring model,
    for an output of ``nbytes`` over a group of ``n`` ranks."""
    if kind == "all-reduce":
        return 2 * nbytes * (n - 1) / max(n, 1)
    if kind in ("all-gather", "all-to-all"):
        return nbytes * (n - 1) / max(n, 1)
    if kind == "reduce-scatter":
        return nbytes * (n - 1)
    return nbytes


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(x):
    return x._local_tensor if isinstance(x, DTensor) else x


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _flat(items) -> list:
    """The tensors of an op's operands (a ``DTensor`` as its local
    block), in nested lists and tuples too."""
    out = []
    for a in items:
        if isinstance(a, torch.Tensor):
            out.append(_local(a))
        elif isinstance(a, (list, tuple)):
            out.extend(_flat(a))
    return out


def _io_bytes(ins, outs) -> int:
    """Bytes of an op's distinct input and output tensors."""
    seen, total = set(), 0
    for t in ins + outs:
        if id(t) not in seen:
            seen.add(id(t))
            total += _nbytes(t)
    return total


def _is_view(func) -> bool:
    """Whether ``func`` returns an alias of an input without writing it."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _group_size(func, args, kwargs, default: int) -> int:
    """Size of the process group a collective op runs on."""
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, str):
            try:
                return dist.distributed_c10d._resolve_process_group(a).size()
            except Exception:  # noqa: BLE001 - not a group name
                continue
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except RuntimeError:  # another class (a ReduceOp)
                continue
    return default


class OpCounter(TorchDispatchMode):
    """Counts the FLOPs, bytes and collective bytes of the ops dispatched
    on this rank while active, and the live storages' bytes.

    ``default_group`` is the group size taken for a collective whose own
    group cannot be resolved (the reference's ``default_group``)."""

    def __init__(self, default_group: int = 1):
        super().__init__()
        self.default_group = default_group
        self.flops = 0.0
        self.bytes = 0.0
        self.coll: Dict[str, float] = defaultdict(float)
        self.n_ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}
        self._infos: Dict[object, tuple] = {}

    # -- live storages -------------------------------------------------
    def track(self, tensors) -> None:
        """Count the storages of ``tensors`` (any tree; ``DTensor``s by
        their local blocks) as live from now until they are freed."""
        for t in _tensors(tree_map(_local, tensors)):
            self._hold(t)

    def _hold(self, t: torch.Tensor) -> None:
        try:
            s = t.untyped_storage()
        except (NotImplementedError, RuntimeError):
            return
        key = s._cdata
        if key in self._live:
            return
        n = s.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(s, self._release, key)

    def _release(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    # -- dispatch --------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _flat(args) + _flat(tuple(kwargs.values()))
        outs = _flat(out if isinstance(out, (list, tuple)) else (out,))
        self._count(func, args, kwargs, ins, outs, out)
        return out

    def _info(self, func):
        """(collective kind or None, free, qualified name) of ``func``."""
        info = self._infos.get(func)
        if info is None:
            qual = func._schema.name.replace("::", ".")
            name = qual.rsplit(".", 1)[-1]
            kind = _FUNCTIONAL.get(qual) or _INPLACE.get(qual)
            free = qual in _SENDS or name in FREE_OPS or _is_view(func)
            info = self._infos[func] = (kind, free, qual)
        return info

    def _count(self, func, args, kwargs, ins, outs, out) -> None:
        self.n_ops += 1
        for t in outs:
            self._hold(t)
        kind, free, qual = self._info(func)
        if kind is not None:
            n = _group_size(func, args, kwargs, self.default_group)
            # the functional ops return their output, the in-place ones
            # write their first operand
            moved_from = outs if qual in _FUNCTIONAL else _flat(args[:1])
            moved = ring_bytes(kind, sum(_nbytes(t) for t in moved_from), n)
            self.coll[kind] += moved
            self.coll["total"] += moved
            self.coll[f"count_{kind}"] += 1
            self.bytes += _io_bytes(ins, outs)
            return
        if free:
            return
        flop = flop_counter.flop_registry.get(func.overloadpacket)
        if flop is not None:
            if any(isinstance(t, DTensor) for t in ins):
                args, kwargs, out = (tree_map(_local, a)
                                     for a in (args, kwargs, out))
            self.flops += flop(*args, **kwargs, out_val=out)
        else:
            self.flops += sum(t.numel() for t in outs)
        self.bytes += _io_bytes(ins, outs)

    def result(self) -> Dict[str, object]:
        """The reference's ``{"flops", "bytes", "collectives"}``."""
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "collectives": dict(self.coll)}


def analyze(fn: Callable, *args, default_group: int = 1
            ) -> Dict[str, object]:
    """Run ``fn(*args)`` under an :class:`OpCounter` and return its
    per-device ``{"flops", "bytes", "collectives"}`` (the reference's
    ``analyze_hlo`` output)."""
    counter = OpCounter(default_group)
    with counter:
        fn(*args)
    return counter.result()
