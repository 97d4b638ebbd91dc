"""The hetGPU execution engine — segment walker + snapshot machinery
(paper §4.2 Dynamic Translation, §4.3 State Capture).

The engine is the piece of the paper's runtime that walks the *segmented*
program: it snapshots the launch's uniform scalar arguments and consults
the :class:`~repro_torch.core.passes.SpecializationPolicy` (launch-time
specialization — the paper's runtime translates at launch, when every
scalar is known), runs the :mod:`~repro_torch.core.passes` pipeline at the
launch's ``opt_level`` (with the scalars bound as constants when the
policy grants a specialized variant), asks :mod:`~repro_torch.core.segments` to
split the optimized body at barriers ("each segment is a separate
kernel"), then executes the node list one entry at a time, delegating
each straight-line :class:`~repro_torch.core.segments.SegNode` to the bound
backend — whose translation of it lands in the shared
:class:`~repro_torch.core.cache.TranslationCache` under a key carrying the
specialization's bound-scalar vector.

The engine owns the *control* state the paper puts in its snapshots
(§4.3 "State Representation"): the position in the segmented program
(node index — the device-neutral stand-in for a machine PC), loop
iteration counters, the per-thread virtual register file, shared memory,
and global buffers.  Backends only ever execute one straight-line segment;
everything between segments (barrier semantics, loop back-edges,
cooperative pause flags, snapshot / resume) lives here and is therefore
**identical across backends** — which is precisely what makes
cross-backend migration (§6.3) sound.  Between segments the engine also
prunes registers no later node may read (per-node liveness,
:mod:`~repro_torch.core.liveness`), the paper's §8 "only saving live
registers" snapshot-size optimization — the same set the CUDA kernels
write out, so a port snapshot holds at most the registers the reference's
holds at the same barrier.

State stays on the backend's device between segments (torch tensors);
only :meth:`Engine.snapshot` moves it to host numpy, and
:meth:`Engine.resume` moves a snapshot onto the backend's device.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from . import hetir as ir
from .backends.base import (Backend, HostState, Launch, to_numpy, to_tensor,
                            torch_dtype)
from .liveness import live_in
from .passes import (DEFAULT_OPT_LEVEL, OPT_MAX, SPECIALIZATION_POLICY,
                     get_optimized, get_specialized)
from .segments import (LoopEnd, LoopStart, Node, SegNode, dynamic_op_count,
                       program_nodes, resolve_trip_count)
from .state import Snapshot


class Engine:
    def __init__(self, program: ir.Program, backend: Backend,
                 num_blocks: int, block_size: int,
                 args: Dict[str, object], opt_level: int = None,
                 specialize: Optional[bool] = None,
                 _from_snapshot: bool = False,
                 _spec_key: Optional[tuple] = None):
        program.validate()
        self.opt_level = DEFAULT_OPT_LEVEL if opt_level is None \
            else max(0, min(int(opt_level), OPT_MAX))
        self.source_program = program
        # snapshot the uniform scalar arguments up front: launch-time
        # specialization (paper §4.2 — translation happens at launch, when
        # every scalar is known) may bind them into the optimized body
        scalars: Dict[str, object] = {}
        shapes: Dict[str, tuple] = {}
        if not _from_snapshot:
            for p in program.scalars():
                if p.name not in args:
                    raise ValueError(f"missing scalar argument {p.name}")
                scalars[p.name] = ir.np_dtype(p.dtype).type(args[p.name])
            # buffer shapes join the launch record up front: the
            # specialization policy keys on them (two launches differing
            # only in buffer length are distinct variants) and the pallas
            # block lowering proves tiled-buffer legality against them
            for p in program.buffers():
                if p.name in args:
                    val = args[p.name]
                    if hasattr(val, "uid") and hasattr(val, "data"):
                        val = val.data
                    shapes[p.name] = tuple(val.shape) \
                        if isinstance(val, torch.Tensor) \
                        else tuple(np.shape(val))
        # run the pass pipeline before translation (paper §4.2: the runtime
        # "dynamically translates this IR to the target GPU's native code" —
        # every backend then consumes the same optimized body).  Memoized per
        # (program, level[, spec key]) so segmentation and fingerprints stay
        # stable.  A resume reapplies the snapshot's spec key verbatim —
        # never the policy — so the destination reconstructs the exact node
        # list the node_idx addresses.
        if _spec_key is not None:
            self.spec_key = tuple(tuple(e) for e in _spec_key)
        else:
            self.spec_key = SPECIALIZATION_POLICY.consider(
                program, self.opt_level, scalars, override=specialize,
                shapes=shapes)
        if self.spec_key:
            opt_prog, self.opt_stats = get_specialized(
                program, self.opt_level, self.spec_key)
        else:
            opt_prog, self.opt_stats = get_optimized(program, self.opt_level)
        self.program = opt_prog
        self.backend = backend
        # segmentation is memoized on the (optimized) Program so SegNode
        # identities are stable across launches — the shared translation
        # cache keys on the program fingerprint + segment index
        # (paper §4.2: "the runtime caches these translated kernels")
        self.nodes = program_nodes(opt_prog)
        self.launch = Launch(opt_prog, num_blocks, block_size,
                             scalars=scalars, opt_level=self.opt_level,
                             spec_key=self.spec_key, buffer_shapes=shapes)
        self.node_idx = 0
        self.loop_counters: Dict[int, int] = {}
        self.finished = False
        # per-thread executed-op schedule size, accumulated per executed
        # segment (segments.dynamic_op_count) — the benchmark metric that
        # makes unrolling + post-unroll folding visible as one number.
        # Counts are memoized per node: stmts and launch scalars are fixed
        # for an engine, and segment-level loops re-execute their nodes.
        self.executed_ops = 0
        self._node_sched: Dict[int, int] = {}
        # DeviceBuffer identity (runtime.py object model): param name ->
        # the uid of the buffer handle bound at launch (None for raw host
        # arrays).  Rides in every snapshot so restore/migration can
        # re-bind the same live buffer — identity survives checkpoints.
        self.buffer_uids: Dict[str, Optional[str]] = {}

        # registers live on entry to each node — everything else is dead
        # there and gets pruned from state (the paper's "only saving live
        # registers" snapshot-size optimization, §8 Scalability)
        self._live_in = live_in(opt_prog)

        if _from_snapshot:
            return

        dev = backend.device
        globals_: Dict[str, torch.Tensor] = {}
        for p in program.buffers():
            if p.name not in args:
                raise ValueError(f"missing buffer argument {p.name}")
            val = args[p.name]
            # a runtime.DeviceBuffer handle (duck-typed — runtime imports
            # this module, not the reverse): unwrap and record its uid
            if hasattr(val, "uid") and hasattr(val, "data"):
                self.buffer_uids[p.name] = val.uid
                val = val.data
            buf = to_tensor(val, p.dtype, dev)
            if buf.dim() != 1:
                raise ValueError(f"buffer {p.name} must be 1-D")
            globals_[p.name] = buf

        shared = None
        if program.shared_size:
            shared = torch.zeros((num_blocks, program.shared_size),
                                 dtype=torch_dtype(program.shared_dtype),
                                 device=dev)
        self.state = HostState(regs={}, shared=shared, globals_=globals_)

    # ------------------------------------------------------------------
    def run(self, max_segments: Optional[int] = None,
            pause_flag: Optional[Callable[[], bool]] = None,
            on_segment: Optional[Callable[["Engine"], bool]] = None
            ) -> bool:
        """Execute until completion, ``max_segments`` executed segments, or
        ``pause_flag()`` turning true at a barrier.  Returns True iff the
        program ran to completion.

        ``on_segment`` is the segment-boundary *yield hook*: it is invoked
        after **every** executed segment (including the last one, so
        callers can account/trace each segment exactly once), and a truthy
        return requests a cooperative yield at this barrier — the serving
        scheduler uses it to preempt a stream mid-quantum when a
        higher-priority stream becomes runnable."""
        executed = 0
        while self.node_idx < len(self.nodes):
            if max_segments is not None and executed >= max_segments:
                return False
            node = self.nodes[self.node_idx]
            if isinstance(node, SegNode):
                self.backend.run_segment(node, self.state, self.launch)
                sched = self._node_sched.get(self.node_idx)
                if sched is None:
                    sched = dynamic_op_count(node.stmts,
                                             self.launch.scalars)
                    self._node_sched[self.node_idx] = sched
                self.executed_ops += sched
                executed += 1
                self.node_idx += 1
                self._prune_dead_regs()
                # a barrier boundary — the paper's cooperative pause point
                yield_req = (on_segment is not None and on_segment(self))
                if self.node_idx < len(self.nodes):
                    if yield_req:
                        return False
                    if pause_flag is not None and pause_flag():
                        return False
            elif isinstance(node, LoopStart):
                if self._trip_count(node) <= 0:
                    # zero-trip loop: jump past the matching LoopEnd.  The
                    # skipped segments never execute, so registers they
                    # would define are materialized as zeros (hetIR
                    # registers read as zero until first written) — later
                    # segments and snapshots then see identical state on
                    # every backend.
                    end = next(n.index for n in self.nodes
                               if isinstance(n, LoopEnd)
                               and n.loop_id == node.loop_id)
                    self._zero_fill_skipped_defs(self.node_idx, end)
                    self.node_idx = end + 1
                    continue
                self.loop_counters[node.loop_id] = 0
                self._set_loop_var(node, 0)
                self.node_idx += 1
            elif isinstance(node, LoopEnd):
                start = self.nodes[node.start_index]
                cnt = self.loop_counters[node.loop_id] + 1
                trip = self._trip_count(start)
                if cnt < trip:
                    self.loop_counters[node.loop_id] = cnt
                    self._set_loop_var(start, cnt)
                    self.node_idx = node.start_index + 1
                else:
                    del self.loop_counters[node.loop_id]
                    self.node_idx += 1
        self.finished = True
        return True

    def _trip_count(self, start: LoopStart) -> int:
        trips = resolve_trip_count(start.count, self.launch.scalars)
        if trips is None:
            raise KeyError(f"loop count scalar {start.count!r} is unbound")
        return trips

    def _set_loop_var(self, start: LoopStart, value: int) -> None:
        self.state.regs[start.var.name] = torch.full(
            (self.launch.num_blocks, self.launch.block_size),
            ir.np_dtype(start.var.dtype).type(value).item(),
            dtype=torch_dtype(start.var.dtype), device=self.backend.device)

    def _zero_fill_skipped_defs(self, lo: int, hi: int) -> None:
        shape = (self.launch.num_blocks, self.launch.block_size)
        live = self._live_in[hi + 1]        # where the walk goes on
        for n in self.nodes[lo:hi]:
            if isinstance(n, SegNode):
                for r in n.defs:
                    if r.name in live and r.name not in self.state.regs:
                        self.state.regs[r.name] = torch.zeros(
                            shape, dtype=torch_dtype(r.dtype),
                            device=self.backend.device)

    def _prune_dead_regs(self) -> None:
        """Drop the registers not live on entry to the next node."""
        live = self._live_in[self.node_idx]
        self.state.regs = {k: v for k, v in self.state.regs.items()
                           if k in live}

    # ------------------------------------------------------------------
    def snapshot(self) -> Snapshot:
        """Capture device-neutral state (only legal between segments —
        which is the only place this can be called, by construction)."""
        return Snapshot(
            program_name=self.program.name,
            num_blocks=self.launch.num_blocks,
            block_size=self.launch.block_size,
            node_idx=self.node_idx,
            opt_level=self.opt_level,
            loop_counters=dict(self.loop_counters),
            regs={k: to_numpy(v) for k, v in self.state.regs.items()},
            shared=None if self.state.shared is None
            else to_numpy(self.state.shared),
            globals_={k: to_numpy(v) for k, v in self.state.globals_.items()},
            scalars=dict(self.launch.scalars),
            spec_key=self.spec_key,
            buffer_uids=dict(self.buffer_uids),
        )

    @classmethod
    def resume(cls, program: ir.Program, backend: Backend,
               snap: Snapshot) -> "Engine":
        """Re-instantiate a snapshot on (possibly) a different backend —
        the paper's cross-architecture restore."""
        if snap.program_name != program.name:
            raise ValueError(
                f"snapshot is for {snap.program_name!r}, not {program.name!r}")
        # re-optimize at the snapshot's level — and with the snapshot's
        # specialization key: node indices are positions in the *optimized*
        # (possibly specialized) segmented program, and the pipeline is
        # deterministic, so the destination sees the same node list
        eng = cls(program, backend, snap.num_blocks, snap.block_size,
                  args={}, opt_level=snap.opt_level, _from_snapshot=True,
                  _spec_key=tuple(snap.spec_key))
        eng.launch.scalars = dict(snap.scalars)
        eng.launch.buffer_shapes = {k: tuple(np.shape(v))
                                    for k, v in snap.globals_.items()}
        eng.buffer_uids = dict(snap.buffer_uids)
        eng.node_idx = snap.node_idx
        eng.loop_counters = dict(snap.loop_counters)
        dev = backend.device
        eng.state = HostState(
            regs={k: torch.from_numpy(np.array(v)).to(dev)
                  for k, v in snap.regs.items()},
            shared=None if snap.shared is None
            else torch.from_numpy(np.array(snap.shared)).to(dev),
            globals_={k: torch.from_numpy(np.array(v)).to(dev)
                      for k, v in snap.globals_.items()},
        )
        # a snapshot of the reference holds every register some segment
        # reads; keep those live here
        eng._prune_dead_regs()
        eng.finished = eng.node_idx >= len(eng.nodes)
        return eng

    # ------------------------------------------------------------------
    def result(self, buf: str) -> np.ndarray:
        """Host copy of a global buffer."""
        return to_numpy(self.state.globals_[buf])
