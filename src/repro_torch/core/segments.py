"""Barrier segmentation of hetIR programs (paper §4.3, State Capture).

The paper's state-capture design hinges on splitting a kernel into
*segments* separated by barriers: "we break the kernel into segments
separated by global barriers ... Each segment is a separate kernel."
A snapshot is only taken between segments, where every thread of a block is
at a known, aligned point — so the snapshot is just (segment index, register
file, shared memory, global memory), with no machine PC involved.

Segmentation runs *after* the :mod:`~repro_torch.core.passes` pipeline and is
memoized on the optimized :class:`~repro_torch.core.hetir.Program`, so a
``SegNode``'s index is stable across launches — that index is a component
of every translation-cache key (paper §4.2), and is the ``node_idx`` a
:class:`~repro_torch.core.state.Snapshot` records.  The per-segment def/use and
global-access analyses computed here feed both the engine's live-register
pruning (§8) and the pallas backend's coalesced-buffer tiling.

We flatten a structured :class:`~repro_torch.core.hetir.Program` into a linear
list of *nodes*:

* ``SegNode``   — a straight-line chunk of statements with no top-level
  barrier (it may contain @PRED regions and barrier-free loops);
* ``LoopStart`` / ``LoopEnd`` — control nodes for loops whose body contains
  barriers (the engine maintains an iteration counter per loop — part of the
  device-neutral snapshot, like the paper's loop-counter registers).

Execution then proceeds node by node; between any two nodes the engine may
pause, snapshot, and resume on a different backend.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

from . import hetir as ir


@dataclass
class SegNode:
    index: int
    stmts: List[ir.Stmt]
    label: str = ""
    # analysis results filled by ``segment_program``
    defs: List[ir.Reg] = field(default_factory=list)
    uses: List[ir.Reg] = field(default_factory=list)
    greads: set = field(default_factory=set)
    gwrites: set = field(default_factory=set)
    uses_shared: bool = False


@dataclass
class LoopStart:
    index: int
    loop_id: int
    var: ir.Reg
    count: Union[str, int]  # scalar param name or literal trip count


@dataclass
class LoopEnd:
    index: int
    loop_id: int
    start_index: int


Node = Union[SegNode, LoopStart, LoopEnd]


def static_trip_count(count: Union[str, int]) -> Optional[int]:
    """Trip count of a loop when it is knowable without a launch: an ``int``
    literal.  A scalar-param name returns ``None`` — its value only exists
    at launch time.  This is the legality gate shared by the optimizer
    (:mod:`~repro_torch.core.passes` may unroll, or let value numbers survive a
    loop, only when the trip count is statically positive) and the engine's
    node walker."""
    return int(count) if isinstance(count, int) else None


def resolve_trip_count(count: Union[str, int],
                       scalars: Optional[Dict[str, object]] = None
                       ) -> Optional[int]:
    """Trip count given a launch's uniform scalars; ``None`` if unknowable
    (dynamic count and no/missing scalars)."""
    static = static_trip_count(count)
    if static is not None:
        return static
    if scalars is not None and count in scalars:
        return int(scalars[count])
    return None


def dynamic_op_count(body: Sequence[ir.Stmt],
                     scalars: Optional[Dict[str, object]] = None) -> int:
    """Per-thread *executed-op schedule* size of ``body``: every op counts
    once per time the walker reaches it, with loop bodies multiplied by
    their (resolved) trip counts.  ``@PRED`` bodies count in full — the
    schedule models issued instructions, and every backend walks both sides
    of a predicated region (SIMT masking).  Unresolvable trip counts fall
    back to 1 so the metric stays a lower bound rather than guessing.

    This is the number the translation benchmarks report per opt level:
    loop unrolling plus post-unroll folding/CSE shrink it, which is exactly
    the paper's "optimize once, every target benefits" claim in one
    integer."""
    total = 0
    for s in body:
        if isinstance(s, ir.Op):
            total += 1
        elif isinstance(s, ir.Pred):
            total += dynamic_op_count(s.body, scalars)
        elif isinstance(s, ir.Loop):
            trips = resolve_trip_count(s.count, scalars)
            total += max(0, 1 if trips is None else trips) \
                * dynamic_op_count(s.body, scalars)
    return total


def dynamic_op_histogram(body: Sequence[ir.Stmt],
                         scalars: Optional[Dict[str, object]] = None
                         ) -> Dict[str, int]:
    """Per-thread executed-op schedule of ``body`` broken down *by opcode*
    — the same walk as :func:`dynamic_op_count` (loop bodies multiplied by
    resolved trip counts, ``@PRED`` bodies in full, unresolved trips
    counted once) but keeping each opcode's tally.  This is what the
    measured roofline mode feeds on: memory opcodes (``LD_GLOBAL`` /
    ``ST_GLOBAL`` / ``ATOMIC_ADD`` / block forms) give the bytes term,
    ALU/FMA opcodes give the FLOPs term."""
    hist: Dict[str, int] = {}

    def walk(stmts: Sequence[ir.Stmt], mult: int) -> None:
        for s in stmts:
            if isinstance(s, ir.Op):
                hist[s.opcode] = hist.get(s.opcode, 0) + mult
            elif isinstance(s, ir.Pred):
                walk(s.body, mult)
            elif isinstance(s, ir.Loop):
                trips = resolve_trip_count(s.count, scalars)
                walk(s.body, mult * max(0, 1 if trips is None else trips))

    walk(body, 1)
    return hist


def specializable_counts(body: Sequence[ir.Stmt]) -> set:
    """Scalar-param names used as trip counts of *barrier-free* loops —
    the profitability signal for launch-time specialization: binding one
    of these turns a dynamic trip count static, which is what lets
    :func:`~repro_torch.core.passes.unroll_loops` (and the static-trip gates of
    hoisting / cross-segment value numbering) fire at launch time.
    Barrier-carrying loops are excluded: they are the engine's
    segment/migration structure and are never unrolled, so binding their
    counts alone is not worth a specialized variant."""
    names: set = set()

    def walk(stmts: Sequence[ir.Stmt]) -> None:
        for s in stmts:
            if isinstance(s, ir.Loop):
                if isinstance(s.count, str) \
                        and not ir._contains_barrier(s.body):
                    names.add(s.count)
                walk(s.body)
            elif isinstance(s, ir.Pred):
                walk(s.body)

    walk(body)
    return names


def segment_program(prog: ir.Program) -> List[Node]:
    """Flatten ``prog.body`` into engine nodes, splitting at barriers."""
    nodes: List[Node] = []
    loop_counter = [0]

    def emit_seg(stmts: List[ir.Stmt], label: str) -> None:
        if not stmts:
            return
        seg = SegNode(index=len(nodes), stmts=stmts, label=label)
        seg.defs, seg.uses = ir.body_defs_uses(stmts)
        seg.greads, seg.gwrites = ir.body_global_accesses(stmts)
        seg.uses_shared = ir.body_uses_shared(stmts)
        nodes.append(seg)

    def walk(body: Sequence[ir.Stmt]) -> None:
        pending: List[ir.Stmt] = []
        for s in body:
            if isinstance(s, ir.Barrier):
                emit_seg(pending, label=s.label)
                pending = []
            elif isinstance(s, ir.Loop) and ir._contains_barrier(s.body):
                # flush statements before the loop, then expand the loop
                emit_seg(pending, label="pre-loop")
                pending = []
                loop_counter[0] += 1
                lid = loop_counter[0]
                start = LoopStart(index=len(nodes), loop_id=lid, var=s.var,
                                  count=s.count)
                nodes.append(start)
                walk(s.body)
                # implicit barrier at loop back-edge: segments inside ended
                nodes.append(LoopEnd(index=len(nodes), loop_id=lid,
                                     start_index=start.index))
            else:
                pending.append(s)
        emit_seg(pending, label="tail")

    walk(prog.body)
    # fix node indices after construction order
    for i, n in enumerate(nodes):
        if isinstance(n, SegNode):
            n.index = i
        elif isinstance(n, LoopStart):
            n.index = i
        else:
            n.index = i
    # re-resolve start_index (indices may have shifted): map loop_id -> start
    starts = {n.loop_id: n.index for n in nodes if isinstance(n, LoopStart)}
    for n in nodes:
        if isinstance(n, LoopEnd):
            n.start_index = starts[n.loop_id]
    return nodes


def seg_nodes(nodes: Sequence[Node]) -> List[SegNode]:
    return [n for n in nodes if isinstance(n, SegNode)]
