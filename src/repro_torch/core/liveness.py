"""Register liveness across the segments of an optimized program.

Between two segments the state holds a ``[B, T]`` tensor per register; a
register is worth keeping (and a segment kernel worth writing out) only if
some later node of the walk may read it.  The reference engine keeps every
register that *any* segment reads (``src/repro/core/engine.py``); this
module computes, per node, the registers that are live on entry to it — a
backward fixed point over the node list, with the walk's edges:

* a :class:`~repro_torch.core.segments.SegNode` reads the registers whose
  incoming value it may observe (:func:`exposed_reads`) and kills the
  registers every lane defines unconditionally (:func:`full_defs`); a
  register it defines only under a predicate or in a loop stays live
  through it, because its inactive lanes keep the incoming value;
* a :class:`~repro_torch.core.segments.LoopStart` defines the loop
  variable on entry to the body, and may skip to past its ``LoopEnd``
  (zero trips);
* a :class:`~repro_torch.core.segments.LoopEnd` goes back to the body's
  first node or on past the loop, and counts the loop variable as read,
  so it stays live (and in every snapshot) throughout its loop.

The one set drives the engine's pruning and zero fill, the CUDA kernels'
register slots and the plain version's write-back, so the kernel, the
plain version and the engine hold the same registers after every segment.
Every live set is a subset of the reference's program-wide one: a port
snapshot resumes under the reference, whose surplus registers a port
resume drops.
"""
from __future__ import annotations

from typing import AbstractSet, FrozenSet, List, Sequence

from . import hetir as ir
from .segments import LoopEnd, LoopStart, SegNode, program_nodes


def exposed_reads(stmts: Sequence[ir.Stmt]) -> set:
    """Registers whose value on entry to ``stmts`` some lane may read.

    A read is covered by an earlier def in the same or an enclosing region
    (the lanes that reach the read are the lanes that ran the def); a
    ``SHUFFLE`` reads its source in *other* lanes, active or not, so only
    a def that every lane ran covers it — one outside any predicate.
    Defs inside a predicate or a loop cover nothing after the region (the
    loop may run zero times); a read in a loop body before the body's def
    sees the incoming value on the first trip."""
    exposed: set = set()

    def walk(body, covered: set, full: set, masked: bool) -> None:
        for s in body:
            if isinstance(s, ir.Op):
                for r in s.arg_regs():
                    cross = s.opcode == ir.SHUFFLE and r is s.args[0]
                    if r.name not in (full if cross else covered):
                        exposed.add(r.name)
                if s.dest is not None:
                    covered.add(s.dest.name)
                    if not masked:
                        full.add(s.dest.name)
            elif isinstance(s, ir.Pred):
                if s.cond.name not in covered:
                    exposed.add(s.cond.name)
                walk(s.body, set(covered), set(full), True)
            elif isinstance(s, ir.Loop):
                v = {s.var.name}
                walk(s.body, covered | v, full | (set() if masked else v),
                     masked)

    walk(stmts, set(), set(), False)
    return exposed


def full_defs(stmts: Sequence[ir.Stmt]) -> set:
    """Registers every lane defines, unconditionally: the destinations of
    the top-level ops."""
    return {s.dest.name for s in stmts
            if isinstance(s, ir.Op) and s.dest is not None}


def _defs(seg: SegNode) -> set:
    return {r.name for r in seg.defs}


def live_in(prog: ir.Program) -> List[FrozenSet[str]]:
    """``live[i]``: the registers live on entry to node ``i`` of the
    program's node list (``live[len(nodes)]`` is empty: the walk ends).
    Memoized on the program, as its node list is."""
    cached = getattr(prog, "_live_in_cache", None)
    if cached is not None:
        return cached
    nodes = program_nodes(prog)
    n = len(nodes)
    ends = {nd.loop_id: nd.index for nd in nodes if isinstance(nd, LoopEnd)}
    seg_use = {nd.index: (frozenset(exposed_reads(nd.stmts)),
                          frozenset(full_defs(nd.stmts)))
               for nd in nodes if isinstance(nd, SegNode)}
    live: List[FrozenSet[str]] = [frozenset()] * (n + 1)
    changed = True
    while changed:
        changed = False
        for i in range(n - 1, -1, -1):
            nd = nodes[i]
            if isinstance(nd, SegNode):
                reads, kills = seg_use[i]
                new = reads | (live[i + 1] - kills)
            elif isinstance(nd, LoopStart):
                new = (live[i + 1] - {nd.var.name}) \
                    | live[ends[nd.loop_id] + 1]
            else:
                var = nodes[nd.start_index].var.name
                new = live[nd.start_index + 1] | live[i + 1] | {var}
            if new != live[i]:
                live[i] = frozenset(new)
                changed = True
    prog._live_in_cache = live
    return live


def live_out(prog: ir.Program, seg: SegNode) -> FrozenSet[str]:
    """Registers live after segment ``seg`` (a segment's one successor is
    the next node)."""
    return live_in(prog)[seg.index + 1]


def segment_outputs(seg: SegNode, live: AbstractSet[str]) -> FrozenSet[str]:
    """Registers the segment writes back, given ``live``, the registers
    live after it: those it defines that are live."""
    return frozenset(_defs(seg) & live)


def segment_inputs(seg: SegNode, live: AbstractSet[str]) -> FrozenSet[str]:
    """Registers whose incoming value the segment needs, given ``live``:
    those it may read before writing, and those it defines only in part
    (under a predicate or in a loop) and writes back — their other lanes
    keep the incoming value."""
    partial = _defs(seg) - full_defs(seg.stmts)
    return frozenset(exposed_reads(seg.stmts) | (partial & live))
