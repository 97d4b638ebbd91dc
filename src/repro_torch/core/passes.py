"""hetIR optimization-pass pipeline (paper §4.2, Dynamic Translation).

The paper's runtime "dynamically translates this IR to the target GPU's
native code" and "caches these translated kernels" — before translation it
is free to canonicalize the IR, and because every backend consumes the same
optimized body, one mid-level pipeline pays off on *all* targets at once
(and shrinks the migration payload: dead registers never enter the
snapshot's live set, the paper's §8 "only saving live registers"
optimization).

Passes (all semantics-preserving, verified bit-identical at every opt level
by ``tests/test_passes.py``):

* **constant folding** — ALU/compare/select ops over known constants become
  ``CONST``; evaluation uses the exact numpy dtype semantics of the
  interpreter backend so folded values are bit-identical to runtime values.
  Transcendentals (``SQRT``/``EXP``) are never folded: their libm results
  may differ between numpy (fold time) and XLA (run time) by an ULP.
* **predicate simplification** — ``@PRED(const true)`` regions are spliced
  inline, ``@PRED(const false)`` regions are dropped, empty regions and
  redundant same-condition nests are removed.
* **barrier-aware invariant hoisting** — pure register ops whose inputs are
  loop-invariant move out of ``LOOP`` bodies (across BARRIERs, which only
  order *memory*; register ops may legally cross them — memory ops and
  collectives never move).
* **uniform duplicate merging** — dominator-scoped value numbering merges
  re-emitted constants / param loads / identity reads (the Builder emits a
  fresh ``CONST`` per mention).
* **FMA fusion** — single-use ``MUL`` feeding an ``ADD`` in the same region
  fuses to ``FMA``.  All backends evaluate ``FMA`` as unfused ``a*b + c``,
  so fusion is bit-exact.
* **dead-code elimination** — pure ops whose dests are never read, and the
  empty control regions they leave behind, are deleted.

Phase-2 passes (level 3, the default ``OPT_MAX``; see ``docs/PASSES.md``
for legality conditions and worked examples):

* **loop unrolling** — barrier-free loops with a *static* trip count ≤
  ``HETGPU_UNROLL_MAX`` are flattened; each iteration's copy binds the loop
  variable to a fresh single-def constant, so folding/CSE collapse the
  per-iteration index arithmetic that a counted loop re-executes every
  trip.  The vectorized backend already got this for free by tracing;
  doing it in the IR hands the same win to interp and pallas.
* **strength reduction** — integer ``MUL``/``DIV``/``MOD`` by power-of-two
  constants become ``SHL``/``SHR``/``AND`` (exact: hetIR integer division
  is floor division, so an arithmetic shift right *is* the division), and
  f32 ``DIV`` by a power of two becomes ``MUL`` by its exactly
  representable reciprocal.  The rewritten forms are also hoistable, which
  plain ``DIV``/``MOD`` never are.
* **cross-segment value numbering** — extends duplicate merging across the
  boundaries that create engine segments: a value computed inside a loop
  whose static trip count is ≥ 1 stays available *after* the loop (its
  register provably holds the last-iteration value, which equals what the
  duplicate would recompute), so re-derived quantities are not re-executed
  in later segments.

Phase-3 additions (this level-3 pipeline; see ``docs/PASSES.md``):

* **alias-aware invariant load motion** (:func:`hoist_invariant_loads`) —
  loads whose index is loop-invariant move out of loops with static trip
  count ≥ 1, unless a store in the loop *may alias* them under the affine
  may-alias analysis of :mod:`~repro_torch.core.alias` (distinct buffers never
  alias; same-buffer accesses compare their affine index forms).

* **launch-time specialization** — the paper's runtime translates IR at
  *launch*, when every uniform scalar argument is known, so the engine may
  re-run this pipeline with those scalars bound as constants
  (:func:`bind_launch_scalars` / :func:`get_specialized`): dynamic trip
  counts become static (``unroll_loops`` and the static-trip legality
  gates fire), and size-dependent index math folds away.  A
  :class:`SpecializationPolicy` (``HETGPU_SPECIALIZE``, budgeted by
  ``HETGPU_SPECIALIZE_BUDGET``) gates which launches get a variant;
  everything else falls back to the shared generic translation.  The
  bound-scalar vector (``SpecKey``) joins every translation-cache key and
  rides in snapshots, so a migrated specialized kernel restores against
  the identical specialized body on the destination backend.

Entry point: :func:`optimize`, wired into :class:`~repro_torch.core.engine.Engine`
so every backend translates the optimized body; per-pass statistics are
returned in :class:`PipelineStats` and surfaced through
``HetSession.stats`` and ``benchmarks/bench_translation.py``.  The pass
set itself is fingerprinted (:func:`pipeline_fingerprint`) into the
persistent cache's runtime tag, so changing or re-ordering passes
invalidates previously persisted translations instead of silently
restoring artifacts optimized by an older pipeline.
"""
from __future__ import annotations

import hashlib
import os
import re
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import hetir as ir
from .alias import (GLOBAL_SPACE, SHARED_BUF, SHARED_SPACE, AffineIndex,
                    affine_env, body_mem_accesses, index_form,
                    injective_step, may_alias)
from .segments import specializable_counts, static_trip_count

# --------------------------------------------------------------------------
# Opcode classification
# --------------------------------------------------------------------------

# ops with observable effects beyond their dest register — never removed,
# never moved
SIDE_EFFECT_OPS = {ir.ST_GLOBAL, ir.ST_SHARED, ir.ATOMIC_ADD}

_IDENTITY_OPS = {ir.GET_GLOBAL_ID, ir.GET_BLOCK_ID, ir.GET_THREAD_ID,
                 ir.GET_BLOCK_DIM, ir.GET_NUM_BLOCKS}

# pure register ops that may be hoisted across barriers (barriers order
# memory, not registers) and out of predicate regions (writing a dead lane's
# register early is unobservable — only stores are masked).  DIV/MOD are
# excluded so hoisting can never introduce a divide-by-zero that the source
# program guarded with a predicate or zero-trip loop.
HOISTABLE_OPS = (_IDENTITY_OPS
                 | {ir.CONST, ir.LD_PARAM, ir.MOV, ir.CVT, ir.SELECT, ir.FMA}
                 | ir.ALU_UNARY
                 | (ir.ALU_BINARY - {ir.DIV, ir.MOD})
                 | ir.CMP_OPS)

# value-numberable ops for duplicate merging: pure, thread-deterministic,
# no memory or active-mask dependence
_CSE_OPS = (_IDENTITY_OPS
            | {ir.CONST, ir.LD_PARAM, ir.CVT, ir.SELECT, ir.FMA}
            | ir.ALU_UNARY | ir.ALU_BINARY | ir.CMP_OPS) - {ir.MOV}


def _is_pure(opcode: str) -> bool:
    return opcode not in SIDE_EFFECT_OPS


# --------------------------------------------------------------------------
# Statistics
# --------------------------------------------------------------------------


@dataclass
class PipelineStats:
    """Per-pass change counters (and wall time) for one :func:`optimize`
    run."""

    level: int = 0
    ops_before: int = 0
    ops_after: int = 0
    iterations: int = 0
    per_pass: Dict[str, int] = field(default_factory=dict)
    per_pass_ms: Dict[str, float] = field(default_factory=dict)
    #: bound uniform scalars for a specialized variant; () = generic
    spec_key: Tuple = ()

    def record(self, pass_name: str, n: int, ms: float = 0.0) -> None:
        self.per_pass[pass_name] = self.per_pass.get(pass_name, 0) + n
        self.per_pass_ms[pass_name] = \
            self.per_pass_ms.get(pass_name, 0.0) + ms

    @property
    def ops_removed(self) -> int:
        return self.ops_before - self.ops_after

    def as_dict(self) -> Dict[str, object]:
        return {"level": self.level, "ops_before": self.ops_before,
                "ops_after": self.ops_after, "ops_removed": self.ops_removed,
                "iterations": self.iterations, "per_pass": dict(self.per_pass),
                "per_pass_ms": {k: round(v, 3)
                                for k, v in self.per_pass_ms.items()},
                "spec_key": list(self.spec_key)}


# --------------------------------------------------------------------------
# Constant folding
# --------------------------------------------------------------------------

def _fold_div(a, b):
    if isinstance(a, (np.floating, float)):
        return a / b
    return a // b


def _fold_bitop(fi, fb):
    def f(a, b):
        if isinstance(a, (bool, np.bool_)):
            return fb(a, b)
        return fi(a, b)
    return f


# exact-arithmetic folding tables, matching the interpreter backend's scalar
# semantics op for op (and jnp's IEEE semantics for +,-,*,/ on f32)
_FOLD_BIN = {
    ir.ADD: lambda a, b: a + b,
    ir.SUB: lambda a, b: a - b,
    ir.MUL: lambda a, b: a * b,
    ir.DIV: _fold_div,
    ir.MOD: lambda a, b: a % b,
    ir.MIN: min,
    ir.MAX: max,
    ir.AND: _fold_bitop(lambda a, b: a & b, lambda a, b: a and b),
    ir.OR: _fold_bitop(lambda a, b: a | b, lambda a, b: a or b),
    ir.XOR: _fold_bitop(lambda a, b: a ^ b,
                        lambda a, b: bool(a) != bool(b)),
    ir.SHL: lambda a, b: a << b,
    ir.SHR: lambda a, b: a >> b,
    ir.LT: lambda a, b: a < b,
    ir.LE: lambda a, b: a <= b,
    ir.GT: lambda a, b: a > b,
    ir.GE: lambda a, b: a >= b,
    ir.EQ: lambda a, b: a == b,
    ir.NE: lambda a, b: a != b,
}

_FOLD_UN = {
    ir.NEG: lambda a: -a,
    ir.ABS: abs,
    ir.NOT: lambda a: (not a) if isinstance(a, (bool, np.bool_)) else ~a,
    ir.MOV: lambda a: a,
}


def fold_constants(body: List[ir.Stmt], prog: ir.Program
                   ) -> Tuple[List[ir.Stmt], int]:
    """Replace ops whose inputs are all known constants with ``CONST``.
    Constant visibility is scoped to the structured region tree, so a value
    defined under a predicate or loop never folds into code outside it."""
    defs = ir.reg_def_counts(body)
    consts: Dict[str, object] = {}
    n = [0]

    def try_fold(op: ir.Op) -> ir.Op:
        d = op.dest
        if d is None or defs.get(d.name, 0) != 1:
            return op
        if op.opcode == ir.CONST:
            consts[d.name] = ir.np_dtype(d.dtype).type(op.args[0])
            return op
        foldable = (op.opcode in _FOLD_BIN or op.opcode in _FOLD_UN
                    or op.opcode in (ir.CVT, ir.SELECT, ir.FMA))
        if not foldable:
            return op
        vals = []
        for a in op.args:
            if isinstance(a, ir.Reg):
                if a.name not in consts:
                    return op
                vals.append(consts[a.name])
            else:
                vals.append(a)
        try:
            with np.errstate(all="ignore"):
                if op.opcode in (ir.SHL, ir.SHR) and not (
                        0 <= int(vals[1]) < 32):
                    return op  # out-of-width shifts differ numpy vs XLA
                if (op.opcode in (ir.DIV, ir.MOD)
                        and d.dtype in (ir.I32, ir.U32)
                        and int(vals[1]) == 0):
                    # integer x/0 is 0 under numpy but platform-defined
                    # under XLA: folding would change the vectorized
                    # backend's O0 result
                    return op
                if op.opcode in (ir.MIN, ir.MAX) and any(
                        isinstance(v, (np.floating, float))
                        and np.isnan(v) for v in vals):
                    return op  # NaN min/max differs across backends
                if op.opcode in _FOLD_BIN:
                    v = _FOLD_BIN[op.opcode](*vals)
                elif op.opcode in _FOLD_UN:
                    v = _FOLD_UN[op.opcode](*vals)
                elif op.opcode == ir.CVT:
                    v = vals[0]
                    # float -> int of an out-of-range/NaN value is
                    # backend-dependent (numpy vs XLA): never fold it
                    if isinstance(v, (np.floating, float)) \
                            and d.dtype in (ir.I32, ir.U32):
                        info = np.iinfo(ir.np_dtype(d.dtype))
                        if not (np.isfinite(v)
                                and info.min <= v <= info.max):
                            return op
                elif op.opcode == ir.SELECT:
                    v = vals[1] if bool(vals[0]) else vals[2]
                else:  # FMA — two exact f32 ops, same as every backend
                    v = vals[0] * vals[1] + vals[2]
            v = ir.np_dtype(d.dtype).type(v)
        except (ZeroDivisionError, OverflowError, TypeError, ValueError):
            return op
        consts[d.name] = v
        n[0] += 1
        return ir.Op(ir.CONST, d, (v.item(),))

    def walk(stmts: Sequence[ir.Stmt]) -> List[ir.Stmt]:
        out: List[ir.Stmt] = []
        for s in stmts:
            if isinstance(s, ir.Op):
                out.append(try_fold(s))
            elif isinstance(s, ir.Pred):
                out.append(ir.Pred(s.cond, scoped(s.body)))
            elif isinstance(s, ir.Loop):
                out.append(ir.Loop(s.var, s.count, scoped(s.body)))
            else:
                out.append(s)
        return out

    def scoped(stmts: Sequence[ir.Stmt]) -> List[ir.Stmt]:
        outer = set(consts)
        out = walk(stmts)
        for k in list(consts):
            if k not in outer:
                del consts[k]
        return out

    return walk(body), n[0]


# --------------------------------------------------------------------------
# Predicate simplification
# --------------------------------------------------------------------------


def simplify_predicates(body: List[ir.Stmt], prog: ir.Program
                        ) -> Tuple[List[ir.Stmt], int]:
    """Splice always-true @PRED regions, drop always-false and empty ones,
    flatten redundant same-condition nests, and remove dead zero-trip
    constant loops.  Constant-condition visibility is scoped to the region
    tree: a CONST defined under some other predicate is only conditionally
    written at level 0 (the interp backend masks register writes), so it
    must never simplify a predicate outside its region."""
    defs = ir.reg_def_counts(body)
    uses = ir.reg_use_counts(body)
    const_bools: Dict[str, bool] = {}
    n = [0]

    def walk(stmts: Sequence[ir.Stmt]) -> List[ir.Stmt]:
        out: List[ir.Stmt] = []
        for s in stmts:
            if isinstance(s, ir.Op):
                if (s.opcode == ir.CONST and s.dest is not None
                        and s.dest.dtype == ir.BOOL
                        and defs.get(s.dest.name, 0) == 1):
                    const_bools[s.dest.name] = bool(s.args[0])
                out.append(s)
                continue
            if isinstance(s, ir.Pred):
                inner = scoped(s.body)
                if not inner:
                    n[0] += 1
                elif s.cond.name in const_bools:
                    n[0] += 1
                    if const_bools[s.cond.name]:
                        # uniform-true predicate: the active set inside
                        # equals the enclosing one, so splicing is exact
                        out.extend(inner)
                elif (len(inner) == 1 and isinstance(inner[0], ir.Pred)
                        and inner[0].cond.name == s.cond.name):
                    n[0] += 1
                    out.append(ir.Pred(s.cond, inner[0].body))
                else:
                    out.append(ir.Pred(s.cond, inner))
            elif isinstance(s, ir.Loop):
                inner = scoped(s.body)
                dead = (isinstance(s.count, int) and s.count <= 0) \
                    or not inner
                if dead and uses.get(s.var.name, 0) == 0:
                    n[0] += 1
                else:
                    out.append(ir.Loop(s.var, s.count, inner))
            else:
                out.append(s)
        return out

    def scoped(stmts: Sequence[ir.Stmt]) -> List[ir.Stmt]:
        outer = set(const_bools)
        out = walk(stmts)
        for k in list(const_bools):
            if k not in outer:
                del const_bools[k]
        return out

    return walk(body), n[0]


# --------------------------------------------------------------------------
# Barrier-aware loop-invariant hoisting
# --------------------------------------------------------------------------


def _defined_names(stmts: Sequence[ir.Stmt]) -> set:
    """Register names defined anywhere in ``stmts`` (op dests and loop
    vars, recursive) — the "inside the loop" set both hoisting passes
    test invariance against."""
    return set(ir.reg_def_counts(stmts))


def hoist_invariants(body: List[ir.Stmt], prog: ir.Program
                     ) -> Tuple[List[ir.Stmt], int]:
    """Move pure ops whose inputs are defined entirely outside a loop to
    just before that loop.  Hoisting crosses barrier segment boundaries —
    sound for register-only ops, since barriers synchronize memory, not
    registers; the op computes the same value every iteration either way.
    Ops under a @PRED never move: the interp backend masks register writes
    per-thread, so unconditionalizing a write is observable there."""
    defs = ir.reg_def_counts(body)
    n = [0]

    def extract(stmts: Sequence[ir.Stmt], inside: set,
                hoisted: List[ir.Stmt]) -> List[ir.Stmt]:
        out: List[ir.Stmt] = []
        for s in stmts:
            if isinstance(s, ir.Op):
                if (s.opcode in HOISTABLE_OPS and s.dest is not None
                        and defs.get(s.dest.name, 0) == 1
                        and all(r.name not in inside
                                for r in s.arg_regs())):
                    hoisted.append(s)
                    inside.discard(s.dest.name)
                    n[0] += 1
                else:
                    out.append(s)
            elif isinstance(s, ir.Loop):
                # hoisting through a nested loop is fine (its body runs
                # unconditionally for all threads); through a @PRED is not
                out.append(ir.Loop(s.var, s.count,
                                   extract(s.body, inside, hoisted)))
            else:
                out.append(s)
        return out

    def process(stmts: Sequence[ir.Stmt]) -> List[ir.Stmt]:
        out: List[ir.Stmt] = []
        for s in stmts:
            if isinstance(s, ir.Loop):
                inner = process(s.body)
                inside = _defined_names(inner) | {s.var.name}
                while True:
                    hoisted: List[ir.Stmt] = []
                    inner = extract(inner, inside, hoisted)
                    if not hoisted:
                        break
                    out.extend(hoisted)
                out.append(ir.Loop(s.var, s.count, inner))
            elif isinstance(s, ir.Pred):
                out.append(ir.Pred(s.cond, process(s.body)))
            else:
                out.append(s)
        return out

    return process(body), n[0]


# --------------------------------------------------------------------------
# Alias-aware loop-invariant load motion
# --------------------------------------------------------------------------


def hoist_invariant_loads(body: List[ir.Stmt], prog: ir.Program
                          ) -> Tuple[List[ir.Stmt], int]:
    """Move provably loop-invariant ``LD_GLOBAL``/``LD_SHARED`` ops out of
    loops — the loop-invariant *memory* motion :func:`hoist_invariants`
    cannot do, because loads observe stores.

    Legality (all must hold, per load):

    * the loop's **static trip count is ≥ 1** — hoisting out of a
      possibly-zero-trip loop would execute a load (and its index) that
      never ran, exactly the hazard that keeps ``DIV``/``MOD`` out of
      :data:`HOISTABLE_OPS`.  Launch-time specialization is what makes
      dynamic-trip loops eligible: binding the count makes it static;
    * the load sits at the **loop body's top level** (not under a
      ``@PRED`` — a masked register write must stay masked), its dest is
      single-def, and its index registers are defined outside the loop;
    * **no store in the loop may alias it** (:mod:`~repro_torch.core.alias`):
      stores to *other* buffers never block; a same-buffer
      ``ST_GLOBAL``/``ST_SHARED``/``ATOMIC_ADD`` blocks unless the affine
      index forms are provably disjoint across *all* thread pairs
      (identical base/coefficient terms, constant delta indivisible by
      the coefficients' power-of-two gcd).  Bases defined inside the loop
      (including the loop variable) are unstable and force a conservative
      block.

    Hoisting then crosses any barrier inside the loop soundly: with no
    may-aliasing store in the body, no thread of any block writes the
    loaded address between iterations, so the value the pre-loop load
    reads is the value every iteration would have read."""
    defs = ir.reg_def_counts(body)
    aff = affine_env(body)
    n = [0]

    def load_site(op: ir.Op):
        if op.opcode == ir.LD_GLOBAL:
            return GLOBAL_SPACE, op.args[0], op.args[1]
        if op.opcode == ir.LD_SHARED:
            return SHARED_SPACE, SHARED_BUF, op.args[0]
        return None

    def process(stmts: Sequence[ir.Stmt]) -> List[ir.Stmt]:
        out: List[ir.Stmt] = []
        for s in stmts:
            if isinstance(s, ir.Loop):
                inner = process(s.body)
                trip = static_trip_count(s.count)
                if trip is not None and trip >= 1:
                    inside = _defined_names(inner) | {s.var.name}
                    _, writes = body_mem_accesses(inner)
                    while True:
                        hoisted: List[ir.Stmt] = []
                        kept: List[ir.Stmt] = []

                        def stable(name: str) -> bool:
                            return name not in inside \
                                and defs.get(name, 0) == 1

                        for t in inner:
                            site = load_site(t) if isinstance(t, ir.Op) \
                                else None
                            if (site is not None and t.dest is not None
                                    and defs.get(t.dest.name, 0) == 1
                                    and all(r.name not in inside
                                            for r in t.arg_regs())):
                                space, buf, idx = site
                                lform = index_form(idx, aff, defs)
                                blocked = any(
                                    wspace == space and wbuf == buf
                                    and may_alias(
                                        lform,
                                        index_form(widx, aff, defs),
                                        stable)
                                    for wspace, wbuf, widx in writes)
                                if not blocked:
                                    hoisted.append(t)
                                    inside.discard(t.dest.name)
                                    n[0] += 1
                                    continue
                            kept.append(t)
                        inner = kept
                        out.extend(hoisted)
                        if not hoisted:
                            break
                out.append(ir.Loop(s.var, s.count, inner))
            elif isinstance(s, ir.Pred):
                out.append(ir.Pred(s.cond, process(s.body)))
            else:
                out.append(s)
        return out

    return process(body), n[0]


# --------------------------------------------------------------------------
# Uniform duplicate merging (dominator-scoped value numbering)
# --------------------------------------------------------------------------


def _value_number(body: List[ir.Stmt], prog: ir.Program,
                  cross_loops: bool) -> Tuple[List[ir.Stmt], int]:
    """Value-numbering core shared by :func:`merge_duplicates` (region
    scope) and :func:`value_number_cross_segment` (``cross_loops=True``).

    A duplicate nested under a @PRED is only merged when every use of its
    dest lies inside that same predicate region: at level 0 the interp
    backend writes the dup's register only for active threads, so a read
    outside the region would observe the rename.

    With ``cross_loops``, values defined at the top level of a loop whose
    static trip count is ≥ 1 stay available after the loop: the defining op
    provably executed, its non-loop-var inputs are single-def (unchanged),
    and the loop variable's final value is exactly what a post-loop
    duplicate would read — so the register already holds the duplicate's
    value across the LoopEnd segment boundary.  Dynamic or possibly
    zero-trip loops keep the conservative region scope."""
    defs = ir.reg_def_counts(body)
    rename: Dict[str, ir.Reg] = {}
    table: Dict[Tuple, ir.Reg] = {}
    n = [0]

    # pred-ancestor chains (tuples of Pred object ids) for every reg use
    use_chains: Dict[str, List[Tuple[int, ...]]] = {}

    def collect_uses(stmts: Sequence[ir.Stmt],
                     chain: Tuple[int, ...]) -> None:
        for s in stmts:
            if isinstance(s, ir.Op):
                for r in s.arg_regs():
                    use_chains.setdefault(r.name, []).append(chain)
            elif isinstance(s, ir.Pred):
                use_chains.setdefault(s.cond.name, []).append(chain)
                collect_uses(s.body, chain + (id(s),))
            elif isinstance(s, ir.Loop):
                collect_uses(s.body, chain)

    collect_uses(body, ())

    def uses_confined(name: str, chain: Tuple[int, ...]) -> bool:
        return all(uc[:len(chain)] == chain
                   for uc in use_chains.get(name, []))

    def key_of(op: ir.Op) -> Optional[Tuple]:
        if (op.opcode not in _CSE_OPS or op.dest is None
                or defs.get(op.dest.name, 0) != 1):
            return None
        parts: List[object] = [op.opcode, op.dest.dtype, op.dest.uniform]
        for a in op.args:
            if isinstance(a, ir.Reg):
                if defs.get(a.name, 0) != 1:
                    return None  # value varies across redefinitions
                parts.append(("r", a.name, a.dtype))
            else:
                parts.append(("i", type(a).__name__, repr(a)))
        for k in sorted(op.attrs):
            parts.append(("a", k, repr(op.attrs[k])))
        return tuple(parts)

    def sub(a):
        return rename.get(a.name, a) if isinstance(a, ir.Reg) else a

    def walk(stmts: Sequence[ir.Stmt], chain: Tuple[int, ...],
             marks: Optional[List[Tuple]] = None) -> List[ir.Stmt]:
        own_marks = marks is None
        if own_marks:
            marks = []
        out: List[ir.Stmt] = []
        for s in stmts:
            if isinstance(s, ir.Op):
                args = tuple(sub(a) for a in s.args)
                op = s if args == s.args else \
                    ir.Op(s.opcode, s.dest, args, dict(s.attrs))
                k = key_of(op)
                if k is not None:
                    prior = table.get(k)
                    if prior is not None and (
                            not chain
                            or uses_confined(op.dest.name, chain)):
                        rename[op.dest.name] = prior
                        n[0] += 1
                        continue
                    if prior is None:
                        table[k] = op.dest
                        marks.append(k)
                out.append(op)
            elif isinstance(s, ir.Pred):
                out.append(ir.Pred(sub(s.cond),
                                   walk(s.body, chain + (id(s),))))
            elif isinstance(s, ir.Loop):
                trip = static_trip_count(s.count)
                if cross_loops and trip is not None and trip >= 1:
                    # guaranteed execution: the body's value numbers stay
                    # available in the enclosing scope (parent's marks)
                    inner = walk(s.body, chain, marks)
                else:
                    inner = walk(s.body, chain)
                out.append(ir.Loop(s.var, s.count, inner))
            else:
                out.append(s)
        if own_marks:
            for k in marks:
                del table[k]
        return out

    return walk(body, ()), n[0]


def merge_duplicates(body: List[ir.Stmt], prog: ir.Program
                     ) -> Tuple[List[ir.Stmt], int]:
    """Merge re-emitted identical pure ops (the Builder emits a fresh CONST
    per mention) via value numbering scoped to the structured-region tree,
    so a merge target always dominates the duplicate it replaces."""
    return _value_number(body, prog, cross_loops=False)


def value_number_cross_segment(body: List[ir.Stmt], prog: ir.Program
                               ) -> Tuple[List[ir.Stmt], int]:
    """:func:`merge_duplicates` extended across segment-creating loop
    boundaries (see :func:`_value_number`): values computed inside a
    statically-guaranteed loop serve later duplicates — including ones in
    segments after the loop's barriers — without re-execution.  This is
    where non-hoistable duplicates (``DIV``/``MOD``, which
    :func:`hoist_invariants` refuses to move) finally merge."""
    return _value_number(body, prog, cross_loops=True)


# --------------------------------------------------------------------------
# FMA fusion
# --------------------------------------------------------------------------


def fuse_fma(body: List[ir.Stmt], prog: ir.Program
             ) -> Tuple[List[ir.Stmt], int]:
    """Fuse a single-use f32 ``MUL`` feeding an ``ADD`` in the same region
    into ``FMA``.  Every backend evaluates FMA as the unfused ``a*b + c``,
    so the fusion is bit-exact; DCE then deletes the orphaned MUL."""
    defs = ir.reg_def_counts(body)
    uses = ir.reg_use_counts(body)

    # map mul-dest name -> (mul op, region path); paths gate fusion to the
    # same structured region so activity masks line up exactly
    muls: Dict[str, Tuple[ir.Op, Tuple[int, ...]]] = {}

    def collect(stmts: Sequence[ir.Stmt], path: Tuple[int, ...]) -> None:
        for i, s in enumerate(stmts):
            if isinstance(s, ir.Op):
                if (s.opcode == ir.MUL and s.dest is not None
                        and s.dest.dtype == ir.F32
                        and defs.get(s.dest.name, 0) == 1
                        and uses.get(s.dest.name, 0) == 1
                        and all(defs.get(r.name, 0) == 1
                                for r in s.arg_regs())):
                    muls[s.dest.name] = (s, path)
            elif isinstance(s, (ir.Pred, ir.Loop)):
                collect(s.body, path + (i,))

    collect(body, ())
    n = [0]

    def walk(stmts: Sequence[ir.Stmt], path: Tuple[int, ...]
             ) -> List[ir.Stmt]:
        out: List[ir.Stmt] = []
        for i, s in enumerate(stmts):
            if isinstance(s, ir.Op):
                if (s.opcode == ir.ADD and s.dest is not None
                        and s.dest.dtype == ir.F32):
                    for ai, other in ((0, 1), (1, 0)):
                        a = s.args[ai]
                        if (isinstance(a, ir.Reg) and a.name in muls
                                and muls[a.name][1] == path):
                            mul = muls[a.name][0]
                            out.append(ir.Op(
                                ir.FMA, s.dest,
                                (mul.args[0], mul.args[1], s.args[other])))
                            n[0] += 1
                            break
                    else:
                        out.append(s)
                else:
                    out.append(s)
            elif isinstance(s, ir.Pred):
                out.append(ir.Pred(s.cond, walk(s.body, path + (i,))))
            elif isinstance(s, ir.Loop):
                out.append(ir.Loop(s.var, s.count, walk(s.body, path + (i,))))
            else:
                out.append(s)
        return out

    return walk(body, ()), n[0]


# --------------------------------------------------------------------------
# Dead-code elimination
# --------------------------------------------------------------------------


def eliminate_dead_code(body: List[ir.Stmt], prog: ir.Program
                        ) -> Tuple[List[ir.Stmt], int]:
    """Delete pure ops whose dests are never read, then the empty @PRED
    regions and dead loops left behind; iterate to a fixpoint."""
    total = 0
    while True:
        uses = ir.reg_use_counts(body)
        removed = [0]

        def walk(stmts: Sequence[ir.Stmt]) -> List[ir.Stmt]:
            out: List[ir.Stmt] = []
            for s in stmts:
                if isinstance(s, ir.Op):
                    if (s.dest is not None and _is_pure(s.opcode)
                            and uses.get(s.dest.name, 0) == 0):
                        removed[0] += 1
                    else:
                        out.append(s)
                elif isinstance(s, ir.Pred):
                    inner = walk(s.body)
                    if inner:
                        out.append(ir.Pred(s.cond, inner))
                    else:
                        removed[0] += 1
                elif isinstance(s, ir.Loop):
                    inner = walk(s.body)
                    if inner or uses.get(s.var.name, 0) > 0:
                        out.append(ir.Loop(s.var, s.count, inner))
                    else:
                        removed[0] += 1
                else:
                    out.append(s)
            return out

        body = walk(body)
        if removed[0] == 0:
            return body, total
        total += removed[0]


# --------------------------------------------------------------------------
# Loop unrolling (phase 2)
# --------------------------------------------------------------------------

#: largest static trip count that is unrolled (HETGPU_UNROLL_MAX overrides)
UNROLL_MAX_TRIPS = max(0, int(os.environ.get("HETGPU_UNROLL_MAX", "8")))
#: code-growth budget: trips × body ops must stay under this
UNROLL_MAX_BODY_OPS = 256


def _subst_copy(stmts: Sequence[ir.Stmt],
                ren: Dict[str, ir.Reg]) -> List[ir.Stmt]:
    """Fresh structural copy of ``stmts`` with registers renamed per
    ``ren``.  Every Pred/Loop node is rebuilt (passes key on node identity,
    so copies must never alias the original tree)."""
    out: List[ir.Stmt] = []
    for s in stmts:
        if isinstance(s, ir.Op):
            dest = s.dest
            if dest is not None and dest.name in ren:
                dest = ren[dest.name]
            args = tuple(ren.get(a.name, a) if isinstance(a, ir.Reg) else a
                         for a in s.args)
            out.append(ir.Op(s.opcode, dest, args, dict(s.attrs)))
        elif isinstance(s, ir.Pred):
            out.append(ir.Pred(ren.get(s.cond.name, s.cond),
                               _subst_copy(s.body, ren)))
        elif isinstance(s, ir.Loop):
            out.append(ir.Loop(s.var, s.count, _subst_copy(s.body, ren)))
        else:
            out.append(ir.Barrier(s.label))
    return out


def _collect_op_defs(stmts: Sequence[ir.Stmt]) -> Dict[str, ir.Reg]:
    """First Reg object per name defined by an Op in ``stmts`` (recursive;
    loop-header vars excluded — they are never renamed)."""
    found: Dict[str, ir.Reg] = {}

    def walk(ss):
        for s in ss:
            if isinstance(s, ir.Op):
                if s.dest is not None:
                    found.setdefault(s.dest.name, s.dest)
            elif isinstance(s, (ir.Pred, ir.Loop)):
                walk(s.body)

    walk(stmts)
    return found


def _conditional_def_names(stmts: Sequence[ir.Stmt]) -> set:
    """Names whose def sits under a @PRED (or nested loop) in ``stmts``.
    Such a write may not happen in a given iteration for a given thread,
    so the register legally *carries* its previous-iteration value — it
    must never be renamed per unrolled copy."""
    names: set = set()

    def walk(ss, under: bool):
        for s in ss:
            if isinstance(s, ir.Op):
                if under and s.dest is not None:
                    names.add(s.dest.name)
            elif isinstance(s, (ir.Pred, ir.Loop)):
                walk(s.body, True)

    walk(stmts, False)
    return names


#: names minted by passes: ``srN.c`` (strength-reduce constants) and the
#: ``.itN`` / ``.uN`` suffixes of unrolled copies.  Each pass seeds its
#: counter past the largest tag already present in the body, so a second
#: pipeline iteration (or a pass re-run on already-optimized IR) can never
#: re-mint a name that an earlier invocation defined with another value —
#: while staying deterministic (the seed is a pure function of the body).
_SR_NAME = re.compile(r"^sr(\d+)\.c$")
_UNROLL_TAG = re.compile(r"\.(?:it|u)(\d+)$")


def _fresh_base(body: Sequence[ir.Stmt], pattern: re.Pattern) -> int:
    base = 0
    for op in ir.walk_ops(body):
        if op.dest is not None:
            m = pattern.search(op.dest.name)
            if m:
                base = max(base, int(m.group(1)))
    return base


def unroll_loops(body: List[ir.Stmt], prog: ir.Program
                 ) -> Tuple[List[ir.Stmt], int]:
    """Flatten barrier-free loops with static trip count in
    ``[1, UNROLL_MAX_TRIPS]`` (and ``trips × body ops ≤
    UNROLL_MAX_BODY_OPS``) into straight-line copies of the body.

    Each iteration binds the loop variable to a fresh single-def ``CONST``
    and renames the body's *local* registers (defined only inside the body
    and never read outside it), so every copy is single-def — which is what
    lets the downstream folding/CSE/DCE passes collapse the per-iteration
    index arithmetic.  Registers that escape the loop keep their names:
    the last copy's write is the value a post-loop reader must see, exactly
    as the rolled loop behaves.  After the copies the loop variable itself
    is materialized to its final value (``trips - 1``) for any post-loop
    reads; DCE deletes it when unused.  Innermost loops unroll first
    (sweep to fixpoint), so tight nests flatten fully within budget.
    Barrier-carrying loops are never unrolled — their iteration structure
    *is* the engine's segment/migration boundary."""
    uid = [_fresh_base(body, _UNROLL_TAG)]
    total = 0
    while True:
        body, changed = _unroll_sweep(body, uid)
        total += changed
        if not changed:
            return body, total


def _unroll_sweep(body: List[ir.Stmt], uid: List[int]
                  ) -> Tuple[List[ir.Stmt], int]:
    defs = ir.reg_def_counts(body)
    uses = ir.reg_use_counts(body)
    n = [0]

    def eligible(s: ir.Loop) -> Optional[int]:
        trip = static_trip_count(s.count)
        if trip is None or not 1 <= trip <= UNROLL_MAX_TRIPS:
            return None
        if any(isinstance(x, ir.Loop) for x in ir_walk_stmts(s.body)):
            return None  # innermost first; outer unrolls next sweep
        if ir._contains_barrier(s.body):
            return None
        if trip * ir.count_ops(s.body) > UNROLL_MAX_BODY_OPS:
            return None
        body_defs = ir.reg_def_counts(s.body)
        if s.var.name in body_defs:
            return None  # body writes the loop var: not a counted loop
        return trip

    def expand(s: ir.Loop, trip: int) -> List[ir.Stmt]:
        body_defs = ir.reg_def_counts(s.body)
        body_uses = ir.reg_use_counts(s.body)
        reg_objs = _collect_op_defs(s.body)
        # renameable = defined only inside this body, read only inside it,
        # and written *unconditionally* each iteration.  A def under a
        # @PRED carries its previous-iteration value whenever the
        # predicate is false — renaming it per copy would make later
        # copies read a never-written register (miscompile found by
        # review; regression in tests/test_passes.py).
        conditional = _conditional_def_names(s.body)
        local = {r for r, c in body_defs.items()
                 if c == defs.get(r, 0)
                 and body_uses.get(r, 0) == uses.get(r, 0)
                 and r in reg_objs
                 and r not in conditional}
        out: List[ir.Stmt] = []
        for it in range(trip):
            uid[0] += 1
            tag = uid[0]
            iv = ir.Reg(f"{s.var.name}.it{tag}", s.var.dtype, s.var.uniform)
            ren = {s.var.name: iv}
            for r in local:
                old = reg_objs[r]
                ren[r] = ir.Reg(f"{r}.u{tag}", old.dtype, old.uniform)
            out.append(ir.Op(ir.CONST, iv, (it,)))
            out.extend(_subst_copy(s.body, ren))
        # post-loop reads of the loop var see its final iteration value
        out.append(ir.Op(ir.CONST, s.var, (trip - 1,)))
        return out

    def walk(stmts: Sequence[ir.Stmt]) -> List[ir.Stmt]:
        out: List[ir.Stmt] = []
        for s in stmts:
            if isinstance(s, ir.Loop):
                trip = eligible(s)
                if trip is not None:
                    n[0] += 1
                    out.extend(expand(s, trip))
                else:
                    out.append(ir.Loop(s.var, s.count, walk(s.body)))
            elif isinstance(s, ir.Pred):
                out.append(ir.Pred(s.cond, walk(s.body)))
            else:
                out.append(s)
        return out

    return walk(body), n[0]


def ir_walk_stmts(body: Sequence[ir.Stmt]):
    """Yield every statement in ``body`` recursively (structure included)."""
    for s in body:
        yield s
        if isinstance(s, (ir.Pred, ir.Loop)):
            yield from ir_walk_stmts(s.body)


# --------------------------------------------------------------------------
# Strength reduction (phase 2)
# --------------------------------------------------------------------------


def _pow2_exponent(v) -> Optional[int]:
    """k if ``v`` is exactly 2**k for an integer value, else None."""
    try:
        iv = int(v)
    except (TypeError, ValueError, OverflowError):
        return None
    if iv != v or iv <= 0 or iv & (iv - 1):
        return None
    k = iv.bit_length() - 1
    return k if 0 <= k < 32 else None


def _exact_recip(v) -> Optional[float]:
    """1/v when that reciprocal is exactly representable in f32 and
    round-trips (``v`` a power of two, sign allowed) — the condition under
    which ``x / v`` and ``x * (1/v)`` are bit-identical IEEE results for
    every x, including denormals, infinities and NaN."""
    fv = float(v)
    if fv == 0.0 or not np.isfinite(fv):
        return None
    recip = np.float32(1.0) / np.float32(fv)
    if not np.isfinite(recip) or float(recip) * fv != 1.0:
        return None
    return float(recip)


def strength_reduce(body: List[ir.Stmt], prog: ir.Program
                    ) -> Tuple[List[ir.Stmt], int]:
    """Rewrite multiplicative ops with power-of-two constant operands into
    cheaper exact equivalents:

    * int ``MUL x, 2**k``  → ``SHL x, k``   (two's-complement wrap matches)
    * int ``DIV x, 2**k``  → ``SHR x, k``   (hetIR integer division is
      *floor* division, so the arithmetic shift is exactly it — this
      rewrite would be wrong for C-style truncating division)
    * int ``MOD x, 2**k``  → ``AND x, 2**k - 1``  (floor-mod of a positive
      modulus is non-negative, which is exactly the mask)
    * f32 ``DIV x, c``     → ``MUL x, 1/c``  when ``1/c`` is an exact
      power-of-two reciprocal (division and multiplication then round the
      same infinitely-precise value — bit-identical)
    * ``MUL/DIV x, 1`` → ``MOV x``; int ``MOD x, 1`` → ``CONST 0``

    Beyond the latency win, ``SHL``/``SHR``/``AND`` are *hoistable* ops
    while ``DIV``/``MOD`` are not (divide-by-zero introduction), so reduced
    forms escape loops.  Constant visibility is region-scoped exactly like
    :func:`fold_constants`."""
    defs = ir.reg_def_counts(body)
    consts: Dict[str, object] = {}
    n = [0]
    fresh = [_fresh_base(body, _SR_NAME)]

    def const_reg(dtype: str, value, out: List[ir.Stmt]) -> ir.Reg:
        fresh[0] += 1
        r = ir.Reg(f"sr{fresh[0]}.c", dtype, True)
        out.append(ir.Op(ir.CONST, r, (value,)))
        return r

    def known(a) -> Optional[object]:
        if isinstance(a, ir.Reg):
            return consts.get(a.name)
        return a  # immediate operand

    def rewrite(op: ir.Op, out: List[ir.Stmt]) -> bool:
        d = op.dest
        if d is None or op.opcode not in (ir.MUL, ir.DIV, ir.MOD):
            return False
        is_int = d.dtype in (ir.I32, ir.U32)
        a, b = op.args
        if op.opcode == ir.MUL and is_int:
            for x, c in ((a, known(b)), (b, known(a))):
                if c is None or not isinstance(x, ir.Reg):
                    continue
                k = _pow2_exponent(c)
                if k is None:
                    continue
                if k == 0:
                    out.append(ir.Op(ir.MOV, d, (x,)))
                else:
                    kreg = const_reg(d.dtype, k, out)
                    out.append(ir.Op(ir.SHL, d, (x, kreg)))
                n[0] += 1
                return True
            return False
        c = known(b)
        if c is None or not isinstance(a, ir.Reg):
            return False
        if is_int:
            k = _pow2_exponent(c)
            if k is None:
                return False
            if op.opcode == ir.DIV:
                if k == 0:
                    out.append(ir.Op(ir.MOV, d, (a,)))
                else:
                    kreg = const_reg(d.dtype, k, out)
                    out.append(ir.Op(ir.SHR, d, (a, kreg)))
            else:  # MOD
                if k == 0:
                    out.append(ir.Op(ir.CONST, d, (0,)))
                else:
                    mreg = const_reg(d.dtype, (1 << k) - 1, out)
                    out.append(ir.Op(ir.AND, d, (a, mreg)))
            n[0] += 1
            return True
        if d.dtype == ir.F32 and op.opcode == ir.DIV:
            recip = _exact_recip(c)
            if recip is None:
                return False
            if recip == 1.0:
                out.append(ir.Op(ir.MOV, d, (a,)))
            else:
                rreg = const_reg(ir.F32, recip, out)
                out.append(ir.Op(ir.MUL, d, (a, rreg)))
            n[0] += 1
            return True
        return False

    def walk(stmts: Sequence[ir.Stmt]) -> List[ir.Stmt]:
        out: List[ir.Stmt] = []
        for s in stmts:
            if isinstance(s, ir.Op):
                if (s.opcode == ir.CONST and s.dest is not None
                        and defs.get(s.dest.name, 0) == 1):
                    consts[s.dest.name] = \
                        ir.np_dtype(s.dest.dtype).type(s.args[0])
                if not rewrite(s, out):
                    out.append(s)
            elif isinstance(s, ir.Pred):
                out.append(ir.Pred(s.cond, scoped(s.body)))
            elif isinstance(s, ir.Loop):
                out.append(ir.Loop(s.var, s.count, scoped(s.body)))
            else:
                out.append(s)
        return out

    def scoped(stmts: Sequence[ir.Stmt]) -> List[ir.Stmt]:
        outer = set(consts)
        out = walk(stmts)
        for k in list(consts):
            if k not in outer:
                del consts[k]
        return out

    return walk(body), n[0]


# --------------------------------------------------------------------------
# Pipeline driver
# --------------------------------------------------------------------------

PassFn = Callable[[List[ir.Stmt], ir.Program], Tuple[List[ir.Stmt], int]]

_PIPELINES: Dict[int, List[PassFn]] = {
    0: [],
    1: [fold_constants, eliminate_dead_code],
    2: [fold_constants, simplify_predicates, hoist_invariants,
        merge_duplicates, fuse_fma, fold_constants, eliminate_dead_code],
    # phase 2/3.  A fold/pred/hoist prefix runs *before* unrolling so
    # loop-invariant scalars (and the constants feeding invariant-load
    # indices) leave loop bodies first — then hoist_invariant_loads can
    # lift an alias-free load once instead of unrolling N copies of it.
    # Unrolling next, so the second folding/CSE sweep sees per-iteration
    # constants; value numbering (cross-segment) before strength
    # reduction so duplicate DIV/MODs merge before being rewritten; the
    # final fold sweep cleans up what unrolling and strength reduction
    # exposed
    3: [fold_constants, simplify_predicates, hoist_invariants,
        hoist_invariant_loads, unroll_loops, fold_constants,
        simplify_predicates, hoist_invariants, value_number_cross_segment,
        strength_reduce, fuse_fma, fold_constants, eliminate_dead_code],
}

OPT_MAX = max(_PIPELINES)
_MAX_PIPELINE_ITERS = 4

#: bump when any pass's *output semantics* change without a rename — part
#: of :func:`pipeline_fingerprint`, hence of the persistent store's tag
#: (v3: launch-time specialization + alias-aware load hoisting; the
#: translation-cache key layout also gained the bound-scalar vector.
#: v4: block-tiled pallas lowering — translation keys gained the block
#: plan component, spec keys gained inert ``name#shape`` buffer-extent
#: entries, and uninitialized-register reads are defined as zero on every
#: backend — stale DiskStore entries from v3 must not be revived)
_PASS_SCHEMA_VERSION = 4

DEFAULT_OPT_LEVEL = max(0, min(
    int(os.environ.get("HETGPU_OPT_LEVEL", str(OPT_MAX))), OPT_MAX))


def pipeline_fingerprint() -> str:
    """Stable digest of the pass pipeline configuration: pass names per
    level (order included), the unrolling limits, and the schema version.
    :func:`repro_torch.core.cache.runtime_tag` folds this into the persistent
    store's directory tag, so *any* pass-set change — added, removed,
    reordered passes, changed thresholds, or a bumped schema — invalidates
    every persisted translation.  Without it, a store populated by an older
    pipeline would silently serve artifacts the current optimizer would
    never produce."""
    h = hashlib.sha256()
    h.update(f"schema{_PASS_SCHEMA_VERSION}".encode())
    for level in sorted(_PIPELINES):
        names = ",".join(fn.__name__ for fn in _PIPELINES[level])
        h.update(f"|{level}:{names}".encode())
    h.update(f"|unroll{UNROLL_MAX_TRIPS}x{UNROLL_MAX_BODY_OPS}".encode())
    return h.hexdigest()[:12]


def optimize(program: ir.Program, level: int = OPT_MAX
             ) -> Tuple[ir.Program, PipelineStats]:
    """Run the pass pipeline for ``level`` and return a new, semantically
    identical :class:`~repro_torch.core.hetir.Program` plus per-pass statistics.
    ``level`` clamps into ``[0, OPT_MAX]``; level 0 is the identity."""
    level = max(0, min(int(level), OPT_MAX))
    stats = PipelineStats(level=level, ops_before=ir.count_ops(program.body))
    body = list(program.body)
    pipeline = _PIPELINES[level]
    if pipeline:
        for _ in range(_MAX_PIPELINE_ITERS):
            stats.iterations += 1
            changed = 0
            for pass_fn in pipeline:
                t0 = time.perf_counter()
                body, n = pass_fn(body, program)
                stats.record(pass_fn.__name__, n,
                             (time.perf_counter() - t0) * 1e3)
                changed += n
            if changed == 0:
                break
    out = ir.Program(name=program.name, params=list(program.params),
                     body=body, shared_size=program.shared_size,
                     shared_dtype=program.shared_dtype)
    out.validate()
    stats.ops_after = ir.count_ops(body)
    return out, stats


def get_optimized(program: ir.Program, level: int
                  ) -> Tuple[ir.Program, PipelineStats]:
    """Memoized :func:`optimize` — one optimized body per (program, level),
    so repeated launches (and the segmentation/node cache riding on the
    optimized program) reuse identical objects."""
    level = max(0, min(int(level), OPT_MAX))
    memo = program.__dict__.setdefault("_opt_cache", {})
    hit = memo.get(level)
    if hit is None:
        if level == 0:
            stats = PipelineStats(level=0,
                                  ops_before=ir.count_ops(program.body),
                                  ops_after=ir.count_ops(program.body))
            hit = (program, stats)
        else:
            hit = optimize(program, level)
        memo[level] = hit
    return hit


# --------------------------------------------------------------------------
# Launch-time specialization (paper §4.2: translation happens at launch,
# when every uniform scalar argument is known)
# --------------------------------------------------------------------------

#: (name, value) pairs of bound uniform scalars, sorted by name; () means
#: the generic (unspecialized) program.  This tuple is the *specialization
#: key*: it joins every translation-cache key, rides in snapshots, and
#: selects the memoized specialized variant.
SpecKey = Tuple[Tuple[str, object], ...]


def bind_launch_scalars(body: List[ir.Stmt], prog: ir.Program,
                        values: Dict[str, object]
                        ) -> Tuple[List[ir.Stmt], int]:
    """Rewrite ``LD_PARAM`` of a bound scalar into ``CONST`` of its
    launch value, and dynamic loop counts naming a bound scalar into
    ``int`` literals — after which the ordinary pipeline folds the
    size-dependent index math and :func:`unroll_loops` /
    :func:`hoist_invariant_loads` see static trip counts.  Values are
    typed through the dest register's dtype, so a folded constant is
    bit-identical to what ``LD_PARAM`` would have produced at run time."""
    n = [0]

    def walk(stmts: Sequence[ir.Stmt]) -> List[ir.Stmt]:
        out: List[ir.Stmt] = []
        for s in stmts:
            if isinstance(s, ir.Op):
                if (s.opcode == ir.LD_PARAM and s.dest is not None
                        and s.args[0] in values):
                    v = ir.np_dtype(s.dest.dtype).type(values[s.args[0]])
                    out.append(ir.Op(ir.CONST, s.dest, (v.item(),)))
                    n[0] += 1
                else:
                    out.append(s)
            elif isinstance(s, ir.Pred):
                out.append(ir.Pred(s.cond, walk(s.body)))
            elif isinstance(s, ir.Loop):
                count = s.count
                if isinstance(count, str) and count in values:
                    count = int(values[count])
                    n[0] += 1
                out.append(ir.Loop(s.var, count, walk(s.body)))
            else:
                out.append(s)
        return out

    return walk(body), n[0]


def get_specialized(program: ir.Program, level: int, spec_key: SpecKey
                    ) -> Tuple[ir.Program, PipelineStats]:
    """Memoized specialized variant: bind the scalars in ``spec_key`` as
    constants, then run the ordinary pipeline at ``level``.  Deterministic
    in (program, level, spec_key) — a migration destination re-deriving a
    variant from a snapshot's key reconstructs the *identical* optimized
    body, node list, and program fingerprint."""
    level = max(0, min(int(level), OPT_MAX))
    spec_key = tuple((str(k), v) for k, v in spec_key)
    memo = program.__dict__.setdefault("_spec_cache", {})
    hit = memo.get((level, spec_key))
    if hit is None:
        values = dict(spec_key)
        body, bound = bind_launch_scalars(list(program.body), program,
                                          values)
        seed = ir.Program(name=program.name, params=list(program.params),
                          body=body, shared_size=program.shared_size,
                          shared_dtype=program.shared_dtype)
        out, stats = optimize(seed, level)
        stats.record("bind_launch_scalars", bound)
        stats.spec_key = spec_key
        hit = (out, stats)
        memo[(level, spec_key)] = hit
    return hit


def shape_spec_entries(shapes: Optional[Dict[str, Tuple]]) -> list:
    """Buffer extents as *inert* spec-key entries.

    Names carry a ``#shape`` suffix no hetIR parameter name can have, so
    :func:`bind_launch_scalars` (which matches ``LD_PARAM`` argument names
    and loop-count scalar names) never binds them — they change no op in
    the specialized body.  They exist purely to make the specialization
    key, the memoized variant, every translation-cache key, and the
    snapshot's ``spec_key`` distinguish launches per buffer shape: the
    block-tiled pallas path specializes tile geometry on exactly these
    extents (the PR 5 remainder the roadmap calls "shapes in the launch
    record")."""
    if not shapes:
        return []
    return [(f"{name}#shape", int(np.prod(shape, dtype=np.int64)))
            for name, shape in shapes.items()]


class SpecializationPolicy:
    """Decides whether a launch gets a specialized variant.

    Modes (``HETGPU_SPECIALIZE``, read at decision time so tests can
    flip it):

    * ``off``/``0``/``false``/``no`` — never specialize;
    * ``auto`` (default) — specialize only programs with at least one
      *barrier-free dynamic-trip* loop
      (:func:`~repro_torch.core.segments.specializable_counts`), where binding
      the count unlocks unrolling / static-trip load hoisting;
    * ``all`` — specialize every launch with uniform scalars.

    The per-program **budget** (``HETGPU_SPECIALIZE_BUDGET``, default 8)
    caps how many *distinct* scalar bindings a program may accumulate at
    one opt level; past it, new bindings fall back to the generic variant
    (whose translations every launch shares), so an adversarial scalar
    stream cannot grow code and cache without bound.  Already-admitted
    bindings keep specializing — a warm variant stays warm.  An explicit
    ``override=True`` is a per-launch *demand* (e.g. a caller that needs
    the unrolled body before checkpointing) and bypasses the budget —
    the budget polices the ambient policy, not deliberate requests."""

    def consider(self, program: ir.Program, level: int,
                 scalars: Dict[str, object],
                 override: Optional[bool] = None,
                 shapes: Optional[Dict[str, Tuple]] = None) -> SpecKey:
        if override is False:
            return ()
        mode = "all" if override else \
            os.environ.get("HETGPU_SPECIALIZE", "auto").strip().lower()
        if mode in ("off", "0", "false", "no"):
            return ()
        if level < 1 or (not scalars and not shapes):
            return ()  # O0 is the differential baseline: always generic
        if mode != "all" and not specializable_counts(program.body):
            return ()
        # buffer extents join the key (inert ``name#shape`` entries): two
        # launches differing only in buffer length are *different*
        # specialization variants — the policy used to be shape-blind
        key: SpecKey = tuple(sorted(
            [(name, np.asarray(v).item()) for name, v in scalars.items()]
            + shape_spec_entries(shapes)))
        budget = max(0, int(os.environ.get("HETGPU_SPECIALIZE_BUDGET",
                                           "8")))
        seen = program.__dict__.setdefault("_spec_variants", {}) \
            .setdefault(level, set())
        if key not in seen:
            if override is not True and len(seen) >= budget:
                return ()  # budget exhausted: generic fallback
            seen.add(key)
        return key


#: process-wide policy instance (stateless beyond env/program lookups)
SPECIALIZATION_POLICY = SpecializationPolicy()


# --------------------------------------------------------------------------
# Block lowering — the lane-independence proof behind the pallas tiled
# fast path (see docs/PASSES.md, "Block lowering")
# --------------------------------------------------------------------------

#: thread-identity base kinds an affine index term may stand on
_THREAD_BASES = {ir.GET_GLOBAL_ID: "gid", ir.GET_BLOCK_ID: "bid",
                 ir.GET_THREAD_ID: "tid"}

#: ops whose dest is launch-uniform when every Reg argument is
_UNIFORM_SEED_OPS = {ir.CONST, ir.LD_PARAM, ir.GET_BLOCK_DIM,
                     ir.GET_NUM_BLOCKS}
_UNIFORM_PURE_OPS = (ir.ALU_UNARY | ir.ALU_BINARY | ir.CMP_OPS
                     | {ir.MOV, ir.CVT, ir.SELECT, ir.FMA})


@dataclass(frozen=True)
class BlockPlan:
    """A proven-legal block-tiled lowering of one barrier-free segment.

    ``stmts`` is the segment body with every global access rewritten into
    the block-primitive form (:data:`~repro_torch.core.hetir.BLOCK_LD` /
    :data:`~repro_torch.core.hetir.BLOCK_ST`, constexpr ``block`` size and
    tiling ``mode`` in the op attrs).  ``tiled`` names the buffers whose
    every access index is exactly the flat global id (BlockSpec-tiled one
    tile per grid step); every other accessed buffer is staged whole and
    masked-gathered.  ``block``/``grid`` tile the flat element domain
    ``N = num_blocks * block_size`` into ``grid = N // block`` steps."""

    stmts: Tuple[ir.Stmt, ...]
    tiled: frozenset
    block: int
    grid: int


def choose_block(n_elems: int, cap: Optional[int] = None) -> Optional[int]:
    """Constexpr tile size for a flat element domain of ``n_elems``: the
    largest power of two dividing ``n_elems`` (tiles are always full — the
    semantic mask is the program's own predication), capped by
    ``HETGPU_BLOCK_MAX`` (default 1024, the Triton-style constexpr BLOCK
    ceiling).  ``None`` when no tile exists (``n_elems <= 0``)."""
    if cap is None:
        cap = int(os.environ.get("HETGPU_BLOCK_MAX", "1024"))
    if n_elems <= 0 or cap <= 0:
        return None
    pow2 = n_elems & -n_elems
    cap2 = 1 << (cap.bit_length() - 1)
    return min(pow2, cap2)


def _uniform_regs(stmts: Sequence[ir.Stmt]) -> set:
    """Single-def registers provably launch-uniform (equal across every
    thread of every block): transitive closure of pure ops over uniform
    inputs, seeded by CONST / LD_PARAM / GET_BLOCK_DIM / GET_NUM_BLOCKS.
    Loop variables are *excluded*: they are uniform across threads at any
    instant but vary across iterations, and the block-lowering proof needs
    values stable over the whole segment."""
    defs = ir.reg_def_counts(stmts)
    uni: set = set()

    def uniform_arg(a) -> bool:
        return not isinstance(a, ir.Reg) or a.name in uni

    def walk(body):
        for s in body:
            if isinstance(s, ir.Op):
                d = s.dest
                if d is None or defs.get(d.name, 0) != 1:
                    continue
                if s.opcode in _UNIFORM_SEED_OPS:
                    uni.add(d.name)
                elif s.opcode in _UNIFORM_PURE_OPS \
                        and all(uniform_arg(a) for a in s.args):
                    uni.add(d.name)
            elif isinstance(s, (ir.Pred, ir.Loop)):
                walk(s.body)

    walk(stmts)
    return uni


def _decompose(form: AffineIndex, kinds: Dict[str, str], uniform: set,
               block_size: int) -> Optional[Tuple[int, int, bool]]:
    """Split an affine index form's thread dependence into per-thread
    coefficients.  With ``gid = bid * T + tid``, the address difference of
    two threads ``(bid1, tid1)`` vs ``(bid2, tid2)`` is
    ``cb * (bid1 - bid2) + ct * (tid1 - tid2)`` where ``ct`` / ``cb`` are
    the effective tid / bid coefficients returned here.  Returns ``(ct,
    cb, has_uniform_terms)``, or ``None`` when any base is neither thread
    identity nor launch-uniform (loop variables, loaded values, multi-def
    registers — nothing sound can be said)."""
    c_gid = c_bid = c_tid = 0
    has_uniform = False
    for base, coeff in form.terms:
        k = kinds.get(base)
        if k == "gid":
            c_gid += coeff
        elif k == "bid":
            c_bid += coeff
        elif k == "tid":
            c_tid += coeff
        elif base in uniform:
            has_uniform = True
        else:
            return None
    return (c_gid + c_tid, c_gid * block_size + c_bid, has_uniform)


def _store_injective(ct: int, cb: int, num_blocks: int,
                     block_size: int) -> bool:
    """Does the store form hit a distinct element for every thread of the
    launch, wrap-safely under i32?  Degenerate grids only need one axis;
    the general case requires the (bid, tid) dependence to collapse onto
    the flat global id (``cb == ct * T``) with an injective step."""
    B, T = num_blocks, block_size
    if B <= 1:
        return injective_step(ct, T)
    if T <= 1:
        return injective_step(cb, B)
    return cb == ct * T and injective_step(ct, B * T)


#: The stable refusal-reason vocabulary of :func:`block_lower` (plus
#: ``disabled``, emitted by the pallas backend when the env switch is
#: off).  Every reason string is ``<category>`` or ``<category>:<detail>``
#: where the category is drawn from this tuple — histograms, gates
#: (``scripts/check_zoo.py``) and docs (``docs/ZOO.md``) key on the
#: category; the detail (offending buffer / opcode) is diagnostic only
#: and carries no stability promise.  Adding a category is an API change:
#: document it and extend the regression test in tests/test_model_zoo.py.
REFUSAL_REASONS = ("bad-block", "shared-memory", "collective", "atomic",
                   "opaque-index", "unprovable-base", "store-not-injective",
                   "may-alias", "disabled")


def refusal_category(reason: str) -> str:
    """Stable category of a :func:`block_lower` refusal reason: the part
    before the first ``:`` (reasons are ``category[:detail]``).  Always a
    member of :data:`REFUSAL_REASONS` for reasons this module emits."""
    return reason.split(":", 1)[0]


def block_lower(stmts: Sequence[ir.Stmt], num_blocks: int, block_size: int,
                block: int,
                buffer_lens: Optional[Dict[str, int]] = None
                ) -> Tuple[Optional[BlockPlan], Optional[str]]:
    """Prove a barrier-free segment *lane-independent* and rewrite it into
    block-primitive form; returns ``(plan, None)`` on success or
    ``(None, reason)`` when the proof fails (the pallas backend then keeps
    the scalar-per-thread path and surfaces ``reason`` in its stats).

    A segment is lane-independent when reordering its threads into
    arbitrary flat tiles of ``block`` elements cannot change any result
    bit.  The proof obligations, checked in order:

    * **no cross-thread traffic by construction** — no shared-memory ops,
      no collectives, no ``ATOMIC_ADD`` (its returned old value is
      execution-order-dependent).  Loop trip counts are uniform by hetIR
      construction (an int literal or a uniform scalar param), so there
      are no divergent loop trips to consider.
    * **global stores are thread-injective** — every store index must have
      an affine form (:mod:`~repro_torch.core.alias`) over thread-identity bases
      (``GET_GLOBAL_ID``/``GET_BLOCK_ID``/``GET_THREAD_ID``) and
      launch-uniform values only, whose effective per-thread step is
      injective over the launch under i32 wraparound
      (:func:`~repro_torch.core.alias.injective_step`).  Loop-variable bases
      fail the proof: a store whose address varies per iteration could
      collide with another thread's address from a *different* iteration,
      which tile reordering would then order differently.
    * **same-buffer accesses are per-lane or disjoint** — for every buffer
      the segment writes, each (load, store) and (store, store) pair must
      either share an *identical* index form (the per-lane slot: program
      order within a lane is preserved by any tiling, and store
      injectivity rules out cross-lane hits) or be provably disjoint under
      :func:`~repro_torch.core.alias.may_alias`.  Buffers only read are
      unconstrained (gather tiles never conflict).

    Buffers whose every access is exactly the flat global id *and* whose
    length (from ``buffer_lens``, the launch record's buffer shapes) is
    exactly ``num_blocks * block_size`` become BlockSpec-tiled
    (``mode="tiled"``); all other accesses gather from the whole staged
    buffer (``mode="gather"``)."""
    B, T = int(num_blocks), int(block_size)
    N = B * T
    if block <= 0 or N % block:
        return None, "bad-block"

    for op in ir.walk_ops(stmts):
        if op.opcode in (ir.LD_SHARED, ir.ST_SHARED):
            return None, "shared-memory"
        if op.opcode in ir.COLLECTIVE_OPS:
            return None, f"collective:{op.opcode}"
        if op.opcode == ir.ATOMIC_ADD:
            return None, "atomic"

    env = affine_env(stmts)
    defs = ir.reg_def_counts(stmts)
    uniform = _uniform_regs(stmts)
    kinds: Dict[str, str] = {}
    for op in ir.walk_ops(stmts):
        if op.dest is not None and defs.get(op.dest.name, 0) == 1 \
                and op.opcode in _THREAD_BASES:
            kinds[op.dest.name] = _THREAD_BASES[op.opcode]

    reads, writes = body_mem_accesses(stmts)
    per_buf: Dict[str, list] = {}
    for is_store, accs in ((False, reads), (True, writes)):
        for space, buf, idx in accs:
            assert space == GLOBAL_SPACE  # shared ops rejected above
            per_buf.setdefault(buf, []).append(
                (is_store, index_form(idx, env, defs)))

    written = {buf for _, buf, _ in writes}
    for buf in sorted(written):
        forms = per_buf[buf]
        for is_store, f in forms:
            if f is None:
                return None, f"opaque-index:{buf}"
            if _decompose(f, kinds, uniform, T) is None:
                return None, f"unprovable-base:{buf}"
        store_forms = [f for is_store, f in forms if is_store]
        for fs in store_forms:
            ct, cb, _ = _decompose(fs, kinds, uniform, T)
            if not _store_injective(ct, cb, B, T):
                return None, f"store-not-injective:{buf}"
        for fs in store_forms:
            for _, f in forms:
                if f == fs:
                    continue  # identical form: the per-lane slot
                if may_alias(f, fs):
                    return None, f"may-alias:{buf}"

    tiled = set()
    for buf, forms in per_buf.items():
        if buffer_lens is None or buffer_lens.get(buf) != N:
            continue
        ok = True
        for _, f in forms:
            dec = None if f is None else _decompose(f, kinds, uniform, T)
            if dec != (1, T, False) or f.const != 0:
                ok = False
                break
        if ok:
            tiled.add(buf)

    def rw(op: ir.Op):
        if op.opcode in (ir.LD_GLOBAL, ir.ST_GLOBAL):
            mode = "tiled" if op.args[0] in tiled else "gather"
            oc = ir.BLOCK_LD if op.opcode == ir.LD_GLOBAL else ir.BLOCK_ST
            return ir.Op(oc, op.dest, op.args,
                         {"block": int(block), "mode": mode})
        return op

    plan = BlockPlan(stmts=tuple(ir.rewrite_body(list(stmts), rw)),
                     tiled=frozenset(tiled), block=int(block),
                     grid=N // int(block))
    return plan, None
