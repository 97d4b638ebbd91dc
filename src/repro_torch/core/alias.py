"""May-alias analysis over hetIR memory operations.

The pass pipeline needs an alias story before it may move *memory* ops:
``hoist_invariant_loads`` (:mod:`~repro_torch.core.passes`) moves provably
loop-invariant ``LD_GLOBAL``/``LD_SHARED`` ops out of loops, which is only
sound when no store inside the loop may write the loaded address.  This
module answers that question with two rules, mirroring the memory model
hetIR inherits from the paper's abstract device:

* **Distinct buffers never alias.**  A hetIR pointer parameter names a
  whole allocation; two different buffer names (or the global space versus
  the per-block shared scratchpad) are disjoint by construction.

* **Same-buffer accesses are compared via affine index forms.**  Every
  i32/u32 register is (best-effort) summarized as an affine expression
  ``Σ coeff_i · base_i + const`` over *opaque base* registers — the same
  index terms the value-numbering pass keys on, here made explicit.  Two
  accesses whose forms share an identical base/coefficient multiset differ
  only by a constant ``delta``; the addresses of any two threads then
  differ by ``Σ coeff_i · (base_i(t) − base_i(s))``, a multiple of
  ``g = 2^(min trailing zeros of the coefficients)``.  If
  ``delta mod g ≠ 0`` the accesses can never collide — **for any pair of
  threads**, which is what makes the rule sound under SPMD execution
  (per-thread disjointness alone would miss thread ``t`` hitting thread
  ``s``'s slot).  Restricting ``g`` to the power-of-two part of the gcd
  keeps the argument valid under i32/u32 wraparound: ``g`` divides
  ``2^32``, so congruence mod ``g`` survives any number of wraps.

Everything else is a conservative *may alias*: forms with different base
sets, non-affine indices (``MOD``/``SHR``/loads/selects become opaque
bases), multi-def registers, or bases the caller marks unstable (defined
inside the loop under analysis, e.g. the loop variable — their values
differ between the iteration that stores and the iteration that loads,
so base cancellation would be wrong).

hetIR programs are required to keep indices in bounds (out-of-range
access is undefined behaviour), so "different index value" is the same
statement as "different address" — the analysis never needs buffer
extents.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import hetir as ir

#: memory spaces an access can live in (shared is one pseudo-buffer per
#: block; the per-block separation only makes the verdicts conservative)
GLOBAL_SPACE = "global"
SHARED_SPACE = "shared"

#: the single pseudo-buffer name of the shared scratchpad
SHARED_BUF = "__shared__"


@dataclass(frozen=True)
class AffineIndex:
    """``Σ coeff·base + const`` with sorted, coeff≠0 terms."""

    terms: Tuple[Tuple[str, int], ...]
    const: int

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        parts = [f"{c}*%{b}" for b, c in self.terms]
        return " + ".join(parts + [str(self.const)]) or "0"


def _make(terms: Dict[str, int], const: int) -> AffineIndex:
    return AffineIndex(tuple(sorted((b, c) for b, c in terms.items()
                                    if c != 0)), int(const))


def _combine(a: AffineIndex, b: AffineIndex, sign: int) -> AffineIndex:
    terms = dict(a.terms)
    for base, coeff in b.terms:
        terms[base] = terms.get(base, 0) + sign * coeff
    return _make(terms, a.const + sign * b.const)


def _scale(a: AffineIndex, k: int) -> Optional[AffineIndex]:
    if k == 0:
        return AffineIndex((), 0)
    return _make({b: c * k for b, c in a.terms}, a.const * k)


def affine_env(body: Sequence[ir.Stmt]) -> Dict[str, AffineIndex]:
    """Affine form per *single-def* integer register in ``body``.

    Opaque ops (memory loads, identity ops, divisions, …) contribute their
    dest as a fresh base term; multi-def registers (``Builder.assign``
    targets) are excluded entirely — their value depends on the program
    point, so they can never participate in base cancellation.  The walk is
    program-order, which SSA-style construction makes sufficient: an arg
    defined later (impossible for a value actually read) simply falls back
    to an opaque base.
    """
    defs = ir.reg_def_counts(body)
    env: Dict[str, AffineIndex] = {}

    def base_of(reg: ir.Reg) -> Optional[AffineIndex]:
        f = env.get(reg.name)
        if f is not None:
            return f
        if defs.get(reg.name, 0) != 1:
            return None
        return AffineIndex(((reg.name, 1),), 0)

    def const_val(a) -> Optional[int]:
        if isinstance(a, ir.Reg):
            f = env.get(a.name)
            if f is not None and not f.terms:
                return f.const
            return None
        try:
            v = int(a)
        except (TypeError, ValueError, OverflowError):
            return None
        return v if v == a else None

    for op in ir.walk_ops(body):
        d = op.dest
        if d is None or d.dtype not in (ir.I32, ir.U32) \
                or defs.get(d.name, 0) != 1:
            continue
        form: Optional[AffineIndex] = None
        if op.opcode == ir.CONST:
            c = const_val(op.args[0])
            if c is not None:
                form = AffineIndex((), c)
        elif op.opcode in (ir.ADD, ir.SUB):
            a = _arg_form(op.args[0], base_of, const_val)
            b = _arg_form(op.args[1], base_of, const_val)
            if a is not None and b is not None:
                form = _combine(a, b, 1 if op.opcode == ir.ADD else -1)
        elif op.opcode == ir.MUL:
            for x, c in ((op.args[0], const_val(op.args[1])),
                         (op.args[1], const_val(op.args[0]))):
                if c is None:
                    continue
                xf = _arg_form(x, base_of, const_val)
                if xf is not None:
                    form = _scale(xf, c)
                    break
        elif op.opcode == ir.SHL:
            k = const_val(op.args[1])
            if k is not None and 0 <= k < 32:
                xf = _arg_form(op.args[0], base_of, const_val)
                if xf is not None:
                    form = _scale(xf, 1 << k)
        elif op.opcode == ir.MOV:
            form = _arg_form(op.args[0], base_of, const_val)
        if form is not None:
            env[d.name] = form
        # anything else: d stays out of env and becomes an opaque base at
        # its uses (base_of), which is exactly the conservative choice
    return env


def _arg_form(a, base_of, const_val) -> Optional[AffineIndex]:
    if isinstance(a, ir.Reg):
        return base_of(a)
    c = const_val(a)
    return None if c is None else AffineIndex((), c)


def index_form(idx, env: Dict[str, AffineIndex],
               defs: Dict[str, int]) -> Optional[AffineIndex]:
    """Affine form of a memory op's index operand (Reg or immediate), or
    ``None`` when nothing sound can be said."""
    if isinstance(idx, ir.Reg):
        f = env.get(idx.name)
        if f is not None:
            return f
        if defs.get(idx.name, 0) == 1:
            return AffineIndex(((idx.name, 1),), 0)
        return None
    try:
        return AffineIndex((), int(idx))
    except (TypeError, ValueError, OverflowError):
        return None


def _pow2_gcd(coeffs) -> int:
    """Largest power of two dividing every coefficient (capped at 2^31) —
    the wrap-safe part of the gcd (see module docstring)."""
    shift = 32
    for c in coeffs:
        c = abs(int(c))
        if c == 0:
            continue
        shift = min(shift, (c & -c).bit_length() - 1)
    return 1 << min(shift, 31)


def injective_step(coeff: int, span: int) -> bool:
    """Is ``i -> coeff * i`` injective over ``i in [0, span)`` under i32/u32
    wraparound?  ``coeff * (i - j) ≡ 0 (mod 2^32)`` requires ``i - j`` to be
    a multiple of ``2^(32 - tz(coeff))`` (``tz`` = trailing zero count), so
    injectivity holds exactly when ``span`` does not reach that multiple.
    This is the wrap-safe leg of the lane-independence proof
    (:func:`repro_torch.core.passes.block_lower`): a store whose index is
    ``coeff · global_id + uniform`` hits a distinct element per thread —
    for *any* two threads — whenever this returns True."""
    coeff = abs(int(coeff))
    if coeff == 0:
        return span <= 1
    tz = (coeff & -coeff).bit_length() - 1
    if tz >= 32:
        return span <= 1
    return span <= (1 << (32 - tz))


def may_alias(a: Optional[AffineIndex], b: Optional[AffineIndex],
              stable: Callable[[str], bool] = lambda name: True) -> bool:
    """May two same-buffer accesses with index forms ``a`` and ``b``
    touch the same element — for *any* pair of executing threads?

    ``stable(base)`` must return True only when the base register holds a
    single value for the whole window under analysis (e.g. it is defined
    outside the loop a hoist is considered for).  Unstable bases defeat
    cancellation and force a conservative True.
    """
    if a is None or b is None:
        return True
    if any(not stable(base) for base, _ in a.terms + b.terms):
        return True
    if dict(a.terms) != dict(b.terms):
        return True  # different base sets: no disjointness argument
    delta = b.const - a.const
    if not a.terms:
        return delta % (1 << 32) == 0  # two absolute (wrapped) addresses
    if delta == 0:
        return True  # identical per-thread address (and t==s collides)
    return delta % _pow2_gcd(c for _, c in a.terms) == 0


def body_mem_accesses(body: Sequence[ir.Stmt]
                      ) -> Tuple[List[Tuple[str, str, object]],
                                 List[Tuple[str, str, object]]]:
    """All (space, buffer, index operand) memory reads and writes in
    ``body``, recursively (``ATOMIC_ADD`` is both)."""
    reads: List[Tuple[str, str, object]] = []
    writes: List[Tuple[str, str, object]] = []

    def walk(stmts: Sequence[ir.Stmt]) -> None:
        for s in stmts:
            if isinstance(s, ir.Op):
                if s.opcode == ir.LD_GLOBAL:
                    reads.append((GLOBAL_SPACE, s.args[0], s.args[1]))
                elif s.opcode == ir.ST_GLOBAL:
                    writes.append((GLOBAL_SPACE, s.args[0], s.args[1]))
                elif s.opcode == ir.ATOMIC_ADD:
                    reads.append((GLOBAL_SPACE, s.args[0], s.args[1]))
                    writes.append((GLOBAL_SPACE, s.args[0], s.args[1]))
                elif s.opcode == ir.LD_SHARED:
                    reads.append((SHARED_SPACE, SHARED_BUF, s.args[0]))
                elif s.opcode == ir.ST_SHARED:
                    writes.append((SHARED_SPACE, SHARED_BUF, s.args[0]))
            elif isinstance(s, (ir.Pred, ir.Loop)):
                walk(s.body)

    walk(body)
    return reads, writes
