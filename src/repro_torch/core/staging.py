"""Which global loads of a segment the scalar CUDA kernel stages in shared
memory — decided at translation, in Python, so that the CPU tests can ask.

A scalar segment kernel runs one CUDA thread per hetIR lane.  A load in a
loop such as ``attn_decode``'s QK product, ``K[row * D + d]`` with ``row``
the lane's key row, makes the 32 lanes of a warp read 32 addresses ``D``
elements apart at every step: 32 memory transactions for 128 bytes of
data, in a chain of dependent steps.  When the load's footprint for one
hetIR block is a window of the buffer known before the loop starts, the
threads copy that window into shared memory once — neighbouring threads on
neighbouring 16-byte chunks, by ``cp.async`` — and the loop reads the copy.

A ``LD_GLOBAL`` is staged when all of these hold:

* the segment does not write its buffer (``seg.gwrites``), so no thread of
  any block changes the window while the segment runs, and the buffer's
  elements are 4 bytes wide;
* it sits inside a loop of static trip count (the *nest*: the innermost
  enclosing loops of the segment whose counts are integers);
* its index is affine (:func:`~repro_torch.core.alias.affine_env`) in the
  lane id (thread or global id), the nest's loop variables, and registers
  that are block-uniform and not redefined inside the nest;
* the loop terms alone fit the budget :data:`STAGE_BUDGET_BYTES` (the lane
  term depends on the block size, which only the launch knows: a launch
  whose window does not fit reads the buffer directly).

Everything else is refused with a reason.  Whatever the verdict, the value
each lane reads is the same: the kernel stages element ``w + k`` of the
window as ``het_ld`` would load it (a negative index counts from the end,
an index out of range reads 0) and reads the copy only for an index inside
the window that thread 0 computed, else the buffer itself — the analysis
decides speed, never a result.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple, Union

from . import hetir as ir
from .alias import affine_env, index_form
from .passes import _THREAD_BASES, _UNIFORM_PURE_OPS

#: shared memory the staged windows of one hetIR block may take
STAGE_BUDGET_BYTES = 96 * 1024
#: a lane stride that is a multiple of this many words puts every lane's
#: element in one bank: such windows get 4 words of padding per stride
BANKS = 32

#: ops whose value every lane of a block shares when their Reg arguments do
_BLOCK_UNIFORM_SEEDS = {ir.CONST, ir.LD_PARAM, ir.GET_BLOCK_DIM,
                        ir.GET_NUM_BLOCKS, ir.GET_BLOCK_ID}
#: ops whose value is affine in their arguments, or an argument-free
#: lane, block or constant value: a chain of them at the program's top level
#: computes the same value in every segment, so a segment that reads its
#: result from an earlier one may replay it
_REPLAYABLE = {ir.CONST, ir.GET_THREAD_ID, ir.GET_GLOBAL_ID, ir.GET_BLOCK_ID,
               ir.ADD, ir.SUB, ir.MUL, ir.SHL, ir.MOV}
#: the buffer element types a window may hold (16-byte copies of 4 words)
_STAGE_DTYPES = (ir.F32, ir.I32, ir.U32)


@dataclass(frozen=True)
class StagedLoad:
    """A load whose window the kernel stages.  Its index is ``lane *
    lane_id + Σ coeff * loop var + Σ coeff * uniform register + block *
    block id + gid_block * (block id * block size) + const``."""

    #: position among the segment's ops (``hetir.walk_ops`` order)
    op: int
    buf: str
    nest: str                                #: outermost loop var of the nest
    lane: int
    loops: Tuple[Tuple[str, int, int], ...]  #: (loop var, coeff, trip count)
    uniform: Tuple[Tuple[str, int], ...]     #: (register, coeff)
    block: int
    gid_block: int
    const: int

    def offsets(self, block_size: int) -> Tuple[int, int]:
        """Lowest and highest offset of the window from the uniform part."""
        lo = hi = 0
        for c, n in [(self.lane, block_size)] + \
                [(c, n) for _, c, n in self.loops]:
            lo += min(0, c * (n - 1))
            hi += max(0, c * (n - 1))
        return lo, hi

    def row(self) -> int:
        """Words per padded row: the lane stride when it is a multiple of
        the bank count, else 0 (no padding)."""
        r = abs(self.lane)
        return r if r and r % BANKS == 0 else 0

    def words(self, block_size: int) -> int:
        """Shared words of the window at ``block_size`` lanes: the span
        rounded out to 16-byte chunks, plus 4 words per padded row."""
        lo, hi = self.offsets(block_size)
        n = -(-(hi - lo + 1 + 3) // 4) * 4
        r = self.row()
        return n + (4 * -(-n // r) if r else 0)


@dataclass(frozen=True)
class Refusal:
    op: int
    buf: str
    reason: str


Verdict = Union[StagedLoad, Refusal]


def _program_facts(prog: ir.Program):
    """Per register of the whole program: its single defining op (when it
    has one and it is not under a predicate), whether that op sits at the
    program's top level, and whether the register is block-uniform (every
    lane of a block holds the same value wherever it is read)."""
    defs = ir.reg_def_counts(prog.body)
    top_def: Dict[str, ir.Op] = {}
    top_level = set()
    loop_vars = set()

    def walk(body, in_pred, nested):
        for s in body:
            if isinstance(s, ir.Op):
                if s.dest is not None and not in_pred \
                        and defs.get(s.dest.name) == 1:
                    top_def[s.dest.name] = s
                    if not nested:
                        top_level.add(s.dest.name)
            elif isinstance(s, ir.Pred):
                walk(s.body, True, True)
            elif isinstance(s, ir.Loop):
                if not in_pred and defs.get(s.var.name) == 1:
                    loop_vars.add(s.var.name)
                walk(s.body, in_pred, True)

    walk(prog.body, False, False)
    uniform = set(loop_vars)
    changed = True
    while changed:
        changed = False
        for name, op in top_def.items():
            if name in uniform:
                continue
            if op.opcode in _BLOCK_UNIFORM_SEEDS or (
                    op.opcode in _UNIFORM_PURE_OPS
                    and all(a.name in uniform for a in op.arg_regs())):
                uniform.add(name)
                changed = True
    return top_def, top_level, uniform


def segment_prelude(stmts: Sequence[ir.Stmt], prog: ir.Program) -> list:
    """Definitions to put in front of a segment's statements for its
    affine forms, one chain per register the segment reads without
    defining it: the ops that computed it, when they form a chain of
    :data:`_REPLAYABLE` ops at the program's top level (so every lane
    computed it, and from nothing but lane and block ids and constants);
    else an opaque definition (a base of its own).  For analysis only:
    nothing of it is emitted."""
    top_def, top_level, _ = _program_facts(prog)
    own = ir.reg_def_counts(stmts)
    used = {r.name for op in ir.walk_ops(stmts) for r in op.arg_regs()}
    # where each top-level statement of the program starts, so that only
    # definitions ahead of the segment are replayed
    at: Dict[int, int] = {}
    for i, s in enumerate(prog.body):
        for op in ir.walk_ops([s]):
            at[id(op)] = i
    first = next(iter(ir.walk_ops(stmts)), None)
    start = at.get(id(first), -1)
    closed: Dict[str, bool] = {}

    def is_closed(name: str) -> bool:
        if name not in closed:
            closed[name] = False          # no cycles through a def
            op = top_def.get(name)
            closed[name] = op is not None and name in top_level \
                and at[id(op)] < start and op.opcode in _REPLAYABLE \
                and all(is_closed(a.name) for a in op.arg_regs())
        return closed[name]

    chain: List[ir.Op] = []

    def replay(name: str) -> None:
        op = top_def[name]
        for a in op.arg_regs():
            replay(a.name)
        if op not in chain:
            chain.append(op)

    opaque = []
    for name in sorted(used - set(own)):
        if is_closed(name):
            replay(name)
        elif name in top_def:
            d = top_def[name].dest
            opaque.append(ir.Op(ir.MOD, d, (d, d)))
    return opaque + chain


def _defined(stmts) -> set:
    out = set()
    for s in stmts:
        if isinstance(s, ir.Op) and s.dest is not None:
            out.add(s.dest.name)
        elif isinstance(s, ir.Loop):
            out.add(s.var.name)
            out |= _defined(s.body)
        elif isinstance(s, ir.Pred):
            out |= _defined(s.body)
    return out


def plan_staging(stmts: Sequence[ir.Stmt], prog: ir.Program,
                 gwrites) -> List[Verdict]:
    """The verdict on every ``LD_GLOBAL`` of a segment (its statements and
    written buffers), in program order.  The footprint is checked for the
    loops alone; :func:`stage_layout` checks it at the launch's block
    size."""
    top_def, _, uniform = _program_facts(prog)
    prelude = segment_prelude(stmts, prog)
    seen = {r.name for op in ir.walk_ops(stmts) for r in op.arg_regs()} \
        | _defined(stmts)
    body = prelude + list(stmts)
    env = affine_env(body)
    defs = ir.reg_def_counts(body)
    kinds = {op.dest.name: _THREAD_BASES[op.opcode]
             for op in ir.walk_ops(body)
             if op.opcode in _THREAD_BASES and defs.get(op.dest.name) == 1
             and op.dest.name in top_def}
    verdicts: List[Verdict] = []
    n_op = [0]

    def visit(stmts, nest: List[ir.Loop]):
        for s in stmts:
            if isinstance(s, ir.Op):
                if s.opcode == ir.LD_GLOBAL:
                    verdicts.append(_verdict(s, n_op[0], nest))
                n_op[0] += 1
            elif isinstance(s, ir.Pred):
                visit(s.body, nest)
            elif isinstance(s, ir.Loop):
                visit(s.body, nest + [s] if isinstance(s.count, int) else [])

    def _verdict(op: ir.Op, pos: int, nest: List[ir.Loop]) -> Verdict:
        buf, idx = op.args[0], op.args[1]
        if buf in gwrites:
            return Refusal(pos, buf, "the segment writes the buffer")
        if prog.param(buf).dtype not in _STAGE_DTYPES:
            return Refusal(pos, buf, "1-byte elements")
        if not nest:
            return Refusal(pos, buf, "not in a loop of static trip count")
        if any(int(lp.count) < 1 for lp in nest):
            return Refusal(pos, buf, "a loop of the nest never runs")
        form = index_form(idx, env, defs)
        if form is None:
            return Refusal(pos, buf, "non-affine index")
        inside = _defined(nest[0].body) | {nest[0].var.name}
        trips = {lp.var.name: int(lp.count) for lp in nest}
        lane = block = gid_block = 0
        loops, unis = [], []
        for base, c in form.terms:
            kind = kinds.get(base)
            if kind == "tid":
                lane += c
            elif kind == "gid":
                lane += c
                gid_block += c
            elif kind == "bid":
                block += c
            elif base in trips:
                loops.append((base, c, trips[base]))
            elif base in uniform and base not in inside \
                    and defs.get(base) == 1 and base in seen:
                unis.append((base, c))
            else:
                return Refusal(pos, buf, "non-affine index")
        staged = StagedLoad(pos, buf, nest[0].var.name, lane, tuple(loops),
                            tuple(unis), block, gid_block, form.const)
        if staged.words(1) * 4 > STAGE_BUDGET_BYTES:
            return Refusal(pos, buf, "footprint over the shared-memory "
                                     "budget")
        return staged

    visit(stmts, [])
    return verdicts


def staged_loads(verdicts: Sequence[Verdict]) -> List[StagedLoad]:
    return [v for v in verdicts if isinstance(v, StagedLoad)]


def stage_layout(loads: Sequence[StagedLoad],
                 block_size: int) -> List[Tuple[bool, int, int]]:
    """``(staged, word offset, words)`` of each window at ``block_size``
    lanes: windows in order, each taken while the total fits the budget.
    The generated kernel computes the same from its block size."""
    out, used = [], 0
    for ld in loads:
        w = ld.words(block_size)
        on = (used + w) * 4 <= STAGE_BUDGET_BYTES
        out.append((on, used, w))
        used += w if on else 0
    return out


def stage_words(loads: Sequence[StagedLoad], block_size: int) -> int:
    """Shared words the staging of a segment takes at ``block_size``
    lanes: each window's start and length (two 8-byte words, 16 bytes)
    and the windows that fit."""
    return 4 * len(loads) + sum(
        w for on, _, w in stage_layout(loads, block_size) if on)
