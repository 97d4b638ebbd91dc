"""hetIR — the architecture-neutral SPMD kernel IR from the HetGPU paper.

A hetIR :class:`Program` describes a kernel in the paper's SPMD model:

* a grid of *blocks*, each of *block_size* threads — no warp size is baked in
  (the paper's key IR property);
* explicit predication (``@PRED`` regions) instead of implicit SIMT masks;
* explicit ``BARRIER`` synchronization points — these are the only places the
  runtime may capture state (the paper's "safe suspension points");
* abstract memory spaces: ``LD/ST_GLOBAL`` (device DRAM) and ``LD/ST_SHARED``
  (per-block scratchpad);
* virtualized collective intrinsics (``VOTE_*``, ``SHUFFLE``, ``REDUCE_ADD``,
  ``ATOMIC_ADD``) defined over the *currently active* threads of a block.

Programs are SSA: every register is assigned exactly once per dynamic
execution of its defining op.  Loops carry values through registers that are
re-assigned each iteration at the engine level (the register *file* is the
unit of state capture, exactly as in the paper's snapshot design).

The IR is deliberately small but complete enough to express the paper's
evaluation suite (vector add, SAXPY, tiled matmul with shared memory,
reduction, inclusive scan, ballot/bitcount, Monte-Carlo pi with divergence
and atomics, persistent iterative kernels).
"""
from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

# --------------------------------------------------------------------------
# Types
# --------------------------------------------------------------------------

F32 = "f32"
I32 = "i32"
U32 = "u32"
BOOL = "bool"

_NP_DTYPES = {
    F32: np.float32,
    I32: np.int32,
    U32: np.uint32,
    BOOL: np.bool_,
}


def np_dtype(t: str) -> np.dtype:
    return np.dtype(_NP_DTYPES[t])


def ir_dtype(dt) -> str:
    """Normalize a dtype spec (hetIR code like ``"f32"``, numpy dtype, or
    anything ``np.dtype`` accepts) to the hetIR dtype code."""
    if isinstance(dt, str) and dt in _NP_DTYPES:
        return dt
    npdt = np.dtype(dt)
    for code, npt in _NP_DTYPES.items():
        if np.dtype(npt) == npdt:
            return code
    raise TypeError(f"no hetIR dtype for {dt!r} "
                    f"(supported: {sorted(_NP_DTYPES)})")


# --------------------------------------------------------------------------
# Parameters (kernel arguments)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Ptr:
    """A pointer kernel argument — a named global-memory buffer."""

    name: str
    dtype: str = F32


@dataclass(frozen=True)
class Scalar:
    """A scalar kernel argument (uniform across all threads)."""

    name: str
    dtype: str = I32


Param = Union[Ptr, Scalar]


# --------------------------------------------------------------------------
# Registers and ops
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Reg:
    """An SSA virtual register.  Per-thread unless ``uniform`` is True."""

    name: str
    dtype: str
    uniform: bool = False

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"%{self.name}:{self.dtype}"


# Opcodes ------------------------------------------------------------------
# thread identity
GET_GLOBAL_ID = "GET_GLOBAL_ID"
GET_BLOCK_ID = "GET_BLOCK_ID"
GET_THREAD_ID = "GET_THREAD_ID"
GET_BLOCK_DIM = "GET_BLOCK_DIM"
GET_NUM_BLOCKS = "GET_NUM_BLOCKS"
# constants / moves
CONST = "CONST"
MOV = "MOV"
CVT = "CVT"
# arithmetic (dtype of dest decides int/float semantics)
ADD = "ADD"
SUB = "SUB"
MUL = "MUL"
DIV = "DIV"
MOD = "MOD"
FMA = "FMA"
MIN = "MIN"
MAX = "MAX"
NEG = "NEG"
ABS = "ABS"
SQRT = "SQRT"
EXP = "EXP"
# bitwise / logical
AND = "AND"
OR = "OR"
XOR = "XOR"
NOT = "NOT"
SHL = "SHL"
SHR = "SHR"
# comparisons -> bool
LT = "LT"
LE = "LE"
GT = "GT"
GE = "GE"
EQ = "EQ"
NE = "NE"
SELECT = "SELECT"
# memory
LD_GLOBAL = "LD_GLOBAL"
ST_GLOBAL = "ST_GLOBAL"
LD_SHARED = "LD_SHARED"
ST_SHARED = "ST_SHARED"
LD_PARAM = "LD_PARAM"
# collectives (over active threads of the block)
VOTE_ANY = "VOTE_ANY"
VOTE_ALL = "VOTE_ALL"
VOTE_BALLOT = "VOTE_BALLOT"  # popcount of active threads with pred true
SHUFFLE = "SHUFFLE"  # read val from lane index (block-relative)
REDUCE_ADD = "REDUCE_ADD"  # block-wide sum broadcast to all active threads
REDUCE_MAX = "REDUCE_MAX"
SCAN_ADD = "SCAN_ADD"  # inclusive prefix-sum over lanes of the block
ATOMIC_ADD = "ATOMIC_ADD"  # global-memory atomic add, returns old value
# block primitives (Triton-style): the form lane-independent segments are
# rewritten into by passes.block_lower before the pallas fast path consumes
# them.  Same (buf, idx[, val]) operands as LD_GLOBAL/ST_GLOBAL; attrs carry
# the constexpr tile geometry chosen at translate time:
#   attrs["block"] — constexpr BLOCK size (elements per grid step),
#   attrs["mode"]  — "tiled" (index is exactly the flat global id; the
#                    buffer is BlockSpec-tiled and the index rebased to the
#                    tile) or "gather" (arbitrary proven-disjoint affine
#                    index; the buffer is staged whole and masked-gathered).
# Stores are always masked (predication masks + mode="drop" writes), so a
# partially-active tile never writes out of its proven footprint.
BLOCK_LD = "BLOCK_LD"
BLOCK_ST = "BLOCK_ST"

ALU_UNARY = {NEG, ABS, SQRT, EXP, NOT, MOV}
ALU_BINARY = {ADD, SUB, MUL, DIV, MOD, MIN, MAX, AND, OR, XOR, SHL, SHR}
CMP_OPS = {LT, LE, GT, GE, EQ, NE}
COLLECTIVE_OPS = {VOTE_ANY, VOTE_ALL, VOTE_BALLOT, SHUFFLE, REDUCE_ADD,
                  REDUCE_MAX, SCAN_ADD}
BLOCK_OPS = {BLOCK_LD, BLOCK_ST}


@dataclass(frozen=True)
class Op:
    """A single hetIR instruction."""

    opcode: str
    dest: Optional[Reg]
    args: Tuple[Any, ...] = ()  # Regs, immediates, or param/buffer names
    attrs: Dict[str, Any] = field(default_factory=dict)

    def arg_regs(self) -> List[Reg]:
        return [a for a in self.args if isinstance(a, Reg)]


# --------------------------------------------------------------------------
# Structured statements
# --------------------------------------------------------------------------


@dataclass
class Pred:
    """``@PRED(cond) { body }`` — the paper's explicit predication region.

    On SIMT backends this becomes a hardware exec-mask; on MIMD backends a
    per-thread branch.  Barriers are NOT allowed inside (CUDA-like rule, and
    required for the paper's barrier-anchored state capture to be sound).
    """

    cond: Reg
    body: List["Stmt"]


@dataclass
class Loop:
    """A counted loop.  ``count`` is a uniform scalar (param name or int).

    ``var`` is re-assigned with the iteration index at the top of every
    iteration.  Barriers ARE allowed at the loop body's top level — the
    engine segments through them, which is how the paper migrates
    long-running iterative kernels ("insert a global barrier every X
    iterations of a loop to create segments").
    """

    var: Reg
    count: Union[str, int]
    body: List["Stmt"]


@dataclass
class Barrier:
    """Block-wide barrier and safe suspension point."""

    label: str = ""


Stmt = Union[Op, Pred, Loop, Barrier]


# --------------------------------------------------------------------------
# Program
# --------------------------------------------------------------------------


@dataclass
class Program:
    name: str
    params: List[Param]
    body: List[Stmt]
    shared_size: int = 0  # elements of shared memory per block
    shared_dtype: str = F32

    def param(self, name: str) -> Param:
        for p in self.params:
            if p.name == name:
                return p
        raise KeyError(name)

    def buffers(self) -> List[Ptr]:
        return [p for p in self.params if isinstance(p, Ptr)]

    def scalars(self) -> List[Scalar]:
        return [p for p in self.params if isinstance(p, Scalar)]

    def validate(self) -> None:
        """Check structural invariants (SSA-ish, barrier placement)."""
        _validate_body(self.body, in_pred=False)

    # -- pretty printing (the paper shows textual hetIR assembly) ----------
    def to_text(self) -> str:
        lines = [f".func {self.name}(" + ", ".join(
            (f"%rd<1> %{p.name}" if isinstance(p, Ptr) else f"%{p.dtype} %{p.name}")
            for p in self.params) + ")", "{"]
        if self.shared_size:
            lines.append(f"  .shared .{self.shared_dtype} [{self.shared_size}];")
        _fmt_body(self.body, lines, indent=1)
        lines.append("}")
        return "\n".join(lines)


def _fmt_body(body: Sequence[Stmt], lines: List[str], indent: int) -> None:
    pad = "  " * indent
    for s in body:
        if isinstance(s, Op):
            dest = f"%{s.dest.name} = " if s.dest is not None else ""
            args = ", ".join(
                f"%{a.name}" if isinstance(a, Reg) else str(a) for a in s.args)
            attrs = f" {s.attrs}" if s.attrs else ""
            lines.append(f"{pad}{dest}{s.opcode} {args}{attrs}")
        elif isinstance(s, Pred):
            lines.append(f"{pad}@PRED(%{s.cond.name}) {{")
            _fmt_body(s.body, lines, indent + 1)
            lines.append(f"{pad}}}")
        elif isinstance(s, Loop):
            lines.append(f"{pad}LOOP %{s.var.name} < {s.count} {{")
            _fmt_body(s.body, lines, indent + 1)
            lines.append(f"{pad}}}")
        elif isinstance(s, Barrier):
            lines.append(f"{pad}BAR.SHARED  // {s.label}")


def _validate_body(body: Sequence[Stmt], in_pred: bool) -> None:
    for s in body:
        if isinstance(s, Barrier) and in_pred:
            raise ValueError("BARRIER inside @PRED region is illegal in hetIR")
        if isinstance(s, Pred):
            _validate_body(s.body, in_pred=True)
        if isinstance(s, Loop):
            if in_pred and _contains_barrier(s.body):
                raise ValueError("Loop with barrier inside @PRED is illegal")
            _validate_body(s.body, in_pred=in_pred)


def _contains_barrier(body: Sequence[Stmt]) -> bool:
    for s in body:
        if isinstance(s, Barrier):
            return True
        if isinstance(s, (Pred, Loop)) and _contains_barrier(s.body):
            return True
    return False


# --------------------------------------------------------------------------
# Builder — the "compiler frontend" convenience layer
# --------------------------------------------------------------------------


class _Ctx:
    def __init__(self, builder: "Builder", stmts: List[Stmt]):
        self.builder = builder
        self.stmts = stmts

    def __enter__(self):
        self.builder._stack.append(self.stmts)
        return self

    def __exit__(self, *exc):
        self.builder._stack.pop()
        return False


class Value:
    """Builder-level handle around a :class:`Reg` with operator sugar."""

    __slots__ = ("reg", "b")
    __array_priority__ = 1000  # beat numpy scalars in mixed expressions

    def __init__(self, reg: Reg, b: "Builder"):
        self.reg = reg
        self.b = b

    # arithmetic sugar ------------------------------------------------------
    def _bin(self, opcode: str, other, rdtype: Optional[str] = None,
             swap: bool = False) -> "Value":
        o = self.b._coerce(other, self.reg.dtype)
        a, c = (o, self) if swap else (self, o)
        dt = rdtype or self.reg.dtype
        return self.b._emit(opcode, dt, a.reg, c.reg)

    def __add__(self, o):
        return self._bin(ADD, o)

    __radd__ = __add__

    def __sub__(self, o):
        return self._bin(SUB, o)

    def __rsub__(self, o):
        return self._bin(SUB, o, swap=True)

    def __mul__(self, o):
        return self._bin(MUL, o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._bin(DIV, o)

    def __mod__(self, o):
        return self._bin(MOD, o)

    def __and__(self, o):
        return self._bin(AND, o)

    def __or__(self, o):
        return self._bin(OR, o)

    def __xor__(self, o):
        return self._bin(XOR, o)

    def __lshift__(self, o):
        return self._bin(SHL, o)

    def __rshift__(self, o):
        return self._bin(SHR, o)

    def __neg__(self):
        return self.b._emit(NEG, self.reg.dtype, self.reg)

    # comparisons -> bool values
    def __lt__(self, o):
        return self._bin(LT, o, rdtype=BOOL)

    def __le__(self, o):
        return self._bin(LE, o, rdtype=BOOL)

    def __gt__(self, o):
        return self._bin(GT, o, rdtype=BOOL)

    def __ge__(self, o):
        return self._bin(GE, o, rdtype=BOOL)

    def eq(self, o):
        return self._bin(EQ, o, rdtype=BOOL)

    def ne(self, o):
        return self._bin(NE, o, rdtype=BOOL)

    def astype(self, dtype: str) -> "Value":
        return self.b._emit(CVT, dtype, self.reg)


class Builder:
    """Builds a hetIR :class:`Program` (plays the role of the paper's
    Clang→hetIR frontend for hand-written kernels)."""

    def __init__(self, name: str, params: Sequence[Param],
                 shared_size: int = 0, shared_dtype: str = F32):
        self.program = Program(name=name, params=list(params), body=[],
                               shared_size=shared_size,
                               shared_dtype=shared_dtype)
        self._stack: List[List[Stmt]] = [self.program.body]
        self._counter = 0
        # scalar params become uniform registers on first use
        self._param_vals: Dict[str, Value] = {}

    # -- plumbing -----------------------------------------------------------
    def _fresh(self, dtype: str, hint: str = "t", uniform: bool = False) -> Reg:
        self._counter += 1
        return Reg(f"{hint}{self._counter}", dtype, uniform)

    def _push(self, stmt: Stmt) -> None:
        self._stack[-1].append(stmt)

    def _emit(self, opcode: str, dtype: Optional[str], *args,
              uniform: bool = False, **attrs) -> Optional[Value]:
        dest = self._fresh(dtype, hint=opcode.lower()[:3]) if dtype else None
        self._push(Op(opcode, dest, tuple(
            a.reg if isinstance(a, Value) else a for a in args), dict(attrs)))
        return Value(dest, self) if dest is not None else None

    def _coerce(self, v, dtype: str) -> Value:
        if isinstance(v, Value):
            return v
        return self.const(v, dtype)

    # -- public op API ------------------------------------------------------
    def const(self, v, dtype: str = None) -> Value:
        if dtype is None:
            dtype = F32 if isinstance(v, float) else I32
        return self._emit(CONST, dtype, v)

    def param(self, name: str) -> Value:
        """Load a uniform scalar parameter into a register."""
        if name not in self._param_vals:
            p = self.program.param(name)
            assert isinstance(p, Scalar), f"{name} is not a scalar param"
            val = self._emit(LD_PARAM, p.dtype, name)
            self._param_vals[name] = val
        return self._param_vals[name]

    def global_id(self, dim: int = 0) -> Value:
        return self._emit(GET_GLOBAL_ID, I32, dim)

    def block_id(self) -> Value:
        return self._emit(GET_BLOCK_ID, I32)

    def thread_id(self) -> Value:
        return self._emit(GET_THREAD_ID, I32)

    def block_dim(self) -> Value:
        return self._emit(GET_BLOCK_DIM, I32)

    def num_blocks(self) -> Value:
        return self._emit(GET_NUM_BLOCKS, I32)

    def load(self, buf: str, idx: Value) -> Value:
        p = self.program.param(buf)
        assert isinstance(p, Ptr)
        return self._emit(LD_GLOBAL, p.dtype, buf, idx)

    def store(self, buf: str, idx: Value, val: Value) -> None:
        self._emit(ST_GLOBAL, None, buf, idx, val)

    def load_shared(self, idx: Value) -> Value:
        return self._emit(LD_SHARED, self.program.shared_dtype, idx)

    def store_shared(self, idx: Value, val: Value) -> None:
        self._emit(ST_SHARED, None, idx, val)

    def select(self, cond: Value, a: Value, b: Value) -> Value:
        b_ = self._coerce(b, a.reg.dtype)
        return self._emit(SELECT, a.reg.dtype, cond, a, b_)

    def minimum(self, a: Value, b) -> Value:
        return a._bin(MIN, b)

    def maximum(self, a: Value, b) -> Value:
        return a._bin(MAX, b)

    def sqrt(self, a: Value) -> Value:
        return self._emit(SQRT, a.reg.dtype, a)

    def exp(self, a: Value) -> Value:
        return self._emit(EXP, a.reg.dtype, a)

    def abs(self, a: Value) -> Value:
        return self._emit(ABS, a.reg.dtype, a)

    def fma(self, a: Value, bv: Value, c: Value) -> Value:
        return self._emit(FMA, a.reg.dtype, a, bv, c)

    # collectives
    def vote_any(self, pred: Value) -> Value:
        return self._emit(VOTE_ANY, BOOL, pred)

    def vote_all(self, pred: Value) -> Value:
        return self._emit(VOTE_ALL, BOOL, pred)

    def ballot(self, pred: Value) -> Value:
        return self._emit(VOTE_BALLOT, I32, pred)

    def shuffle(self, val: Value, src_lane: Value) -> Value:
        return self._emit(SHUFFLE, val.reg.dtype, val, src_lane)

    def reduce_add(self, val: Value) -> Value:
        return self._emit(REDUCE_ADD, val.reg.dtype, val)

    def reduce_max(self, val: Value) -> Value:
        return self._emit(REDUCE_MAX, val.reg.dtype, val)

    def scan_add(self, val: Value) -> Value:
        return self._emit(SCAN_ADD, val.reg.dtype, val)

    def atomic_add(self, buf: str, idx: Value, val: Value) -> Value:
        p = self.program.param(buf)
        return self._emit(ATOMIC_ADD, p.dtype, buf, idx, val)

    # control structure
    def when(self, cond: Value) -> _Ctx:
        blk = Pred(cond.reg, [])
        self._push(blk)
        return _Ctx(self, blk.body)

    def loop(self, count: Union[str, int, Value], hint: str = "i"
             ) -> "_LoopCtx":
        if isinstance(count, Value):
            raise TypeError("loop count must be a scalar param name or int "
                            "(uniform), got a Value")
        var = self._fresh(I32, hint=hint, uniform=True)
        blk = Loop(var, count, [])
        self._push(blk)
        return _LoopCtx(self, blk)

    def barrier(self, label: str = "") -> None:
        self._push(Barrier(label))

    # mutable "accumulator" helper: hetIR is SSA, so loop-carried values are
    # modeled via shared or global memory, or via the engine's regfile when
    # re-assigned with .assign() below
    def assign(self, dst: Value, src: Value) -> None:
        """Overwrite dst's register with src (MOV).  Used for loop carries —
        the engine's regfile is mutable between segments, as in the paper."""
        self._push(Op(MOV, dst.reg, (src.reg,)))

    def var(self, init: Value, hint: str = "v") -> Value:
        """Declare a mutable loop-carried variable initialized to ``init``."""
        reg = self._fresh(init.reg.dtype, hint=hint)
        self._push(Op(MOV, reg, (init.reg,)))
        return Value(reg, self)

    def done(self) -> Program:
        self.program.validate()
        return self.program


class _LoopCtx(_Ctx):
    def __init__(self, builder: Builder, loop: Loop):
        super().__init__(builder, loop.body)
        self.loop = loop

    def __enter__(self):
        super().__enter__()
        return Value(self.loop.var, self.builder)


# --------------------------------------------------------------------------
# Liveness / def-use analysis (used by backends to build segment signatures)
# --------------------------------------------------------------------------


def body_defs_uses(body: Sequence[Stmt]) -> Tuple[List[Reg], List[Reg]]:
    """Registers defined in ``body`` and registers used before definition.

    Only *unconditional* defs (not nested under a @PRED or inside a
    possibly-zero-trip loop) shadow later uses: a predicated write leaves
    inactive threads reading the register's pre-segment value, so the
    register is genuinely live-in.  Treating conditional defs as sure defs
    made the engine prune such registers between segments — a divergent
    block then crashed (or, worse, silently merged against zeros) when a
    later segment read them.  Found by the differential fuzz harness."""
    defs: Dict[str, Reg] = {}
    sure: set = set()
    uses: Dict[str, Reg] = {}

    def walk(stmts: Sequence[Stmt], conditional: bool):
        for s in stmts:
            if isinstance(s, Op):
                for r in s.arg_regs():
                    if r.name not in sure and r.name not in uses:
                        uses[r.name] = r
                if s.dest is not None:
                    defs.setdefault(s.dest.name, s.dest)
                    if not conditional:
                        sure.add(s.dest.name)
            elif isinstance(s, Pred):
                if s.cond.name not in sure and s.cond.name not in uses:
                    uses[s.cond.name] = s.cond
                walk(s.body, True)
            elif isinstance(s, Loop):
                defs.setdefault(s.var.name, s.var)
                # a zero-trip loop defines nothing: body defs (and the
                # loop var itself) stay conditional
                walk(s.body, True)
            elif isinstance(s, Barrier):
                pass

    walk(body, False)
    return list(defs.values()), list(uses.values())


def body_global_accesses(body: Sequence[Stmt]) -> Tuple[set, set]:
    """Names of global buffers read / written in ``body``."""
    reads, writes = set(), set()

    def walk(stmts: Sequence[Stmt]):
        for s in stmts:
            if isinstance(s, Op):
                if s.opcode in (LD_GLOBAL, BLOCK_LD):
                    reads.add(s.args[0])
                elif s.opcode in (ST_GLOBAL, BLOCK_ST):
                    writes.add(s.args[0])
                elif s.opcode == ATOMIC_ADD:
                    reads.add(s.args[0])
                    writes.add(s.args[0])
            elif isinstance(s, (Pred, Loop)):
                walk(s.body)

    walk(body)
    return reads, writes


def body_uses_shared(body: Sequence[Stmt]) -> bool:
    def walk(stmts) -> bool:
        for s in stmts:
            if isinstance(s, Op) and s.opcode in (LD_SHARED, ST_SHARED):
                return True
            if isinstance(s, (Pred, Loop)) and walk(s.body):
                return True
        return False

    return walk(body)


# --------------------------------------------------------------------------
# Body rewriting helpers (used by the optimization passes in passes.py)
# --------------------------------------------------------------------------


def walk_ops(body: Sequence[Stmt]):
    """Yield every :class:`Op` in ``body`` in program order, recursively."""
    for s in body:
        if isinstance(s, Op):
            yield s
        elif isinstance(s, (Pred, Loop)):
            yield from walk_ops(s.body)


def count_ops(body: Sequence[Stmt]) -> int:
    """Static op count (Pred/Loop/Barrier structure nodes not counted)."""
    return sum(1 for _ in walk_ops(body))


def rewrite_body(body: Sequence[Stmt],
                 fn: Callable[[Op], Union[Op, List[Stmt], None]]
                 ) -> List[Stmt]:
    """Structure-preserving rewrite: ``fn`` maps each op to a replacement op,
    a list of statements, or ``None`` (delete).  Pred/Loop/Barrier nodes are
    rebuilt around the rewritten bodies."""
    out: List[Stmt] = []
    for s in body:
        if isinstance(s, Op):
            r = fn(s)
            if r is None:
                continue
            out.extend(r if isinstance(r, list) else [r])
        elif isinstance(s, Pred):
            out.append(Pred(s.cond, rewrite_body(s.body, fn)))
        elif isinstance(s, Loop):
            out.append(Loop(s.var, s.count, rewrite_body(s.body, fn)))
        else:
            out.append(s)
    return out


def reg_def_counts(body: Sequence[Stmt]) -> Dict[str, int]:
    """How many ops (or loop headers) define each register name.  A count of
    one means true SSA; ``Builder.assign`` re-targets give counts > 1."""
    counts: Dict[str, int] = {}

    def walk(stmts):
        for s in stmts:
            if isinstance(s, Op):
                if s.dest is not None:
                    counts[s.dest.name] = counts.get(s.dest.name, 0) + 1
            elif isinstance(s, Pred):
                walk(s.body)
            elif isinstance(s, Loop):
                counts[s.var.name] = counts.get(s.var.name, 0) + 1
                walk(s.body)

    walk(body)
    return counts


def reg_use_counts(body: Sequence[Stmt]) -> Dict[str, int]:
    """How many times each register name is read (op args + @PRED conds)."""
    counts: Dict[str, int] = {}

    def walk(stmts):
        for s in stmts:
            if isinstance(s, Op):
                for r in s.arg_regs():
                    counts[r.name] = counts.get(r.name, 0) + 1
            elif isinstance(s, Pred):
                counts[s.cond.name] = counts.get(s.cond.name, 0) + 1
                walk(s.body)
            elif isinstance(s, Loop):
                walk(s.body)

    walk(body)
    return counts


# --------------------------------------------------------------------------
# Stable program fingerprinting (translation-cache keys, paper §4.2)
# --------------------------------------------------------------------------


def _fingerprint_tokens(body: Sequence[Stmt], emit) -> None:
    for s in body:
        if isinstance(s, Op):
            emit("op"); emit(s.opcode)
            if s.dest is None:
                emit("-")
            else:
                emit(f"%{s.dest.name}:{s.dest.dtype}:{int(s.dest.uniform)}")
            for a in s.args:
                if isinstance(a, Reg):
                    emit(f"r%{a.name}:{a.dtype}:{int(a.uniform)}")
                else:
                    emit(f"i{type(a).__name__}:{a!r}")
            for k in sorted(s.attrs):
                emit(f"a{k}={s.attrs[k]!r}")
        elif isinstance(s, Pred):
            emit(f"pred %{s.cond.name}:{s.cond.dtype}")
            _fingerprint_tokens(s.body, emit)
            emit("endpred")
        elif isinstance(s, Loop):
            emit(f"loop %{s.var.name}:{s.var.dtype} {s.count!r}")
            _fingerprint_tokens(s.body, emit)
            emit("endloop")
        elif isinstance(s, Barrier):
            emit(f"bar {s.label}")


def program_fingerprint(prog: Program) -> str:
    """Stable content hash of a program — the translation-cache key
    component (paper §4.2: translated kernels are cached and "reused on
    subsequent launches").  Two independently built but structurally
    identical programs fingerprint equal; any change to params, shared
    memory, or the body changes the digest."""
    cached = prog.__dict__.get("_fingerprint")
    if cached is not None:
        return cached
    h = hashlib.sha256()

    def emit(tok: str) -> None:
        h.update(tok.encode())
        h.update(b"\x00")

    emit(prog.name)
    for p in prog.params:
        kind = "ptr" if isinstance(p, Ptr) else "scalar"
        emit(f"{kind}:{p.name}:{p.dtype}")
    emit(f"shared:{prog.shared_size}:{prog.shared_dtype}")
    _fingerprint_tokens(prog.body, emit)
    fp = h.hexdigest()
    prog.__dict__["_fingerprint"] = fp
    return fp


# --------------------------------------------------------------------------
# Carrying a program across packages
# --------------------------------------------------------------------------


def from_foreign(prog) -> Program:
    """Rebuild a :class:`Program` from any object of the same shape.

    The object is read by attribute and class name only: a program whose
    params are ``Ptr``/``Scalar`` objects and whose body holds
    ``Op``/``Pred``/``Loop``/``Barrier`` statements over ``Reg`` operands
    (``name``/``dtype``/``uniform``).  This is how a hetIR "binary" built by
    another package implementing the same IR crosses over: the rebuilt
    program has the same :func:`program_fingerprint` as the original, so
    its snapshots, segment indices and cache keys line up."""

    def reg(r) -> Reg:
        return Reg(str(r.name), str(r.dtype), bool(r.uniform))

    def arg(a):
        return reg(a) if type(a).__name__ == "Reg" else a

    def param(p) -> Param:
        kind = type(p).__name__
        if kind == "Ptr":
            return Ptr(str(p.name), str(p.dtype))
        if kind == "Scalar":
            return Scalar(str(p.name), str(p.dtype))
        raise TypeError(f"unknown hetIR parameter kind {kind!r}")

    def body(stmts) -> List[Stmt]:
        out: List[Stmt] = []
        for s in stmts:
            kind = type(s).__name__
            if kind == "Op":
                out.append(Op(str(s.opcode),
                              None if s.dest is None else reg(s.dest),
                              tuple(arg(a) for a in s.args),
                              dict(s.attrs)))
            elif kind == "Pred":
                out.append(Pred(reg(s.cond), body(s.body)))
            elif kind == "Loop":
                out.append(Loop(reg(s.var), s.count, body(s.body)))
            elif kind == "Barrier":
                out.append(Barrier(str(s.label)))
            else:
                raise TypeError(f"unknown hetIR statement kind {kind!r}")
        return out

    out = Program(name=str(prog.name),
                  params=[param(p) for p in prog.params],
                  body=body(prog.body),
                  shared_size=int(prog.shared_size),
                  shared_dtype=str(prog.shared_dtype))
    out.validate()
    return out
