"""Lane-vector semantics of hetIR ops in eager PyTorch — the plain version
of the CUDA segment kernels.

The vectorized backend, and the CUDA backend on CPU tensors, evaluate a
segment through this module on ``[rows, block_size]`` tensors: every op runs
for all lanes of the rows before the next op, predication (``@PRED``) is an
explicit active mask, and inactive lanes keep their register values.  The
rules are those of the reference *interpreter* (``interp.py``), which is the
oracle — not of the JAX package's ``semantics`` module, whose folds seed
with lane 0 and whose XLA kernels flush subnormals:

* one IEEE float32 rounding per op; ``FMA`` is two (``(a*b)+c`` as two
  eager kernels, so nothing can contract them);
* integer ``DIV``/``MOD`` are NumPy floor division/modulo, a zero divisor
  gives 0, and all integer arithmetic wraps at 32 bits;
* shifts by a count outside ``[0, 32)`` give what NumPy gives (0, or the
  sign fill for a right shift of a negative ``i32``);
* ``MIN``/``MAX``/``REDUCE_MAX`` propagate NaN as ``np.minimum``/
  ``np.maximum`` do (on a tie the second operand wins);
* ``CVT`` of NaN or out-of-range float32 to ``i32`` gives ``INT_MIN`` and
  to ``u32`` the low 32 bits of the int64 truncation (0 when that is out of
  range), as NumPy on x86;
* float ``REDUCE_ADD``/``SCAN_ADD`` fold sequentially in lane order from
  +0.0, inactive lanes contributing nothing;
* conflicting stores of one op land in block-then-lane order (the highest
  lane wins), and ``ATOMIC_ADD`` applies lane by lane in that order;
* subnormals are kept; only ``EXP`` flushes them (``portable_math``).

Integer registers are evaluated as int64 tensors holding the 32-bit value
(``i32`` in ``[-2^31, 2^31)``, ``u32`` in ``[0, 2^32)``) and stored back in
their own dtype; PyTorch has no arithmetic on ``uint32`` tensors.

Blocks run in order in the interpreter, so a segment in which blocks can
see each other's global-memory traffic (:func:`serial_segment`) is
evaluated one block at a time; every other segment evaluates all blocks at
once.
"""
from __future__ import annotations

from typing import AbstractSet, Dict, Optional, Sequence

import numpy as np
import torch

from .. import hetir as ir
from ..segments import SegNode
from .base import HostState, Launch, torch_dtype
from .portable_math import exp_torch

MASK32 = 0xFFFFFFFF
INT_MIN = -(1 << 31)


# ---------------------------------------------------------------------------
# storage <-> working representation, and NumPy's casts
# ---------------------------------------------------------------------------

def wrap(v: torch.Tensor, dtype: str) -> torch.Tensor:
    """Reduce an int64 working value to the 32-bit range of ``dtype``."""
    if dtype == ir.I32:
        return ((v + (1 << 31)) & MASK32) - (1 << 31)
    if dtype == ir.U32:
        return v & MASK32
    return v


def to_work(t: torch.Tensor, dtype: str) -> torch.Tensor:
    """Stored tensor -> working tensor."""
    if dtype == ir.I32:
        return t.to(torch.int64)
    if dtype == ir.U32:
        return t.view(torch.int32).to(torch.int64) & MASK32
    return t


def to_storage(w: torch.Tensor, dtype: str) -> torch.Tensor:
    """Working tensor -> tensor of ``dtype``'s storage type."""
    if dtype == ir.I32:
        return w.to(torch.int32)
    if dtype == ir.U32:
        return wrap(w, ir.I32).to(torch.int32).view(torch.uint32)
    return w


def cast(w: torch.Tensor, src: str, dst: str) -> torch.Tensor:
    """NumPy's conversion of a ``src`` value to ``dst`` (working form)."""
    if src == dst:
        return w
    if dst == ir.BOOL:
        return w != 0
    if src == ir.BOOL:
        return w.to(torch.float32) if dst == ir.F32 else w.to(torch.int64)
    if src == ir.F32:
        t = torch.trunc(w)
        if dst == ir.I32:
            bad = torch.isnan(w) | (w >= 2.0 ** 31) | (w < -2.0 ** 31)
            return torch.where(bad, INT_MIN,
                               torch.where(bad, 0.0, t).to(torch.int64))
        bad = torch.isnan(w) | (torch.abs(w) >= 2.0 ** 63)
        return torch.where(bad, 0,
                           torch.where(bad, 0.0, t).to(torch.int64) & MASK32)
    if dst == ir.F32:
        return w.to(torch.float32)
    return wrap(w, dst)                     # i32 <-> u32: reinterpret


def const_tensor(value, dtype: str, device) -> torch.Tensor:
    """A 0-d working tensor of ``value`` converted as NumPy converts it."""
    v = ir.np_dtype(dtype).type(value)
    if dtype == ir.F32:
        return torch.tensor(float(v), dtype=torch.float32, device=device)
    if dtype == ir.BOOL:
        return torch.tensor(bool(v), device=device)
    return torch.tensor(int(v), dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# evaluation environment
# ---------------------------------------------------------------------------

class Env:
    """Mutable evaluation environment for one pass over ``rows`` blocks.

    ``regs`` and ``shared`` hold working tensors of shape ``[rows, T]`` and
    ``[rows, S]``; ``globals_`` holds the stored 1-D buffers, which stores
    update in place."""

    def __init__(self, regs: Dict[str, torch.Tensor],
                 shared: Optional[torch.Tensor], shared_dtype: str,
                 globals_: Dict[str, torch.Tensor], buf_dtypes: Dict[str, str],
                 scalars: Dict[str, object], num_blocks: int, block_size: int,
                 block_offset: int, rows: int, device: torch.device):
        self.regs = regs
        self.shared = shared
        self.shared_dtype = shared_dtype
        self.globals = globals_
        self.buf_dtypes = buf_dtypes
        self.scalars = scalars
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.lane_shape = (rows, block_size)
        self.device = device
        t = torch.arange(block_size, dtype=torch.int64, device=device)
        b = torch.arange(block_offset, block_offset + rows, dtype=torch.int64,
                         device=device)
        self.tid = t.expand(rows, block_size)
        self.bid = b[:, None].expand(rows, block_size)

    def read(self, reg: ir.Reg) -> torch.Tensor:
        v = self.regs.get(reg.name)
        if v is None:  # never-written register: reads as zero
            v = const_tensor(0, reg.dtype, self.device)
        return v.expand(self.lane_shape)

    def arg(self, a, dtype: str) -> torch.Tensor:
        """Operand value in the working form of ``dtype``: a register is
        read (and must have that dtype), an immediate is converted."""
        if isinstance(a, ir.Reg):
            if a.dtype != dtype:
                raise NotImplementedError(
                    f"operand %{a.name}:{a.dtype} where {dtype} is expected")
            return self.read(a)
        return const_tensor(a, dtype, self.device).expand(self.lane_shape)

    def write(self, reg: ir.Reg, value: torch.Tensor, vtype: str,
              mask: Optional[torch.Tensor]) -> None:
        value = cast(value, vtype, reg.dtype).expand(self.lane_shape)
        if mask is not None:
            old = self.regs.get(reg.name)
            if old is None:
                # registers read as zero until first written: a masked
                # first write leaves inactive lanes at zero
                old = const_tensor(0, reg.dtype, self.device)
            value = torch.where(mask, value, old.expand(self.lane_shape))
        self.regs[reg.name] = value


def operand_dtype(op: ir.Op, start: int = 0) -> str:
    """The common dtype of ``op``'s register operands from ``start`` on
    (the destination's dtype when there are none).  Mixed operand dtypes
    would promote under NumPy; hetIR programs built by the Builder never
    mix them, and neither backend of the port accepts them."""
    dts = {a.dtype for a in op.args[start:] if isinstance(a, ir.Reg)}
    if len(dts) > 1:
        raise NotImplementedError(
            f"{op.opcode} with mixed operand dtypes {sorted(dts)}")
    if dts:
        return dts.pop()
    if op.dest is None:
        raise NotImplementedError(f"{op.opcode} without a typed operand")
    return op.dest.dtype


# ---------------------------------------------------------------------------
# ALU
# ---------------------------------------------------------------------------

def _fmin(a, b):
    return torch.where((a < b) | torch.isnan(a), a, b)


def _fmax(a, b):
    return torch.where((a > b) | torch.isnan(a), a, b)


def _fmod(a, b):
    """NumPy's float32 floor modulus (``npy_divmodf``).  The remainder is
    taken in float64, where PyTorch's ``fmod`` is exact (its vectorized
    float32 CPU kernel is not); it is exactly representable in float32."""
    mod = torch.fmod(a.to(torch.float64), b.to(torch.float64)) \
        .to(torch.float32)
    fix = (mod != 0) & ((b < 0) != (mod < 0))
    zero = torch.where(b < 0, -0.0, 0.0).to(torch.float32)
    out = torch.where(fix, mod + b, torch.where(mod == 0, zero, mod))
    return torch.where(b == 0, mod, out)


def _shift(a, c, dt: str, left: bool):
    inside = (c >= 0) & (c < 32)
    cc = torch.where(inside, c, 0)
    if left:
        return torch.where(inside, wrap(a << cc, dt), 0)
    fill = torch.where(a < 0, -1, 0) if dt == ir.I32 else torch.zeros_like(a)
    return torch.where(inside, a >> cc, fill)


def binop(oc: str, a: torch.Tensor, b: torch.Tensor, dt: str) -> torch.Tensor:
    """``oc`` on two working operands of dtype ``dt``; the result is of
    dtype ``dt`` (``bool`` for comparisons)."""
    if oc in ir.CMP_OPS:
        return {ir.LT: torch.lt, ir.LE: torch.le, ir.GT: torch.gt,
                ir.GE: torch.ge, ir.EQ: torch.eq, ir.NE: torch.ne}[oc](a, b)
    if dt == ir.BOOL:
        if oc == ir.AND:
            return a & b
        if oc == ir.OR:
            return a | b
        if oc == ir.XOR:
            return a ^ b
        raise NotImplementedError(f"{oc} on bool")
    if dt == ir.F32:
        if oc == ir.ADD:
            return a + b
        if oc == ir.SUB:
            return a - b
        if oc == ir.MUL:
            return a * b
        if oc == ir.DIV:
            return a / b
        if oc == ir.MOD:
            return _fmod(a, b)
        if oc == ir.MIN:
            return _fmin(a, b)
        if oc == ir.MAX:
            return _fmax(a, b)
        raise NotImplementedError(f"{oc} on f32")
    # integers, as int64 working values
    if oc == ir.ADD:
        return wrap(a + b, dt)
    if oc == ir.SUB:
        return wrap(a - b, dt)
    if oc == ir.MUL:
        return wrap(a * b, dt)
    if oc in (ir.DIV, ir.MOD):
        zero = b == 0
        bb = torch.where(zero, 1, b)
        r = torch.div(a, bb, rounding_mode="floor") if oc == ir.DIV \
            else torch.remainder(a, bb)
        return torch.where(zero, 0, wrap(r, dt))
    if oc == ir.MIN:
        return torch.minimum(a, b)
    if oc == ir.MAX:
        return torch.maximum(a, b)
    if oc == ir.AND:
        return a & b
    if oc == ir.OR:
        return a | b
    if oc == ir.XOR:
        return a ^ b
    if oc in (ir.SHL, ir.SHR):
        return _shift(a, b, dt, oc == ir.SHL)
    raise NotImplementedError(f"{oc} on {dt}")


def unop(oc: str, a: torch.Tensor, dt: str) -> torch.Tensor:
    if oc == ir.MOV:
        return a
    if dt == ir.BOOL:
        if oc == ir.NOT:
            return ~a
        raise NotImplementedError(f"{oc} on bool")
    if dt == ir.F32:
        if oc == ir.NEG:
            return -a
        if oc == ir.ABS:
            return torch.abs(a)
        if oc == ir.SQRT:
            # float64 square root rounded once to float32 is the correctly
            # rounded float32 root; PyTorch's vectorized float32 CPU kernel
            # is not (ROADMAP.md, Queue C)
            return torch.sqrt(a.to(torch.float64)).to(torch.float32)
        if oc == ir.EXP:
            return exp_torch(a)
        raise NotImplementedError(f"{oc} on f32")
    if oc == ir.NEG:
        return wrap(-a, dt)
    if oc == ir.ABS:
        return wrap(torch.abs(a), dt)
    if oc == ir.NOT:
        return wrap(~a, dt)
    raise NotImplementedError(f"{oc} on {dt}")


# ---------------------------------------------------------------------------
# statements
# ---------------------------------------------------------------------------

def eval_stmts(stmts: Sequence[ir.Stmt], env: Env,
               mask: Optional[torch.Tensor]) -> None:
    for s in stmts:
        if isinstance(s, ir.Op):
            eval_op(s, env, mask)
        elif isinstance(s, ir.Pred):
            cond = cast(env.read(s.cond), s.cond.dtype, ir.BOOL)
            eval_stmts(s.body, env, cond if mask is None else mask & cond)
        elif isinstance(s, ir.Loop):
            count = s.count if isinstance(s.count, int) \
                else int(env.scalars[s.count])
            for it in range(count):
                env.write(s.var, const_tensor(it, ir.I32, env.device), ir.I32,
                          mask)
                eval_stmts(s.body, env, mask)
        elif isinstance(s, ir.Barrier):
            raise AssertionError(
                "barrier inside a segment — segmentation bug")
        else:  # pragma: no cover
            raise TypeError(type(s))


def _index(env: Env, idx_arg) -> torch.Tensor:
    """``int(index)`` per lane, int64 (a float index truncates)."""
    if isinstance(idx_arg, ir.Reg):
        v = env.read(idx_arg)
        return cast(v, idx_arg.dtype, ir.I32) if idx_arg.dtype == ir.F32 \
            else v.to(torch.int64)
    return torch.full(env.lane_shape, int(idx_arg), dtype=torch.int64,
                      device=env.device)


def _resolve(idx: torch.Tensor, length: int, active: torch.Tensor):
    """Python indexing: negative indices count from the end; lanes whose
    index is still out of range do not access memory (a load reads 0, a
    store is dropped)."""
    idx = torch.where(idx < 0, idx + length, idx)
    ok = active & (idx >= 0) & (idx < length)
    return torch.where(ok, idx, 0), ok


def _active(env: Env, mask) -> torch.Tensor:
    if mask is None:
        return torch.ones(env.lane_shape, dtype=torch.bool, device=env.device)
    return mask


def _gather(buf: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor,
            dtype: str) -> torch.Tensor:
    if buf.numel() == 0:
        return const_tensor(0, dtype, buf.device).expand(idx.shape)
    if dtype == ir.U32:     # no indexing kernels for uint32: go via int32
        v = buf.view(torch.int32)[idx].to(torch.int64) & MASK32
    else:
        v = to_work(buf[idx], dtype)
    return torch.where(ok, v, const_tensor(0, dtype, buf.device))


def _scatter_last(flat: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor,
                  vals: torch.Tensor, dtype: Optional[str]) -> None:
    """Store ``vals`` (working form) at ``idx`` of the 1-D tensor ``flat``
    for the ``ok`` lanes, taken in row-major (block, lane) order: where
    several lanes hit one address the last of them wins.  ``flat`` holds
    the stored form of ``dtype``, or the working form when ``dtype`` is
    None."""
    pos = torch.nonzero(ok.reshape(-1)).reshape(-1)
    if pos.numel() == 0:
        return
    where_ = idx.reshape(-1)[pos]
    uniq, inv = torch.unique(where_, return_inverse=True)
    last = torch.full((uniq.numel(),), -1, dtype=torch.int64,
                      device=flat.device)
    last = last.scatter_reduce(0, inv, torch.arange(pos.numel(),
                                                    device=flat.device),
                               reduce="amax")
    keep = pos[last]
    stored = vals.reshape(-1)[keep]
    if dtype is not None:
        stored = to_storage(stored, dtype)
    if dtype == ir.U32:
        flat.view(torch.int32)[uniq] = stored.view(torch.int32)
    else:
        flat[uniq] = stored


def eval_op(op: ir.Op, env: Env, mask: Optional[torch.Tensor]) -> None:
    oc, d = op.opcode, op.dest

    # ---- identity ---------------------------------------------------------
    if oc == ir.GET_GLOBAL_ID:
        env.write(d, wrap(env.bid * env.block_size + env.tid, ir.I32),
                  ir.I32, mask)
    elif oc == ir.GET_BLOCK_ID:
        env.write(d, env.bid, ir.I32, mask)
    elif oc == ir.GET_THREAD_ID:
        env.write(d, env.tid, ir.I32, mask)
    elif oc == ir.GET_BLOCK_DIM:
        env.write(d, const_tensor(env.block_size, ir.I32, env.device),
                  ir.I32, mask)
    elif oc == ir.GET_NUM_BLOCKS:
        env.write(d, const_tensor(env.num_blocks, ir.I32, env.device),
                  ir.I32, mask)

    # ---- constants / moves ------------------------------------------------
    elif oc == ir.CONST:
        env.write(d, const_tensor(op.args[0], d.dtype, env.device), d.dtype,
                  mask)
    elif oc == ir.LD_PARAM:
        env.write(d, const_tensor(env.scalars[op.args[0]], d.dtype,
                                  env.device), d.dtype, mask)
    elif oc in (ir.MOV, ir.CVT):
        a = op.args[0]
        dt = a.dtype if isinstance(a, ir.Reg) else d.dtype
        env.write(d, env.arg(a, dt), dt, mask)

    # ---- ALU ---------------------------------------------------------------
    elif oc in ir.ALU_BINARY or oc in ir.CMP_OPS:
        dt = operand_dtype(op)
        r = binop(oc, env.arg(op.args[0], dt), env.arg(op.args[1], dt), dt)
        env.write(d, r, ir.BOOL if oc in ir.CMP_OPS else dt, mask)
    elif oc in ir.ALU_UNARY:
        dt = operand_dtype(op)
        env.write(d, unop(oc, env.arg(op.args[0], dt), dt), dt, mask)
    elif oc == ir.FMA:
        dt = operand_dtype(op)
        a, b, c = (env.arg(x, dt) for x in op.args)
        env.write(d, binop(ir.ADD, binop(ir.MUL, a, b, dt), c, dt), dt, mask)
    elif oc == ir.SELECT:
        cv = op.args[0]
        ct = cv.dtype if isinstance(cv, ir.Reg) else ir.BOOL
        c = cast(env.arg(cv, ct), ct, ir.BOOL)
        vals = []
        for x in op.args[1:]:
            xt = x.dtype if isinstance(x, ir.Reg) else d.dtype
            vals.append(cast(env.arg(x, xt), xt, d.dtype))
        env.write(d, torch.where(c, vals[0], vals[1]), d.dtype, mask)

    # ---- global memory -----------------------------------------------------
    elif oc in (ir.LD_GLOBAL, ir.BLOCK_LD):
        name = op.args[0]
        buf, bdt = env.globals[name], env.buf_dtypes[name]
        idx, ok = _resolve(_index(env, op.args[1]), buf.numel(),
                           _active(env, mask))
        env.write(d, _gather(buf, idx, ok, bdt), bdt, mask)
    elif oc in (ir.ST_GLOBAL, ir.BLOCK_ST):
        name = op.args[0]
        buf, bdt = env.globals[name], env.buf_dtypes[name]
        idx, ok = _resolve(_index(env, op.args[1]), buf.numel(),
                           _active(env, mask))
        v = op.args[2]
        vt = v.dtype if isinstance(v, ir.Reg) else bdt
        _scatter_last(buf, idx, ok, cast(env.arg(v, vt), vt, bdt), bdt)
    elif oc == ir.ATOMIC_ADD:
        name = op.args[0]
        buf, bdt = env.globals[name], env.buf_dtypes[name]
        idx, ok = _resolve(_index(env, op.args[1]), buf.numel(),
                           _active(env, mask))
        vals = env.arg(op.args[2], bdt)
        old = torch.zeros(env.lane_shape, dtype=vals.dtype, device=env.device)
        flat_old = old.reshape(-1)
        flat_idx, flat_vals = idx.reshape(-1), vals.reshape(-1)
        # lane by lane, in (block, lane) order: the old value each lane
        # sees and the rounding of every float add depend on that order
        for j in torch.nonzero(ok.reshape(-1)).reshape(-1).tolist():
            i = flat_idx[j:j + 1]
            cur = _gather(buf, i, torch.ones_like(i, dtype=torch.bool), bdt)
            flat_old[j] = cur[0]
            _scatter_last(buf, i, torch.ones_like(i, dtype=torch.bool),
                          binop(ir.ADD, cur, flat_vals[j:j + 1], bdt), bdt)
        if d is not None:
            env.write(d, old, bdt, mask)

    # ---- shared memory -----------------------------------------------------
    elif oc == ir.LD_SHARED:
        S = env.shared.shape[1]
        idx, ok = _resolve(_index(env, op.args[0]), S, _active(env, mask))
        v = torch.gather(env.shared, 1, idx)
        env.write(d, torch.where(ok, v, const_tensor(0, env.shared_dtype,
                                                     env.device)),
                  env.shared_dtype, mask)
    elif oc == ir.ST_SHARED:
        S = env.shared.shape[1]
        idx, ok = _resolve(_index(env, op.args[0]), S, _active(env, mask))
        v = op.args[1]
        vt = v.dtype if isinstance(v, ir.Reg) else env.shared_dtype
        val = cast(env.arg(v, vt), vt, env.shared_dtype)
        rows = torch.arange(env.lane_shape[0], device=env.device)[:, None]
        # env.shared is the working copy of this pass: store into it
        _scatter_last(env.shared.view(-1), idx + rows * S, ok, val, None)

    # ---- collectives (within block, over active lanes) ---------------------
    elif oc in ir.COLLECTIVE_OPS:
        _collective(op, env, mask)

    else:  # pragma: no cover
        raise NotImplementedError(oc)


def _collective(op: ir.Op, env: Env, mask) -> None:
    oc, d = op.opcode, op.dest
    act = _active(env, mask)
    T = env.block_size
    if oc in (ir.VOTE_ANY, ir.VOTE_ALL, ir.VOTE_BALLOT):
        a = op.args[0]
        p = cast(env.read(a), a.dtype, ir.BOOL) if isinstance(a, ir.Reg) \
            else torch.full(env.lane_shape, bool(a), device=env.device)
        if oc == ir.VOTE_ANY:
            r, rt = (p & act).any(dim=-1, keepdim=True), ir.BOOL
        elif oc == ir.VOTE_ALL:
            r, rt = (p | ~act).all(dim=-1, keepdim=True), ir.BOOL
        else:
            r, rt = (p & act).sum(dim=-1, keepdim=True), ir.I32
        env.write(d, r, rt, mask)
    elif oc == ir.REDUCE_ADD:
        # accumulates in the destination dtype from its zero, strictly in
        # lane order (interp.py); inactive lanes contribute nothing
        dt = d.dtype
        v = env.arg(op.args[0], dt)
        if dt == ir.F32:
            acc = torch.zeros((env.lane_shape[0], 1), dtype=torch.float32,
                              device=env.device)
            for t in range(T):
                acc = torch.where(act[:, t:t + 1], acc + v[:, t:t + 1], acc)
        else:
            acc = wrap(torch.where(act, v, 0).sum(dim=-1, keepdim=True), dt)
        env.write(d, acc, dt, mask)
    elif oc == ir.REDUCE_MAX:
        dt = operand_dtype(op)
        v = env.arg(op.args[0], dt)
        acc = torch.zeros_like(v[:, 0:1])
        have = torch.zeros_like(act[:, 0:1])
        for t in range(T):
            vt, at = v[:, t:t + 1], act[:, t:t + 1]
            best = _fmax(acc, vt) if dt == ir.F32 else torch.maximum(acc, vt)
            acc = torch.where(at & ~have, vt, torch.where(at, best, acc))
            have = have | at
        env.write(d, acc, dt, mask)
    elif oc == ir.SCAN_ADD:
        dt = operand_dtype(op)
        v = env.arg(op.args[0], dt)
        if dt == ir.F32:
            acc = torch.zeros((env.lane_shape[0], 1), dtype=torch.float32,
                              device=env.device)
            cols = []
            for t in range(T):
                acc = torch.where(act[:, t:t + 1], acc + v[:, t:t + 1], acc)
                cols.append(acc)
            out = torch.cat(cols, dim=1)
        else:
            out = wrap(torch.cumsum(torch.where(act, v, 0), dim=1), dt)
        env.write(d, out, dt, mask)
    elif oc == ir.SHUFFLE:
        src_reg = op.args[0]
        dt = src_reg.dtype
        v = env.read(src_reg)
        src = torch.clamp(_index(env, op.args[1]), 0, T - 1)
        env.write(d, torch.gather(v, 1, src), dt, mask)
    else:  # pragma: no cover
        raise NotImplementedError(oc)


# ---------------------------------------------------------------------------
# segment driver
# ---------------------------------------------------------------------------

def serial_segment(seg: SegNode) -> bool:
    """Must the segment's blocks run in order?

    The interpreter runs block ``b`` to the end of the segment before block
    ``b + 1`` starts.  Running blocks side by side gives the same bits only
    when no block can observe another's global-memory traffic: every
    written buffer is accessed solely at the lane's own global id (a
    register set by ``GET_GLOBAL_ID`` once, at the top level of the
    segment, before any use), and there is no ``ATOMIC_ADD`` — whose float
    rounding and returned old values depend on the order of the adds."""
    defs = ir.reg_def_counts(seg.stmts)
    live_in = {r.name for r in seg.uses}
    gid = {s.dest.name for s in seg.stmts
           if isinstance(s, ir.Op) and s.opcode == ir.GET_GLOBAL_ID
           and defs.get(s.dest.name) == 1 and s.dest.name not in live_in}
    for op in ir.walk_ops(seg.stmts):
        if op.opcode == ir.ATOMIC_ADD:
            return True
    for op in ir.walk_ops(seg.stmts):
        if op.opcode in (ir.LD_GLOBAL, ir.ST_GLOBAL, ir.BLOCK_LD,
                         ir.BLOCK_ST) and op.args[0] in seg.gwrites:
            idx = op.args[1]
            if not (isinstance(idx, ir.Reg) and idx.name in gid):
                return True
    return False


def segment_reg_dtypes(stmts: Sequence[ir.Stmt]) -> Dict[str, str]:
    """hetIR dtype of every register the statements name."""
    out: Dict[str, str] = {}

    def note(r: ir.Reg) -> None:
        if out.setdefault(r.name, r.dtype) != r.dtype:
            raise NotImplementedError(
                f"register %{r.name} used as {out[r.name]} and {r.dtype}")

    def walk(body):
        for s in body:
            if isinstance(s, ir.Op):
                if s.dest is not None:
                    note(s.dest)
                for a in s.arg_regs():
                    note(a)
            elif isinstance(s, ir.Pred):
                note(s.cond)
                walk(s.body)
            elif isinstance(s, ir.Loop):
                note(s.var)
                walk(s.body)

    walk(stmts)
    return out


def run_segment_plain(stmts: Sequence[ir.Stmt], state: HostState,
                      launch: Launch, serial: bool, device: torch.device,
                      outputs: AbstractSet[str]) -> None:
    """Evaluate one segment on ``state`` (tensors on ``device``), all
    blocks at once or, when ``serial``, one block at a time in order.
    Only the registers in ``outputs`` (those the segment defines that are
    live after it, :func:`~repro_torch.core.liveness.segment_outputs`)
    are written back, as the CUDA kernel writes them: every lane, zeros
    for a register no lane wrote and that had no value; the others pass
    through untouched."""
    B, T = launch.num_blocks, launch.block_size
    prog = launch.program
    rdt = segment_reg_dtypes(stmts)
    bdt = {p.name: p.dtype for p in prog.buffers()}
    sdt = prog.shared_dtype
    written = {}
    for name in rdt:
        if name in state.regs:
            written[name] = state.regs[name].clone()
    shared = None if state.shared is None else state.shared.clone()
    passes = [(b, 1) for b in range(B)] if serial else [(0, B)]
    for b0, rows in passes:
        sl = slice(b0, b0 + rows)
        env = Env(regs={n: to_work(v[sl], rdt[n]) for n, v in written.items()},
                  shared=None if shared is None
                  else to_work(shared[sl], sdt), shared_dtype=sdt,
                  globals_=state.globals_, buf_dtypes=bdt,
                  scalars=launch.scalars, num_blocks=B, block_size=T,
                  block_offset=b0, rows=rows, device=device)
        eval_stmts(stmts, env, None)
        for name, v in env.regs.items():
            if name not in written:
                written[name] = torch.zeros((B, T), dtype=torch_dtype(
                    rdt[name]), device=device)
            written[name][sl] = to_storage(v, rdt[name]).expand(rows, T)
        if shared is not None:
            shared[sl] = to_storage(env.shared, sdt)
    for name in outputs:
        if name not in written:
            written[name] = torch.zeros((B, T), dtype=torch_dtype(rdt[name]),
                                        device=device)
    state.regs = {**state.regs, **{n: written[n] for n in outputs}}
    state.shared = shared
