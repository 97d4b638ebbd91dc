"""Scalar per-thread interpreter — MIMD "independent-thread mode".

Each thread is interpreted with its own control flow (a thread set shrinks at
divergent @PRED regions and reconverges after them); collectives synchronize
whichever threads are active at that point.  This is the semantics oracle
against which the vectorized and CUDA backends are validated, written
independently of :mod:`semantics` (numpy scalars, explicit thread loops) so
the implementations cross-check each other.  It runs on the host: incoming
state tensors are copied to numpy and the results handed back as tensors on
the backend's device.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from .. import hetir as ir
from ..cache import register_reviver
from ..segments import SegNode
from .base import Backend, HostState, Launch, to_numpy
from .portable_math import exp_np


class InterpBackend(Backend):
    name = "interp"

    def __init__(self, cache=None, device=None):
        super().__init__(cache, device)
        # true dynamic work counter: per-thread op executions, divergence-
        # aware (a step over k active threads counts k).  This is the
        # "interp step count" the translation benchmark reports at O0 vs
        # OPT_MAX — unrolling + post-unroll folding shrink it directly.
        self.steps_executed = 0

    def _translate(self, seg: SegNode, launch: Launch):
        """"Translation" for the interpreter: stage the segment into a tree
        of dispatch-step objects once, instead of re-walking the statement
        structure on every block of every launch.  Geometry-independent, so
        the key is just (backend, fingerprint, opt level, segment, spec
        key) — a *specialized* launch stages its own plan (the bound body
        differs), while every generic launch of the program shares one.
        The staged plan is plain picklable objects over IR dataclasses, so
        it persists to the disk tier verbatim — a warm process unpickles
        the plan and skips staging entirely."""
        key = self._cache_key(seg, launch)

        def translate():
            plan = _compile_stmts(seg.stmts)
            return plan, ("interp-plan", plan)

        return self.cache.get_or_translate(key, translate)

    def run_segment(self, seg: SegNode, state: HostState,
                    launch: Launch) -> None:
        T = launch.block_size
        plan = self._translate(seg, launch)
        # the interpreter works on host numpy copies of the state
        regs = {k: to_numpy(v) for k, v in state.regs.items()}
        shared_all = None if state.shared is None else to_numpy(state.shared)
        globals_ = {k: to_numpy(v) for k, v in state.globals_.items()}
        with np.errstate(all="ignore"):
            for b in range(launch.num_blocks):
                row = {k: v[b].copy() for k, v in regs.items()}
                shared = shared_all[b] if shared_all is not None else None
                ctx = _BlockCtx(b, T, launch, row, shared, globals_)
                plan(ctx, list(range(T)))
                self.steps_executed += ctx.steps
                for k, v in ctx.regs.items():
                    if k not in regs:
                        regs[k] = np.zeros(
                            (launch.num_blocks, T), dtype=v.dtype)
                    regs[k][b] = v
                if shared is not None:
                    shared_all[b] = ctx.shared
        dev = self.device
        state.regs = {k: torch.from_numpy(v).to(dev) for k, v in regs.items()}
        if shared_all is not None:
            state.shared = torch.from_numpy(shared_all).to(dev)
        state.globals_ = {k: torch.from_numpy(v).to(dev)
                          for k, v in globals_.items()}


class _BlockCtx:
    def __init__(self, block_id, block_size, launch, regs, shared, globals_):
        self.block_id = block_id
        self.block_size = block_size
        self.launch = launch
        self.regs: Dict[str, np.ndarray] = regs
        self.shared = shared
        self.globals_ = globals_
        self.steps = 0  # per-thread op executions within this block

    def reg_write(self, reg: ir.Reg, t: int, value) -> None:
        if reg.name not in self.regs:
            self.regs[reg.name] = np.zeros(self.block_size,
                                           dtype=ir.np_dtype(reg.dtype))
        self.regs[reg.name][t] = value

    def reg_read(self, reg: ir.Reg, t: int):
        row = self.regs.get(reg.name)
        if row is None:  # never-written register: reads as zero
            return ir.np_dtype(reg.dtype).type(0)
        return row[t]


class _Plan:
    """Staged segment body: a list of step objects.  Built once per cache
    entry; plain data over IR dataclasses, so the whole tree pickles —
    which is what makes interp translations directly persistable."""

    def __init__(self, steps: List["_Step"]):
        self.steps = steps

    def __call__(self, ctx: "_BlockCtx", threads: List[int]) -> None:
        if not threads:
            return
        for step in self.steps:
            step(ctx, threads)


class _Step:
    pass


class _OpStep(_Step):
    def __init__(self, op: ir.Op):
        self.op = op

    def __call__(self, ctx, threads):
        ctx.steps += len(threads)
        _exec_op(self.op, ctx, threads)


class _CollectiveStep(_Step):
    def __init__(self, op: ir.Op):
        self.op = op

    def __call__(self, ctx, threads):
        ctx.steps += len(threads)
        _exec_collective(self.op, ctx, threads)


class _PredStep(_Step):
    def __init__(self, cond: ir.Reg, inner: _Plan):
        self.cond = cond
        self.inner = inner

    def __call__(self, ctx, threads):
        taken = [t for t in threads if bool(ctx.reg_read(self.cond, t))]
        if taken:  # divergence; implicit reconverge
            self.inner(ctx, taken)


class _LoopStep(_Step):
    def __init__(self, loop: ir.Loop, inner: _Plan):
        self.loop = loop
        self.inner = inner

    def __call__(self, ctx, threads):
        loop = self.loop
        count = loop.count if isinstance(loop.count, int) \
            else int(ctx.launch.scalars[loop.count])
        for it in range(count):
            for t in threads:
                ctx.reg_write(loop.var, t, it)
            self.inner(ctx, threads)


def _compile_stmts(stmts: Sequence[ir.Stmt]) -> _Plan:
    """Stage a segment body into a step tree: structural dispatch and
    collective/scalar classification happen once at translation time."""
    steps: List[_Step] = []
    for s in stmts:
        if isinstance(s, ir.Op):
            if s.opcode in ir.COLLECTIVE_OPS:
                steps.append(_CollectiveStep(s))
            else:
                steps.append(_OpStep(s))
        elif isinstance(s, ir.Pred):
            steps.append(_PredStep(s.cond, _compile_stmts(s.body)))
        elif isinstance(s, ir.Loop):
            steps.append(_LoopStep(s, _compile_stmts(s.body)))
        elif isinstance(s, ir.Barrier):
            raise AssertionError("barrier inside segment")
    return _Plan(steps)


# a persisted interp plan is the live value itself
register_reviver("interp-plan", lambda payload: payload)


def _exec_stmts(stmts: Sequence[ir.Stmt], ctx: _BlockCtx,
                threads: List[int]) -> None:
    """Uncached single-shot execution (kept for direct use in tests)."""
    _compile_stmts(stmts)(ctx, threads)


def _val(ctx: _BlockCtx, a, t: int):
    if isinstance(a, ir.Reg):
        return ctx.reg_read(a, t)
    return a


def _exec_op(op: ir.Op, ctx: _BlockCtx, threads: List[int]) -> None:
    oc, d = op.opcode, op.dest

    if oc in ir.COLLECTIVE_OPS:
        _exec_collective(op, ctx, threads)
        return

    for t in threads:
        if oc == ir.GET_GLOBAL_ID:
            v = ctx.block_id * ctx.block_size + t
        elif oc == ir.GET_BLOCK_ID:
            v = ctx.block_id
        elif oc == ir.GET_THREAD_ID:
            v = t
        elif oc == ir.GET_BLOCK_DIM:
            v = ctx.block_size
        elif oc == ir.GET_NUM_BLOCKS:
            v = ctx.launch.num_blocks
        elif oc == ir.CONST:
            v = ir.np_dtype(d.dtype).type(op.args[0])
        elif oc == ir.LD_PARAM:
            v = ir.np_dtype(d.dtype).type(ctx.launch.scalars[op.args[0]])
        elif oc == ir.MOV:
            v = _val(ctx, op.args[0], t)
        elif oc == ir.CVT:
            v = ir.np_dtype(d.dtype).type(_val(ctx, op.args[0], t))
        elif oc == ir.SELECT:
            c, a, bb = (_val(ctx, x, t) for x in op.args)
            v = a if bool(c) else bb
        elif oc == ir.FMA:
            a, bb, c = (_val(ctx, x, t) for x in op.args)
            v = a * bb + c
        elif oc == ir.LD_GLOBAL:
            buf = ctx.globals_[op.args[0]]
            v = buf[int(_val(ctx, op.args[1], t))]
        elif oc == ir.ST_GLOBAL:
            buf = ctx.globals_[op.args[0]]
            buf[int(_val(ctx, op.args[1], t))] = _val(ctx, op.args[2], t)
            continue
        elif oc == ir.ATOMIC_ADD:
            buf = ctx.globals_[op.args[0]]
            i = int(_val(ctx, op.args[1], t))
            old = buf[i]
            buf[i] = old + _val(ctx, op.args[2], t)
            if d is None:
                continue
            v = old
        elif oc == ir.LD_SHARED:
            v = ctx.shared[int(_val(ctx, op.args[0], t))]
        elif oc == ir.ST_SHARED:
            ctx.shared[int(_val(ctx, op.args[0], t))] = \
                _val(ctx, op.args[1], t)
            continue
        elif oc in _SCALAR_BIN:
            a = _val(ctx, op.args[0], t)
            b = _val(ctx, op.args[1], t)
            v = _SCALAR_BIN[oc](a, b)
        elif oc in _SCALAR_UN:
            v = _SCALAR_UN[oc](_val(ctx, op.args[0], t))
        else:  # pragma: no cover
            raise NotImplementedError(oc)
        if d is not None:
            ctx.reg_write(d, t, v)


def _exec_collective(op: ir.Op, ctx: _BlockCtx, threads: List[int]) -> None:
    oc, d = op.opcode, op.dest
    if oc == ir.VOTE_ANY:
        r = any(bool(_val(ctx, op.args[0], t)) for t in threads)
        for t in threads:
            ctx.reg_write(d, t, r)
    elif oc == ir.VOTE_ALL:
        r = all(bool(_val(ctx, op.args[0], t)) for t in threads)
        for t in threads:
            ctx.reg_write(d, t, r)
    elif oc == ir.VOTE_BALLOT:
        r = sum(1 for t in threads if bool(_val(ctx, op.args[0], t)))
        for t in threads:
            ctx.reg_write(d, t, r)
    elif oc == ir.REDUCE_ADD:
        vals = [_val(ctx, op.args[0], t) for t in threads]
        # accumulate in the dest dtype (numpy's sum silently promotes
        # int32 to the platform int — fuzz-harness find) and strictly
        # sequentially in lane order: np.sum uses pairwise summation,
        # whose float rounding diverged from the jnp backends' lane-order
        # fold (the documented nn_layer ULP divergence)
        dt = np.dtype(ir.np_dtype(d.dtype))
        acc = np.zeros((), dtype=dt)  # 0-d: int overflow wraps, no warning
        for val in vals:
            acc = np.add(acc, val, dtype=dt)
        for t in threads:
            ctx.reg_write(d, t, dt.type(acc))
    elif oc == ir.REDUCE_MAX:
        vals = [_val(ctx, op.args[0], t) for t in threads]
        r = np.max(np.array(vals))
        for t in threads:
            ctx.reg_write(d, t, r)
    elif oc == ir.SCAN_ADD:
        # inclusive prefix over *lane order* with inactive lanes contributing 0
        acc = 0
        vals = {}
        active = set(threads)
        for t in range(ctx.block_size):
            if t in active:
                acc = acc + _val(ctx, op.args[0], t)
                vals[t] = acc
        for t in threads:
            ctx.reg_write(d, t, vals[t])
    elif oc == ir.SHUFFLE:
        # read source lane's value regardless of its activity (hardware-like)
        full = ctx.regs[op.args[0].name]
        for t in threads:
            src = int(np.clip(_val(ctx, op.args[1], t), 0,
                              ctx.block_size - 1))
            ctx.reg_write(d, t, full[src])
    else:  # pragma: no cover
        raise NotImplementedError(oc)


def _py_div(a, b):
    if isinstance(a, (np.floating, float)):
        return a / b
    return a // b


_SCALAR_BIN = {
    ir.ADD: lambda a, b: a + b,
    ir.SUB: lambda a, b: a - b,
    ir.MUL: lambda a, b: a * b,
    ir.DIV: _py_div,
    ir.MOD: lambda a, b: a % b,
    # NOT Python min/max: those return whichever operand survives a
    # False comparison, so NaN propagation depends on argument order
    # (max(0.0, nan) == 0.0 but max(nan, 0.0) == nan) while the jnp
    # backends' minimum/maximum always propagate NaN — caught by the
    # attention-profile cross-backend fuzz corpus
    ir.MIN: np.minimum,
    ir.MAX: np.maximum,
    ir.AND: lambda a, b: (a and b) if isinstance(a, (bool, np.bool_))
        else a & b,
    ir.OR: lambda a, b: (a or b) if isinstance(a, (bool, np.bool_))
        else a | b,
    ir.XOR: lambda a, b: (bool(a) != bool(b))
        if isinstance(a, (bool, np.bool_)) else a ^ b,
    ir.SHL: lambda a, b: a << b,
    ir.SHR: lambda a, b: a >> b,
    ir.LT: lambda a, b: a < b,
    ir.LE: lambda a, b: a <= b,
    ir.GT: lambda a, b: a > b,
    ir.GE: lambda a, b: a >= b,
    ir.EQ: lambda a, b: a == b,
    ir.NE: lambda a, b: a != b,
}

_SCALAR_UN = {
    ir.NEG: lambda a: -a,
    ir.ABS: abs,
    ir.SQRT: np.sqrt,
    # EXP is the portable software exponential, not libm: np.exp and
    # jnp.exp disagree in the low bits, which would break the cross-
    # backend bit-identity contract (see backends/portable_math.py)
    ir.EXP: exp_np,
    ir.NOT: lambda a: (not a) if isinstance(a, (bool, np.bool_)) else ~a,
    ir.MOV: lambda a: a,
}
