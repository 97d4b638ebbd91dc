"""CUDA backend — hetIR segments translated to CUDA C++ kernels for Hopper.

This is the port of the JAX package's Pallas backend
(``src/repro/core/backends/pallas_backend.py``): ``PallasBackend._build``
(one grid step per hetIR block) becomes the **scalar** kernel of a segment,
``PallasBackend._build_block`` (the block-tiled path for segments
:func:`~repro_torch.core.passes.block_lower` proves lane-independent)
becomes its **block** kernel.  The translator emits one
``extern "C" __global__`` function per segment and mode from the segment's
statements, every op through the hand-written device runtime
``csrc/hetir_rt.cuh``, and compiles all the segments of one optimized
program (program, opt level and specialization) in one ``nvcc`` call
(:mod:`~repro_torch.core.backends.nvcc_build`).  Everything the code takes
at run time — grid, block size, scalars, buffer lengths — stays out of the
source, so one library serves every launch geometry of the program.

Scalar kernel: one CUDA block per hetIR block, each thread running ``HL =
⌈T / 1024⌉`` hetIR lanes (``tid + l * blockDim``, ``l < HL``; one lane a
thread up to 1024, the block then ``T`` threads).  ``HL`` is a constant of
the generated source, so a register is an array of ``HL`` locals that
stays in registers; one library per program and ``HL``, built at its first
launch.  Registers are ``[B, T]`` tensors read into locals at entry and
written out at exit; the hetIR shared row is staged in dynamic
``__shared__`` memory.  The body is if-converted:
predication is an active flag per lane, never a branch around code, so
all control flow is uniform and ``__syncthreads()`` may stand around every
store, atomic and collective — which is what reproduces the reference
interpreter's lock-step order (every lane finishes an op before the next
op starts: a thread runs an op for each of its lanes before the op's
barrier).  Stores of one op that may hit one address, ``ATOMIC_ADD`` and
the float folds of ``REDUCE_ADD``/``SCAN_ADD`` are applied by thread 0 in
lane order from a scratch area, so the highest lane wins and every
rounding happens in the interpreter's order; ``REDUCE_MAX`` is a
warp-shuffle tree whose ties resolve as that fold's (``het_block_max``).
A segment whose blocks can see each other's global traffic
(``semantics.serial_segment``) runs as one CUDA block that walks ``b =
0..B-1`` in order.  Buffers the segment never writes are read through the
read-only path; a load in a loop of static trip count whose window for one
hetIR block is known before the loop is staged in shared memory by
``cp.async`` (:mod:`~repro_torch.core.staging` decides, here at
translation); static-trip loops are unrolled by 8.

Block kernel: ``⌈N / (4 BLOCK)⌉`` CUDA blocks of ``BLOCK`` threads (``BLOCK``
from ``passes.choose_block``), each thread running the segment for
``LANES_PER_THREAD = 4`` lanes ``BLOCK`` apart (lane = flat global id,
split into hetIR block and thread by 32-bit division below 2^31 lanes),
so that each thread has several lanes' loads in flight; no shared memory,
no barriers.

Both modes read and write only the registers that cross the segment's
boundary (:class:`SegmentSlots`, from :mod:`~repro_torch.core.liveness`):
in, those whose incoming value some lane may read (read before written,
or defined only in part and live after it); out, those it defines that
some later node may read.  An elementwise segment such as ``vadd``'s
moves its buffers and no register array.

Bound on this card: the segment kernels of the decode path are latency- and
launch-bound (tens of short segments per launch, folds between barriers,
one CUDA block per hetIR block); the block kernel of an elementwise
segment is bound by device memory bandwidth.  The numbers are in PERF.md.

On a tensor that lies on the CPU the backend runs the plain version
(:func:`~repro_torch.core.backends.semantics.run_segment_plain`); on CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import AbstractSet, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import hetir as ir
from ..alias import affine_env, index_form
from ..cache import TranslationCache, note_restore_detail, register_reviver
from ..passes import (_THREAD_BASES, _decompose, _uniform_regs, block_lower,
                      choose_block, refusal_category)
from ..liveness import live_out, segment_inputs, segment_outputs
from ..segments import SegNode, program_nodes
from ..staging import (STAGE_BUDGET_BYTES, plan_staging, segment_prelude,
                       stage_layout, stage_words, staged_loads)
from . import nvcc_build
from .base import Backend, HostState, Launch, torch_dtype
from .semantics import (operand_dtype, run_segment_plain, segment_reg_dtypes,
                        serial_segment)

#: the most threads a scalar kernel's block runs: a hetIR block of T lanes
#: runs ``lanes_per_thread(T)`` lanes a thread
MAX_BLOCK = 1024
#: lanes a thread of the block kernel runs
LANES_PER_THREAD = 4
#: argument slots of ``HetArgs``: pointers, buffer lengths (the first
#: pointer slots are the global buffers), scalars — sized to keep the
#: struct under the 4 KB kernel-parameter limit.  The one definition: every
#: generated module passes them to csrc/hetir_rt.cuh as ``HET_MAX_*`` and
#: asserts the struct's size against the ctypes mirror below
MAX_PTRS, MAX_BUFS, MAX_SCALARS = 400, 64, 32

_CT = {ir.F32: "float", ir.I32: "int", ir.U32: "unsigned", ir.BOOL: "bool"}
_SFX = {ir.F32: "f32", ir.I32: "i32", ir.U32: "u32", ir.BOOL: "bool"}
_BYTES = {ir.F32: 4, ir.I32: 4, ir.U32: 4, ir.BOOL: 1}
_CMP = {ir.LT: "<", ir.LE: "<=", ir.GT: ">", ir.GE: ">=", ir.EQ: "==",
        ir.NE: "!="}


def _cvt(expr: str, src: str, dst: str) -> str:
    return expr if src == dst else f"het_cvt_{_SFX[src]}_{_SFX[dst]}({expr})"


def _const(value, dtype: str) -> str:
    """C literal of ``value`` converted as NumPy converts it (exact bits)."""
    v = ir.np_dtype(dtype).type(value)
    if dtype == ir.F32:
        return f"__uint_as_float({int(v.view(np.uint32)):#010x}u)"
    if dtype == ir.I32:
        return f"((int){int(v) & 0xFFFFFFFF:#010x}u)"
    if dtype == ir.U32:
        return f"{int(v):#010x}u"
    return "true" if bool(v) else "false"


def _binop(oc: str, a: str, b: str, dt: str) -> str:
    if oc in _CMP:
        return f"({a} {_CMP[oc]} {b})"
    if dt == ir.BOOL:
        ops = {ir.AND: "&&", ir.OR: "||", ir.XOR: "!="}
        if oc in ops:
            return f"({a} {ops[oc]} {b})"
    elif dt == ir.F32:
        fn = {ir.ADD: "__fadd_rn", ir.SUB: "__fsub_rn", ir.MUL: "__fmul_rn",
              ir.DIV: "__fdiv_rn", ir.MOD: "het_mod_f32",
              ir.MIN: "het_min_f32", ir.MAX: "het_max_f32"}.get(oc)
        if fn:
            return f"{fn}({a}, {b})"
    else:
        if oc in (ir.AND, ir.OR, ir.XOR):
            return f"({a} {dict(AND='&', OR='|', XOR='^')[oc]} {b})"
        if dt == ir.U32 and oc in (ir.ADD, ir.SUB, ir.MUL):
            return f"({a} {dict(ADD='+', SUB='-', MUL='*')[oc]} {b})"
        fn = {ir.ADD: "add", ir.SUB: "sub", ir.MUL: "mul", ir.DIV: "div",
              ir.MOD: "mod", ir.MIN: "min", ir.MAX: "max", ir.SHL: "shl",
              ir.SHR: "shr"}.get(oc)
        if fn and not (dt == ir.U32 and fn in ("add", "sub", "mul")):
            return f"het_{fn}_{_SFX[dt]}({a}, {b})"
    raise NotImplementedError(f"{oc} on {dt}")


def _unop(oc: str, a: str, dt: str) -> str:
    if oc == ir.MOV:
        return a
    if dt == ir.BOOL and oc == ir.NOT:
        return f"(!{a})"
    if dt == ir.F32:
        fn = {ir.NEG: "-", ir.ABS: "fabsf", ir.SQRT: "__fsqrt_rn",
              ir.EXP: "het_exp_f32"}.get(oc)
        if fn:
            return f"({fn}({a}))"
    elif dt == ir.I32:
        fn = {ir.NEG: "het_neg_i32", ir.ABS: "het_abs_i32", ir.NOT: "~"}.get(oc)
        if fn:
            return f"({fn}({a}))"
    elif dt == ir.U32:
        if oc == ir.NEG:
            return f"(0u - {a})"
        if oc == ir.ABS:
            return a
        if oc == ir.NOT:
            return f"(~{a})"
    raise NotImplementedError(f"{oc} on {dt}")


class SegmentSlots:
    """Argument slots of one segment's kernels (both modes share them).
    ``live`` names the registers live after the segment
    (:func:`~repro_torch.core.liveness.live_out`): only those are written
    out, and a register defined only in part is read in only if it is one
    of them (:func:`~repro_torch.core.liveness.segment_inputs`)."""

    def __init__(self, seg: SegNode, prog: ir.Program, live: AbstractSet):
        self.reg_dtypes = segment_reg_dtypes(seg.stmts)
        self.inputs = sorted(segment_inputs(seg, live))
        self.outputs = sorted(segment_outputs(seg, live))
        self.shared = bool(seg.uses_shared and prog.shared_size)
        self.buffers = sorted(seg.greads | seg.gwrites)
        params, counts = set(), set()
        for s in _walk(seg.stmts):
            if isinstance(s, ir.Op) and s.opcode == ir.LD_PARAM:
                params.add(s.args[0])
            elif isinstance(s, ir.Loop) and isinstance(s.count, str):
                counts.add(s.count)
        self.params = sorted(params)
        self.counts = sorted(counts)
        n_ptr = (len(self.inputs) + len(self.outputs) + int(self.shared)
                 + len(self.buffers))
        if n_ptr > MAX_PTRS or len(self.buffers) > MAX_BUFS \
                or len(self.params) + len(self.counts) > MAX_SCALARS:
            raise NotImplementedError(
                f"segment {seg.index} needs {n_ptr} pointers, "
                f"{len(self.buffers)} buffers and "
                f"{len(self.params) + len(self.counts)} scalars "
                f"(HET_MAX_PTRS {MAX_PTRS}, HET_MAX_BUFS {MAX_BUFS}, "
                f"HET_MAX_SCALARS {MAX_SCALARS})")
        self.buf_slot = {n: i for i, n in enumerate(self.buffers)}
        base = len(self.buffers)
        self.shared_slot = base if self.shared else None
        base += int(self.shared)
        self.in_slot = {n: base + i for i, n in enumerate(self.inputs)}
        base += len(self.inputs)
        self.out_slot = {n: base + i for i, n in enumerate(self.outputs)}
        self.param_slot = {n: i for i, n in enumerate(self.params)}
        self.count_slot = {n: len(self.params) + i
                           for i, n in enumerate(self.counts)}


def _walk(stmts):
    for s in stmts:
        yield s
        if isinstance(s, (ir.Pred, ir.Loop)):
            yield from _walk(s.body)


class _SegmentEmitter:
    """Emits the CUDA source of one segment's kernel in one mode: ``"s"``
    (scalar, one CUDA block per hetIR block) or ``"b"`` (block-tiled)."""

    def __init__(self, seg: SegNode, prog: ir.Program, slots: SegmentSlots,
                 mode: str, lanes: int = 1):
        self.seg, self.prog, self.slots, self.mode = seg, prog, slots, mode
        # hetIR lanes a thread of the scalar kernel runs (HL)
        self.lanes = lanes
        self.var = {n: f"r{i}" for i, n in enumerate(sorted(slots.reg_dtypes))}
        self.lines: List[str] = []
        self.depth = 2
        self.n_masks = 0
        self.scratch = False
        self.tree_folds = 0
        stmts = seg.stmts
        # the segment's index arithmetic, seeing through the lane-id chains
        # of earlier segments (staging.segment_prelude; not emitted)
        body = segment_prelude(stmts, prog) + list(stmts)
        self._affine = affine_env(body)
        self._defs = ir.reg_def_counts(body)
        self._uniform = _uniform_regs(body)
        self._kinds = {op.dest.name: _THREAD_BASES[op.opcode]
                       for op in ir.walk_ops(body)
                       if op.dest is not None and op.opcode in _THREAD_BASES
                       and self._defs.get(op.dest.name, 0) == 1}
        # registers every lane writes: defined at the segment's top level,
        # or by a replayed top-level chain of the program
        self._top = {s.dest.name for s in body
                     if isinstance(s, ir.Op) and s.dest is not None}
        # loads staged in shared memory (scalar kernels): load j by op,
        # and the loads staged ahead of each loop nest, by its loop var
        self.staged = staged_loads(plan_staging(stmts, prog, seg.gwrites)) \
            if mode == "s" else []
        ops = list(ir.walk_ops(stmts))
        self._stage_of = {id(ops[ld.op]): j
                          for j, ld in enumerate(self.staged)}
        self._stage_at: Dict[str, List[int]] = {}
        for j, ld in enumerate(self.staged):
            self._stage_at.setdefault(ld.nest, []).append(j)

    # -- helpers -----------------------------------------------------------
    def out(self, line: str) -> None:
        self.lines.append("  " * self.depth + line)

    def sync(self) -> None:
        if self.mode == "s":
            self.out("__syncthreads();")

    def lane(self, line: str) -> None:
        """A statement run for each hetIR lane: in a scalar kernel of
        several lanes a thread, for each of the thread's ``HL`` lanes
        (``HET_LANES``, which defines the lane's ``l_``, ``t`` and
        ``lane``); else as it is (one lane a thread: ``l_`` is 0, ``t``
        and ``lane`` the thread's)."""
        several = self.mode == "s" and self.lanes > 1
        self.out(f"HET_LANES({line})" if several else line)

    def reg(self, name: str) -> str:
        """Register ``name`` of the current lane: the scalar kernel keeps a
        register as an array of the thread's ``HL`` lanes."""
        return f"{self.var[name]}[l_]" if self.mode == "s" else self.var[name]

    def val(self, a, dtype: str) -> str:
        if isinstance(a, ir.Reg):
            if a.dtype != dtype:
                raise NotImplementedError(
                    f"operand %{a.name}:{a.dtype} where {dtype} is expected")
            return self.reg(a.name)
        return _const(a, dtype)

    def idx(self, a) -> str:
        if isinstance(a, ir.Reg):
            return f"het_idx({self.reg(a.name)})"
        return f"((long long){int(a)})"

    def assign(self, d: ir.Reg, expr: str, vtype: str,
               m: Optional[str]) -> str:
        line = f"{self.reg(d.name)} = {_cvt(expr, vtype, d.dtype)};"
        return line if m is None else f"if ({m}) {line}"

    def write(self, d: ir.Reg, expr: str, vtype: str, m: Optional[str]) -> None:
        self.lane(self.assign(d, expr, vtype, m))

    def lane_unique(self, idx) -> bool:
        """Do the lanes of one hetIR block always store to distinct
        addresses?  True when the index is ``±tid + (block-uniform
        terms)``, whatever the block size, and every lane computed it (a
        register a lane never wrote reads 0, which could collide)."""
        if not isinstance(idx, ir.Reg) or idx.name not in self._top:
            return False
        form = index_form(idx, self._affine, self._defs)
        if form is None or any(b not in self._top for b, _ in form.terms):
            return False
        dec = _decompose(form, self._kinds, self._uniform, 1)
        return dec is not None and abs(dec[0]) == 1

    def active(self, m: Optional[str]) -> str:
        return "true" if m is None else m

    def need_scalar(self, what: str) -> None:
        if self.mode != "s":
            raise AssertionError(f"{what} in a block-lowered segment")
        self.scratch = True

    def stage(self, j: int) -> None:
        """Copy staged load ``j``'s window into shared memory (all threads;
        thread 0 computes where the window starts from lane 0's
        registers)."""
        ld = self.staged[j]
        k = self.slots.buf_slot[ld.buf]
        u = [f"(long long){c} * (long long){self.var[r]}[0]"
             for r, c in ld.uniform]
        if ld.block:
            u.append(f"(long long){ld.block} * b")
        if ld.gid_block:
            u.append(f"(long long){ld.gid_block} * ((long long)b * T)")
        u.append(f"({ld.const}ll)")
        lo, hi = ld.offsets(1)
        self.out("__syncthreads();")
        self.out(f"if (tid == 0) het_stage_window({' + '.join(u)}, {lo}ll, "
                 f"{hi}ll, {ld.lane}ll, T, son{j}, stw + {2 * j});")
        self.out("__syncthreads();")
        self.out(f"sw{j} = stw[{2 * j}]; sl{j} = stw[{2 * j + 1}];")
        self.out(f"het_stage_copy<{ld.row()}>(st{j}, sw{j}, sl{j}, g{k}, "
                 f"n{k}, tid, NT);")

    # -- statements ----------------------------------------------------------
    def stmts(self, body: Sequence[ir.Stmt], m: Optional[str]) -> None:
        for s in body:
            if isinstance(s, ir.Op):
                self.op(s, m)
            elif isinstance(s, ir.Pred):
                self.n_masks += 1
                inner = f"m{self.n_masks}"
                cond = f"het_truth({self.reg(s.cond.name)})"
                cond = cond if m is None else f"{m} && {cond}"
                self.out("{")
                self.depth += 1
                if self.mode == "s":
                    self.out(f"bool {inner}[HL];")
                    self.lane(f"{inner}[l_] = {cond};")
                    inner += "[l_]"
                else:
                    self.out(f"const bool {inner} = {cond};")
                self.stmts(s.body, inner)
                self.depth -= 1
                self.out("}")
            elif isinstance(s, ir.Loop):
                count = str(int(s.count)) if isinstance(s.count, int) \
                    else f"((int)a.sc[{self.slots.count_slot[s.count]}])"
                self.n_masks += 1
                it = f"it{self.n_masks}"
                for j in self._stage_at.get(s.var.name, ()):
                    self.stage(j)
                if self._stage_at.get(s.var.name):
                    self.out("het_stage_wait();")
                    self.out("__syncthreads();")
                if isinstance(s.count, int):
                    # independent loads issue ahead of the dependent chain;
                    # no float operation is reordered
                    self.out("#pragma unroll 8")
                self.out(f"for (int {it} = 0; {it} < {count}; ++{it}) {{")
                self.depth += 1
                self.write(s.var, it, ir.I32, m)
                self.stmts(s.body, m)
                self.depth -= 1
                self.out("}")
            else:
                raise AssertionError(f"{type(s).__name__} inside a segment")

    def op(self, op: ir.Op, m: Optional[str]) -> None:
        oc, d = op.opcode, op.dest
        if oc == ir.GET_GLOBAL_ID:
            # b * T + t, wrapped to 32 bits
            self.write(d, "((int)(unsigned long long)lane)", ir.I32, m)
        elif oc == ir.GET_BLOCK_ID:
            self.write(d, "b", ir.I32, m)
        elif oc == ir.GET_THREAD_ID:
            self.write(d, "t", ir.I32, m)
        elif oc == ir.GET_BLOCK_DIM:
            self.write(d, "T", ir.I32, m)
        elif oc == ir.GET_NUM_BLOCKS:
            self.write(d, "a.num_blocks", ir.I32, m)
        elif oc == ir.CONST:
            self.write(d, _const(op.args[0], d.dtype), d.dtype, m)
        elif oc == ir.LD_PARAM:
            p = self.prog.param(op.args[0])
            self.write(d, f"het_{_SFX[p.dtype]}"
                          f"(a.sc[{self.slots.param_slot[p.name]}])",
                       p.dtype, m)
        elif oc in (ir.MOV, ir.CVT):
            a = op.args[0]
            dt = a.dtype if isinstance(a, ir.Reg) else d.dtype
            self.write(d, self.val(a, dt), dt, m)
        elif oc in ir.ALU_BINARY or oc in ir.CMP_OPS:
            dt = operand_dtype(op)
            expr = _binop(oc, self.val(op.args[0], dt),
                          self.val(op.args[1], dt), dt)
            self.write(d, expr, ir.BOOL if oc in ir.CMP_OPS else dt, m)
        elif oc in ir.ALU_UNARY:
            dt = operand_dtype(op)
            self.write(d, _unop(oc, self.val(op.args[0], dt), dt), dt, m)
        elif oc == ir.FMA:
            dt = operand_dtype(op)
            a, b, c = (self.val(x, dt) for x in op.args)
            self.write(d, _binop(ir.ADD, _binop(ir.MUL, a, b, dt), c, dt),
                       dt, m)
        elif oc == ir.SELECT:
            cv = op.args[0]
            ct = cv.dtype if isinstance(cv, ir.Reg) else ir.BOOL
            vals = []
            for x in op.args[1:]:
                xt = x.dtype if isinstance(x, ir.Reg) else d.dtype
                vals.append(_cvt(self.val(x, xt), xt, d.dtype))
            cond = f"het_truth({self.val(cv, ct)})" if ct != ir.BOOL \
                else self.val(cv, ct)
            self.write(d, f"({cond} ? {vals[0]} : {vals[1]})", d.dtype, m)
        elif oc in (ir.LD_GLOBAL, ir.BLOCK_LD):
            k = self.slots.buf_slot[op.args[0]]
            bdt = self.prog.param(op.args[0]).dtype
            j = self._stage_of.get(id(op))
            if j is not None:
                expr = (f"het_stage_ld<{self.staged[j].row()}>(st{j}, sw{j}, "
                        f"sl{j}, g{k}, n{k}, {self.idx(op.args[1])})")
            else:
                ld = "het_ld" if op.args[0] in self.seg.gwrites else "het_ldg"
                expr = f"{ld}(g{k}, n{k}, {self.idx(op.args[1])})"
            self.write(d, expr, bdt, m)
        elif oc in (ir.ST_GLOBAL, ir.BLOCK_ST):
            k = self.slots.buf_slot[op.args[0]]
            bdt = self.prog.param(op.args[0]).dtype
            v = op.args[2]
            vt = v.dtype if isinstance(v, ir.Reg) else bdt
            self.store(f"g{k}", f"n{k}", op.args[1],
                       _cvt(self.val(v, vt), vt, bdt), bdt, m)
        elif oc == ir.ATOMIC_ADD:
            self.atomic(op, m)
        elif oc == ir.LD_SHARED:
            sdt = self.prog.shared_dtype
            self.write(d, f"het_ld(sh, (long long){self.prog.shared_size}, "
                          f"{self.idx(op.args[0])})", sdt, m)
        elif oc == ir.ST_SHARED:
            sdt = self.prog.shared_dtype
            v = op.args[1]
            vt = v.dtype if isinstance(v, ir.Reg) else sdt
            self.store("sh", f"(long long){self.prog.shared_size}", op.args[0],
                       _cvt(self.val(v, vt), vt, sdt), sdt, m)
        elif oc in ir.COLLECTIVE_OPS:
            self.collective(op, m)
        else:  # pragma: no cover
            raise NotImplementedError(oc)

    # -- memory ----------------------------------------------------------------
    def store(self, ptr: str, n: str, idx_arg, value: str, dt: str,
              m: Optional[str]) -> None:
        line = f"het_st({ptr}, {n}, {self.idx(idx_arg)}, {value});"
        if self.mode == "b":
            self.lane(line if m is None else f"if ({m}) {line}")
            return
        self.sync()
        if self.lane_unique(idx_arg):
            self.lane(line if m is None else f"if ({m}) {line}")
        else:
            # lanes may collide: thread 0 applies the stores in lane order,
            # so the highest active lane wins
            self.need_scalar("serialized store")
            self.lane(f"scr_a[t] = {self.active(m)}; "
                      f"scr_i[t] = {self.idx(idx_arg)}; "
                      f"scr_v[t] = het_bits({value});")
            self.sync()
            self.out("if (tid == 0) for (int l = 0; l < T; ++l) if (scr_a[l]) "
                     f"het_st({ptr}, {n}, scr_i[l], het_{_SFX[dt]}(scr_v[l]));")
        self.sync()

    def atomic(self, op: ir.Op, m: Optional[str]) -> None:
        self.need_scalar("ATOMIC_ADD")
        name = op.args[0]
        k = self.slots.buf_slot[name]
        bdt = self.prog.param(name).dtype
        add = _binop(ir.ADD, "o_", f"het_{_SFX[bdt]}(scr_v[l])", bdt)
        self.sync()
        self.lane(f"scr_a[t] = {self.active(m)}; "
                  f"scr_i[t] = {self.idx(op.args[1])}; "
                  f"scr_v[t] = het_bits({self.val(op.args[2], bdt)});")
        self.sync()
        # lane order within the block, block order from the serial walk
        self.out("if (tid == 0) for (int l = 0; l < T; ++l) if (scr_a[l]) {")
        self.out(f"  long long i_ = scr_i[l]; if (i_ < 0) i_ += n{k};")
        self.out(f"  {_CT[bdt]} o_ = {_const(0, bdt)};")
        self.out(f"  if (i_ >= 0 && i_ < n{k}) {{ o_ = g{k}[i_]; "
                 f"g{k}[i_] = {add}; }}")
        self.out("  scr_o[l] = het_bits(o_);")
        self.out("}")
        self.sync()
        if op.dest is not None:
            self.write(op.dest, f"het_{_SFX[bdt]}(scr_o[t])", bdt, m)
        self.sync()

    # -- collectives -----------------------------------------------------------
    def collective(self, op: ir.Op, m: Optional[str]) -> None:
        oc, d = op.opcode, op.dest
        act = self.active(m)
        if oc in (ir.VOTE_ANY, ir.VOTE_ALL, ir.VOTE_BALLOT):
            if self.mode != "s":
                raise AssertionError(f"{oc} in a block-lowered segment")
            a = op.args[0]
            p = f"het_truth({self.reg(a.name)})" if isinstance(a, ir.Reg) \
                else ("true" if bool(a) else "false")
            self.n_masks += 1
            v = f"v{self.n_masks}"
            # a thread combines its lanes' votes, then the block the threads'
            if oc == ir.VOTE_ANY:
                self.out(f"bool {v} = false;")
                self.lane(f"{v} = {v} || ({act} && {p});")
                self.out(f"{v} = __syncthreads_or({v});")
                self.write(d, v, ir.BOOL, m)
            elif oc == ir.VOTE_ALL:
                self.out(f"bool {v} = true;")
                self.lane(f"{v} = {v} && (!({act}) || {p});")
                self.out(f"{v} = __syncthreads_and({v});")
                self.write(d, v, ir.BOOL, m)
            else:
                # the count of voting lanes: one barrier per lane slot
                self.out(f"bool {v}p[HL] = {{}};")
                self.lane(f"{v}p[l_] = {act} && {p};")
                self.out(f"int {v} = 0;")
                self.out(f"for (int l_ = 0; l_ < HL; ++l_) "
                         f"{v} += __syncthreads_count({v}p[l_]);")
                self.write(d, v, ir.I32, m)
            return
        self.need_scalar(oc)
        if oc == ir.SHUFFLE:
            src = op.args[0]
            self.sync()
            self.lane(f"scr_v[t] = het_bits({self.reg(src.name)});")
            self.sync()
            self.n_masks += 1
            s = f"s{self.n_masks}"
            get = self.assign(d, f"het_{_SFX[src.dtype]}(scr_v[{s}])",
                              src.dtype, m)
            self.lane(f"{{ long long {s} = {self.idx(op.args[1])}; "
                      f"{s} = {s} < 0 ? 0 : ({s} > T - 1 ? T - 1 : {s}); "
                      f"{get} }}")
            self.sync()
            return
        dt = d.dtype if oc == ir.REDUCE_ADD else operand_dtype(op)
        if dt not in (ir.F32, ir.I32, ir.U32):
            raise NotImplementedError(f"{oc} on {dt}")
        ct, sfx = _CT[dt], _SFX[dt]
        val = self.val(op.args[0], dt)
        self.sync()
        # the thread's lanes' flags and values (lanes past T stay inactive)
        self.n_masks += 1
        x = f"x{self.n_masks}"
        self.out(f"bool {x}a[HL] = {{}}; {ct} {x}v[HL] = {{}};")
        self.lane(f"{x}a[l_] = {act}; {x}v[l_] = {val};")
        if oc == ir.REDUCE_MAX:
            # a shuffle tree whose ties resolve as the lane-order fold's
            self.out(f"const {ct} {x} = het_block_max<{ct}>({x}a, {x}v, tid, "
                     "NT, T, scr_a, scr_v, scr_r);")
            self.tree_folds += 1
            self.write(d, x, dt, m)
        elif oc in (ir.REDUCE_ADD, ir.SCAN_ADD):
            # from the zero of the destination dtype, in lane order
            scan = "true" if oc == ir.SCAN_ADD else "false"
            self.out(f"het_block_add<{ct}, {scan}>({x}a, {x}v, tid, NT, T, "
                     "scr_a, scr_v, scr_o, scr_r);")
            res = "scr_o[t]" if oc == ir.SCAN_ADD else "scr_r[0]"
            self.write(d, f"het_{sfx}({res})", dt, m)
        else:  # pragma: no cover
            raise NotImplementedError(oc)
        self.sync()

    # -- the kernel ----------------------------------------------------------
    def stage_head(self) -> None:
        """Where each staged window lives: after the scratch area, 16-byte
        aligned, the windows' starts and lengths, then each window that
        fits the budget at this block size (``staging.stage_layout``)."""
        sl, prog = self.slots, self.prog
        words = f"{shared_words(prog, sl)}"
        if self.scratch:
            words += " + (T + (T & 1)) + 2 * T + T + T + 2"
        self.out(f"const long long stb = ({words} + 3) / 4 * 4;")
        self.out("long long* stw = (long long*)(het_smem + stb);")
        self.out("long long su_ = 0;")
        for j, ld in enumerate(self.staged):
            lo, hi = ld.offsets(1)
            ct = _CT[prog.param(ld.buf).dtype]
            self.out(f"const long long sp{j} = het_stage_words({lo}ll, {hi}ll, "
                     f"{ld.lane}ll, T, {ld.row()}ll);")
            self.out(f"const bool son{j} = (su_ + sp{j}) * 4 <= "
                     f"{STAGE_BUDGET_BYTES}ll;")
            self.out(f"{ct}* st{j} = ({ct}*)(het_smem + stb + "
                     f"{4 * len(self.staged)} + su_);")
            self.out(f"if (son{j}) su_ += sp{j};")

    def kernel(self, name: str) -> str:
        sl, prog = self.slots, self.prog
        self.stmts(self.seg.stmts, None)
        body = self.lines
        self.lines = []
        self.depth = 1
        head = [f'extern "C" __global__ void __launch_bounds__({MAX_BLOCK}) '
                f"{name}(const HetArgs a) {{"]
        self.out("const int T = a.block_size;")
        if self.mode == "s":
            # the thread runs hetIR lanes tid + l_ * NT, l_ < HL, of each
            # block it walks (HET_LANES)
            self.out(f"constexpr int HL = {self.lanes};")
            self.out("extern __shared__ unsigned int het_smem[];")
            self.out("const int tid = threadIdx.x, NT = "
                     f"{'blockDim.x' if self.lanes > 1 else 'T'};")
            if sl.shared:
                sct = _CT[prog.shared_dtype]
                self.out(f"{sct}* sh = reinterpret_cast<{sct}*>(het_smem);")
                self.out(f"{sct}* shg = ({sct}*)a.ptr[{sl.shared_slot}];")
            if self.scratch:
                self.out(f"unsigned* scr = het_smem + {shared_words(prog, sl)};")
                self.out("int* scr_a = (int*)scr;")
                self.out("long long* scr_i = (long long*)(scr + het_even(T));")
                self.out("unsigned* scr_v = scr + het_even(T) + 2 * T;")
                self.out("unsigned* scr_o = scr_v + T;")
                self.out("unsigned* scr_r = scr_o + T;")
            if self.staged:
                self.stage_head()
        for n in sl.buffers:
            k = sl.buf_slot[n]
            ct = _CT[prog.param(n).dtype]
            # a buffer the segment never writes: read-only, unaliased
            const, rs = ("", "") if n in self.seg.gwrites \
                else ("const ", " __restrict__")
            self.out(f"{const}{ct}*{rs} g{k} = ({const}{ct}*)a.ptr[{k}];")
            self.out(f"const long long n{k} = a.len[{k}];")
        for n in sl.inputs:
            ct = _CT[sl.reg_dtypes[n]]
            self.out(f"const {ct}* i{sl.in_slot[n]} = "
                     f"(const {ct}*)a.ptr[{sl.in_slot[n]}];")
        for n in sl.outputs:
            ct = _CT[sl.reg_dtypes[n]]
            self.out(f"{ct}* o{sl.out_slot[n]} = ({ct}*)a.ptr[{sl.out_slot[n]}];")
        if self.mode == "s":
            self.out("for (int b = blockIdx.x; b < a.num_blocks; "
                     "b += gridDim.x) {")
            if self.lanes == 1:
                self.out("  constexpr int l_ = 0;")
                self.out("  const int t = tid;")
                self.out("  const long long lane = (long long)b * T + t;")
        else:
            # LANES_PER_THREAD lanes a thread, blockDim.x apart (coalesced),
            # so that each thread keeps several lanes' loads in flight
            self.out("const long long lanes = (long long)a.num_blocks * T;")
            self.out("const long long lane0 = (long long)blockIdx.x * "
                     f"blockDim.x * {LANES_PER_THREAD} + threadIdx.x;")
            self.out("#pragma unroll")
            self.out(f"for (int k_ = 0; k_ < {LANES_PER_THREAD}; ++k_) {{")
            self.out("  const long long lane = lane0 + (long long)k_ * "
                     "blockDim.x;")
            self.out("  if (lane >= lanes) break;")
            # 32-bit division below 2^31 lanes (one uniform branch)
            self.out("  int b, t;")
            self.out("  if (lanes <= 0x7fffffffll) {")
            self.out("    b = (int)((unsigned)lane / (unsigned)T);")
            self.out("    t = (int)((unsigned)lane - (unsigned)b * "
                     "(unsigned)T);")
            self.out("  } else {")
            self.out("    b = (int)(lane / T);")
            self.out("    t = (int)(lane - (long long)b * T);")
            self.out("  }")
        self.depth = 2
        for n in sorted(sl.reg_dtypes):
            dt = sl.reg_dtypes[n]
            zero = _const(0, dt)
            init = zero if n not in sl.in_slot else \
                f"i{sl.in_slot[n]} ? i{sl.in_slot[n]}[lane] : {zero}"
            if self.mode == "s":
                self.out(f"{_CT[dt]} {self.var[n]}[HL];  // %{n}")
                self.lane(f"{self.reg(n)} = {init};")
            else:
                self.out(f"{_CT[dt]} {self.var[n]} = {init};  // %{n}")
        for j in range(len(self.staged)):
            self.out(f"long long sw{j} = 0, sl{j} = 0;  // staged window {j}")
        if self.mode == "s" and sl.shared:
            self.out(f"for (int i = tid; i < {prog.shared_size}; i += NT) "
                     f"sh[i] = shg[(long long)b * {prog.shared_size} + i];")
            self.out("__syncthreads();")
        decls = self.lines
        self.lines = []
        if self.mode == "s" and sl.shared:
            self.out("__syncthreads();")
            self.out(f"for (int i = tid; i < {prog.shared_size}; i += NT) "
                     f"shg[(long long)b * {prog.shared_size} + i] = sh[i];")
        for n in sl.outputs:
            self.lane(f"o{sl.out_slot[n]}[lane] = {self.reg(n)};")
        if self.mode == "s":
            self.out("__syncthreads();")
        tail = self.lines
        head.extend(decls)
        head.extend(body)
        head.extend(tail)
        head.append("  }")
        head.append("}")
        return "\n".join(head)


def shared_words(prog: ir.Program, slots: SegmentSlots) -> int:
    """32-bit words of dynamic shared memory before the scratch area (the
    staged hetIR shared row, rounded up to 8-byte alignment)."""
    if not slots.shared:
        return 0
    words = -(-prog.shared_size * _BYTES[prog.shared_dtype] // 4)
    return words + (words & 1)


def smem_bytes(prog: ir.Program, slots: SegmentSlots, scratch: bool,
               T: int, staged: Sequence = ()) -> int:
    """Dynamic shared memory of a scalar kernel at block size ``T``: the
    hetIR shared row, the scratch area, the staged windows."""
    words = shared_words(prog, slots)
    if scratch:
        words += (T + (T & 1)) + 2 * T + T + T + 2
    if staged:
        words = -(-words // 4) * 4 + stage_words(staged, T)
    return 4 * words


class SegmentKernels:
    """What the translator produced for one segment: its slots, which
    kernels exist, whether the scalar kernel needs scratch, the loads it
    stages and the number of its shuffle-tree folds."""

    def __init__(self, index: int, slots: SegmentSlots, scratch: bool,
                 has_block: bool, serial: bool, staged: Sequence = (),
                 tree_folds: int = 0):
        self.index = index
        self.slots = slots
        self.scratch = scratch
        self.staged = list(staged)
        self.tree_folds = tree_folds
        self.has_block = has_block
        self.serial = serial


def lanes_per_thread(T: int) -> int:
    """hetIR lanes a thread of the scalar kernel runs for blocks of ``T``
    lanes: 1 up to :data:`MAX_BLOCK`, then ``⌈T / MAX_BLOCK⌉`` (the
    kernel's ``HL``, a compile-time constant: one library per value)."""
    return max(1, -(-T // MAX_BLOCK))


def _launcher(kname: str) -> str:
    return "\n".join([
        f'extern "C" int launch_{kname}(const HetArgs* a, int grid, '
        "int block, unsigned smem, void* stream) {",
        "  if (smem > 48u * 1024u) {",
        f"    cudaError_t e = cudaFuncSetAttribute({kname}, "
        "cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);",
        "    if (e != cudaSuccess) return (int)e;",
        "  }",
        f"  {kname}<<<grid, block, smem, (cudaStream_t)stream>>>(*a);",
        "  return (int)cudaGetLastError();",
        "}"])


def _block_capable(seg: SegNode) -> bool:
    """Could ``block_lower`` accept this segment at some geometry?  (Its
    geometry-free refusals: shared memory, collectives, atomics.)"""
    for op in ir.walk_ops(seg.stmts):
        if op.opcode in (ir.LD_SHARED, ir.ST_SHARED, ir.ATOMIC_ADD) \
                or op.opcode in ir.COLLECTIVE_OPS:
            return False
    return True


def emit_module(prog: ir.Program, lanes: int = 1
                ) -> Tuple[str, Dict[int, SegmentKernels]]:
    """CUDA source of every segment kernel of an optimized program, with
    the per-segment launch metadata; the scalar kernels run ``lanes`` hetIR
    lanes a thread (:func:`lanes_per_thread`).  Deterministic in the
    program and ``lanes``."""
    parts = ["// hetIR -> CUDA C++ segment kernels (repro_torch translator)",
             f"// program {prog.name} {ir.program_fingerprint(prog)}, "
             f"{lanes} lane(s) a thread",
             f"#define HET_MAX_PTRS {MAX_PTRS}",
             f"#define HET_MAX_BUFS {MAX_BUFS}",
             f"#define HET_MAX_SCALARS {MAX_SCALARS}",
             '#include "hetir_rt.cuh"',
             f"static_assert(sizeof(HetArgs) == {ctypes.sizeof(HetArgs)}, "
             '"HetArgs differs from its ctypes mirror");', ""]
    kernels: Dict[int, SegmentKernels] = {}
    for seg in program_nodes(prog):
        if not isinstance(seg, SegNode):
            continue
        slots = SegmentSlots(seg, prog, live_out(prog, seg))
        em = _SegmentEmitter(seg, prog, slots, "s", lanes)
        parts.append(f"// segment {seg.index} ({seg.label}): scalar")
        parts.append(em.kernel(f"het_seg{seg.index}_s"))
        parts.append(_launcher(f"het_seg{seg.index}_s"))
        block = _block_capable(seg)
        if block:
            parts.append(f"// segment {seg.index} ({seg.label}): block")
            parts.append(_SegmentEmitter(seg, prog, slots, "b")
                         .kernel(f"het_seg{seg.index}_b"))
            parts.append(_launcher(f"het_seg{seg.index}_b"))
        kernels[seg.index] = SegmentKernels(seg.index, slots, em.scratch,
                                            block, serial_segment(seg),
                                            em.staged, em.tree_folds)
        parts.append("")
    return "\n".join(parts), kernels


class HetArgs(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p * MAX_PTRS),
                ("len", ctypes.c_longlong * MAX_BUFS),
                ("sc", ctypes.c_uint * MAX_SCALARS),
                ("num_blocks", ctypes.c_int),
                ("block_size", ctypes.c_int)]


#: one ``ctypes`` handle per library path in the process: two sessions
#: that build or revive the same module share it
_LIBS: Dict[str, ctypes.CDLL] = {}
_LIBS_LOCK = threading.Lock()


def _load_library(path) -> ctypes.CDLL:
    with _LIBS_LOCK:
        lib = _LIBS.get(str(path))
        if lib is None:
            lib = _LIBS[str(path)] = ctypes.CDLL(str(path))
        return lib


class _Module:
    """A loaded library of one optimized program's segment kernels."""

    def __init__(self, path, kernels: Dict[int, SegmentKernels]):
        self.path = path
        self.lib = _load_library(path)
        self.kernels = kernels
        self.fns = {}
        for k in kernels.values():
            for mode in ("s", "b") if k.has_block else ("s",):
                fn = getattr(self.lib, f"launch_het_seg{k.index}_{mode}")
                fn.argtypes = [ctypes.POINTER(HetArgs), ctypes.c_int,
                               ctypes.c_int, ctypes.c_uint, ctypes.c_void_p]
                fn.restype = ctypes.c_int
                self.fns[(k.index, mode)] = fn


def _revive_module(payload) -> _Module:
    """Reviver of a persisted ``"cuda-module"``: write the library back
    under its content-addressed name when it is missing (temp file, then
    ``os.replace``: a library this process already loaded is never
    overwritten) and load it.  No ``nvcc`` runs."""
    path, written = nvcc_build.install_library(payload["name"],
                                               payload["library"])
    note_restore_detail(library_written=written)
    return _Module(path, payload["kernels"])


register_reviver("cuda-module", _revive_module)


def _scalar_bits(value, dtype: str) -> int:
    v = ir.np_dtype(dtype).type(value)
    if dtype == ir.F32:
        return int(v.view(np.uint32))
    if dtype == ir.BOOL:
        return int(bool(v))
    return int(v) & 0xFFFFFFFF


class CudaBackend(Backend):
    name = "cuda"

    def __init__(self, cache: Optional[TranslationCache] = None,
                 device=None):
        super().__init__(cache, device)
        # which path each segment execution took, and why the block path
        # was refused (the reference pallas backend's surface)
        self.block_stats: Dict[str, object] = \
            {"tiled": 0, "scalar": 0, "reasons": {}}
        # kernel launches, counted where the launch happens (the plain
        # version on CPU tensors launches nothing)
        self.launches = {"scalar": 0, "block": 0}
        # of the scalar launches: those that staged a window in shared
        # memory, and those that ran a shuffle-tree REDUCE_MAX
        self.scalar_paths = {"staged": 0, "tree_fold": 0}
        # nvcc runs this backend's module builds made: libraries built and
        # the wall time of the build calls that built them
        self.nvcc = {"built": 0, "seconds": 0.0}
        self._nvcc_lock = threading.Lock()

    # -- translation -----------------------------------------------------------
    def _module_key(self, prog: ir.Program, lanes: int) -> Tuple:
        """Cache key of one optimized program's library at ``lanes`` hetIR
        lanes a thread; ``codegen_tag`` names the translator, the device
        runtime header and the flags the emitted source depends on."""
        return ("cuda", ir.program_fingerprint(prog), "module", lanes,
                nvcc_build.codegen_tag())

    def _module(self, prog: ir.Program, lanes: int = 1) -> _Module:
        """The loaded library of ``prog``'s segment kernels, through the
        translation cache: memory, then the local store and the fabric (a
        revived library runs no ``nvcc``), else emit and build it."""
        return self.cache.get_or_translate(self._module_key(prog, lanes),
                                           lambda: self._build(prog, lanes))

    def _build(self, prog: ir.Program, lanes: int):
        src, kernels = emit_module(prog, lanes)
        res = nvcc_build.build([nvcc_build.segment_job(src)])
        if res["built"]:
            with self._nvcc_lock:
                self.nvcc["built"] += res["built"]
                self.nvcc["seconds"] += res["seconds"]
        (path,) = res["paths"]
        payload = {"name": path.name, "library": path.read_bytes(),
                   "kernels": kernels}
        return _Module(path, kernels), ("cuda-module", payload)

    def prebuild(self, programs: Sequence[ir.Program],
                 lanes: int = 1) -> Dict[str, object]:
        """Translate, build and load the segment kernels of several
        optimized programs at once (their scalar kernels at ``lanes`` hetIR
        lanes a thread): one thread per CPU core, each taking a program
        through :meth:`_module`, so the ``nvcc`` runs overlap and every
        module goes through the cache and its stores.  Returns the
        ``nvcc`` builds this made and the wall time."""
        t0 = time.perf_counter()
        before = self.nvcc["built"]
        todo = {self._module_key(p, lanes): p for p in programs}
        with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
            for f in [pool.submit(self._module, p, lanes)
                      for p in todo.values()]:
                f.result()
        return {"modules": len(todo), "built": self.nvcc["built"] - before,
                "seconds": time.perf_counter() - t0}

    def modules(self) -> List[_Module]:
        """The segment libraries the cache holds."""
        return [v for k, v in self.cache.items()
                if k[:1] == ("cuda",) and k[2:3] == ("module",)]

    def _verdict(self, seg: SegNode, launch: Launch,
                 glb_lens: Tuple) -> Tuple[Optional[int], Optional[str]]:
        """(BLOCK, None) when the block path is taken at this geometry,
        else (None, refusal reason) — ``block_lower``'s decision, exactly
        as the reference pallas backend takes it."""
        B, T = launch.num_blocks, launch.block_size

        def decide():
            cand = choose_block(B * T)
            if cand is None:
                return None, "disabled"
            plan, reason = block_lower(seg.stmts, B, T, cand,
                                       buffer_lens=dict(glb_lens))
            return (plan.block, None) if plan is not None else (None, reason)

        key = self._cache_key(seg, launch, B, T, glb_lens)
        return self.cache.get_or_translate(key, lambda: (decide(), None))

    # -- execution -------------------------------------------------------------
    def run_segment(self, seg: SegNode, state: HostState,
                    launch: Launch) -> None:
        tensors = list(state.regs.values()) + list(state.globals_.values())
        if state.shared is not None:
            tensors.append(state.shared)
        on_cuda = {t.is_cuda for t in tensors}
        if len(on_cuda) > 1:
            raise ValueError("segment state is split between CPU and CUDA "
                             "tensors")
        glb_lens = tuple(sorted((n, int(v.shape[0]))
                                for n, v in state.globals_.items()
                                if v.dim() == 1))
        block, reason = self._verdict(seg, launch, glb_lens)
        if block is not None:
            self.block_stats["tiled"] += 1
        else:
            self.block_stats["scalar"] += 1
            rs = self.block_stats["reasons"]
            cat = refusal_category(reason)
            rs[cat] = rs.get(cat, 0) + 1
        if on_cuda != {True}:
            # CPU tensors: the plain version
            run_segment_plain(seg.stmts, state, launch,
                              block is None and serial_segment(seg),
                              self.device, segment_outputs(
                                  seg, live_out(launch.program, seg)))
            return
        self._launch(seg, state, launch, block)

    def _launch(self, seg: SegNode, state: HostState, launch: Launch,
                block: Optional[int]) -> None:
        prog = launch.program
        B, T = launch.num_blocks, launch.block_size
        lanes = 1 if block is not None else lanes_per_thread(T)
        mod = self._module(prog, lanes)
        k = mod.kernels[seg.index]
        sl = k.slots
        dev = next(iter(state.globals_.values())).device if state.globals_ \
            else self.device
        args = HetArgs()
        args.num_blocks, args.block_size = B, T
        keep = []

        def put(slot: int, t: torch.Tensor, dtype: str, shape) -> None:
            if t.dtype != torch_dtype(dtype) or not t.is_contiguous() \
                    or t.device != dev or (shape is not None
                                           and tuple(t.shape) != shape):
                raise ValueError(
                    f"segment {seg.index}: argument {slot} is "
                    f"{t.dtype}{tuple(t.shape)} on {t.device}, expected "
                    f"{torch_dtype(dtype)}{shape} contiguous on {dev}")
            keep.append(t)
            args.ptr[slot] = t.data_ptr()

        for n in sl.inputs:
            if n in state.regs:
                put(sl.in_slot[n], state.regs[n], sl.reg_dtypes[n], (B, T))
        outs = {}
        for n in sl.outputs:
            outs[n] = torch.empty((B, T), dtype=torch_dtype(sl.reg_dtypes[n]),
                                  device=dev)
            put(sl.out_slot[n], outs[n], sl.reg_dtypes[n], (B, T))
        if sl.shared:
            put(sl.shared_slot, state.shared, prog.shared_dtype,
                (B, prog.shared_size))
        for n in sl.buffers:
            put(sl.buf_slot[n], state.globals_[n], prog.param(n).dtype, None)
            args.len[sl.buf_slot[n]] = state.globals_[n].numel()
        for n in sl.params:
            args.sc[sl.param_slot[n]] = _scalar_bits(
                launch.scalars[n], prog.param(n).dtype)
        for n in sl.counts:
            c = min(max(int(launch.scalars[n]), -(1 << 31)), (1 << 31) - 1)
            args.sc[sl.count_slot[n]] = c & 0xFFFFFFFF
        stream = torch.cuda.current_stream(dev).cuda_stream
        if block is not None:
            mode, threads, smem = "b", block, 0
            grid = -(-B * T // (block * LANES_PER_THREAD))
        else:
            mode, threads = "s", -(-T // lanes)
            grid = 1 if k.serial else B
            smem = smem_bytes(prog, sl, k.scratch, T, k.staged)
        err = mod.fns[(seg.index, mode)](ctypes.byref(args), grid, threads,
                                         smem, stream)
        if err != 0:
            raise RuntimeError(
                f"CUDA launch of segment {seg.index} ({mode}) of "
                f"{prog.name} failed: cudaError {err}")
        self.launches["block" if mode == "b" else "scalar"] += 1
        if mode == "s":
            self.scalar_paths["staged"] += any(
                on for on, _, _ in stage_layout(k.staged, T))
            self.scalar_paths["tree_fold"] += k.tree_folds > 0
        state.regs = {**state.regs, **outs}
