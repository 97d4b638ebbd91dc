"""One-op hetIR programs over grids of edge values.

They pin the semantics where a CUDA or PyTorch port would round, wrap or
order differently from the reference interpreter: floor DIV/MOD with a
zero divisor and ``INT_MIN / -1``, shifts by 32 or more, NumPy's x86
float -> integer casts of NaN and out-of-range values, NaN-propagating
MIN/MAX on ``(±0, ±0)``, a float fold of all ``-0.0`` (``+0.0``), folds
and votes under divergence, and the block-then-lane order of atomics and
colliding stores.

Every builder takes the hetIR module to build with (``ir``, default this
package's), so the same programs can be built by the JAX package and held
against its interpreter.  Each case is ``(program, grid, block, args,
outputs)``.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from . import hetir as _ir

F32_EDGES = np.array([0.0, -0.0, 1.0, -1.0, 2.5, -2.5, 3.0, -7.0, 1e-40,
                      -3e-39, 1e30, -1e30, 3.4e38, np.inf, -np.inf, np.nan,
                      2147483648.0, -2147483648.0, 4e9, 1e19, -1e19, 0.5],
                     np.float32)
I32_EDGES = np.array([0, 1, -1, 2, -2, 3, -7, 7, 31, 32, 33, 100, -33,
                      2 ** 31 - 1, -2 ** 31, 12345, -12345], np.int32)
U32_EDGES = np.array([0, 1, 2, 3, 7, 31, 32, 33, 100, 2 ** 31, 2 ** 32 - 1,
                      12345], np.uint32)
EDGES = {_ir.F32: F32_EDGES, _ir.I32: I32_EDGES, _ir.U32: U32_EDGES,
         _ir.BOOL: np.array([True, False] * 3)}

#: (op, dtype) of every binary case
BINARY_CASES = [
    (op, dt) for dt in (_ir.I32, _ir.U32)
    for op in (_ir.DIV, _ir.MOD, _ir.SHL, _ir.SHR, _ir.ADD, _ir.SUB,
               _ir.MUL, _ir.MIN, _ir.MAX, _ir.LT)] + [
    (op, _ir.F32) for op in (_ir.DIV, _ir.MOD, _ir.MIN, _ir.MAX, _ir.ADD,
                             _ir.MUL, _ir.LE, _ir.NE)]
#: (source, destination) dtype of every CVT case
CVT_CASES = [(s, d) for s in (_ir.F32, _ir.I32, _ir.U32, _ir.BOOL)
             for d in (_ir.F32, _ir.I32, _ir.U32, _ir.BOOL) if s != d]
#: float unary ops
UNARY_OPS = [_ir.NEG, _ir.ABS, _ir.SQRT, _ir.EXP]


def pair_grid(values) -> Tuple[np.ndarray, np.ndarray, int]:
    """Every ordered pair of edge values, padded to whole 32-lane blocks;
    returns (a, b, number of blocks)."""
    a, b = np.meshgrid(values, values, indexing="ij")
    a, b = a.reshape(-1), b.reshape(-1)
    n = -(-a.size // 32) * 32
    pad = n - a.size
    return (np.concatenate([a, a[:pad]]), np.concatenate([b, b[:pad]]),
            n // 32)


def binary_case(op: str, dt: str, ir=_ir):
    out_dt = ir.BOOL if op in ir.CMP_OPS else dt
    b = ir.Builder(f"one_{op}_{dt}", [ir.Ptr("A", dt), ir.Ptr("B", dt),
                                      ir.Ptr("Out", out_dt)])
    i = b.global_id(0)
    b.store("Out", i, b._emit(op, out_dt, b.load("A", i), b.load("B", i)))
    a, bb, blocks = pair_grid(EDGES[dt])
    return (b.done(), blocks, 32,
            {"A": a, "B": bb, "Out": np.zeros(a.size, ir.np_dtype(out_dt))},
            ("Out",))


def _unary(op: str, src: str, dst: str, a: np.ndarray, ir):
    b = ir.Builder(f"one_{op}_{src}_{dst}", [ir.Ptr("A", src),
                                             ir.Ptr("Out", dst)])
    i = b.global_id(0)
    b.store("Out", i, b._emit(op, dst, b.load("A", i)))
    return (b.done(), a.size // 32, 32,
            {"A": a, "Out": np.zeros(a.size, ir.np_dtype(dst))}, ("Out",))


def cvt_case(src: str, dst: str, ir=_ir):
    vals = EDGES[src]
    return _unary(ir.CVT, src, dst,
                  np.resize(vals, -(-vals.size // 32) * 32), ir)


def unary_case(op: str, ir=_ir):
    return _unary(op, ir.F32, ir.F32, np.resize(F32_EDGES, 32), ir)


def neg_zero_fold_case(ir=_ir):
    """REDUCE_ADD and SCAN_ADD of all ``-0.0``: the fold starts from
    ``+0.0``, so both give ``+0.0``."""
    b = ir.Builder("neg_zero_fold", [ir.Ptr("A"), ir.Ptr("S"), ir.Ptr("C")])
    i = b.global_id(0)
    x = b.load("A", i)
    b.store("S", i, b.reduce_add(x))
    b.store("C", i, b.scan_add(x))
    return (b.done(), 2, 4, {"A": np.full(8, -0.0, np.float32),
                             "S": np.ones(8, np.float32),
                             "C": np.ones(8, np.float32)}, ("S", "C"))


def divergent_folds_case(ir=_ir):
    """Folds, a scan and a vote under a predicate, over values of mixed
    magnitude with a NaN: lane order decides every rounding."""
    b = ir.Builder("folds", [ir.Ptr("A"), ir.Ptr("R"), ir.Ptr("M"),
                             ir.Ptr("P"), ir.Ptr("V", ir.I32)])
    i = b.global_id(0)
    t = b.thread_id()
    x = b.load("A", i)
    with b.when((t % b.const(3)).ne(b.const(1))):
        b.store("R", i, b.reduce_add(x))
        b.store("M", i, b.reduce_max(x))
        b.store("P", i, b.scan_add(x))
        b.store("V", i, b.ballot(x > b.const(0.0, ir.F32)))
    rng = np.random.default_rng(3)
    a = (rng.standard_normal(64) * 10.0 ** rng.integers(-3, 8, 64)) \
        .astype(np.float32)
    a[5] = np.nan
    return (b.done(), 2, 32, {"A": a, "R": np.zeros(64, np.float32),
                              "M": np.zeros(64, np.float32),
                              "P": np.zeros(64, np.float32),
                              "V": np.zeros(64, np.int32)},
            ("R", "M", "P", "V"))


def atomic_order_case(ir=_ir):
    """Float atomics on one address apply block by block, lane by lane
    (the rounding of every add, and the old value each lane sees, depend
    on it); several lanes storing to one address leave the highest lane's
    value."""
    b = ir.Builder("atomics", [ir.Ptr("A"), ir.Ptr("Acc"), ir.Ptr("Old"),
                               ir.Ptr("Last")])
    i = b.global_id(0)
    t = b.thread_id()
    x = b.load("A", i)
    old = b.atomic_add("Acc", t % b.const(2), x)
    b.store("Old", i, old)
    b.store("Last", t % b.const(4), x)
    rng = np.random.default_rng(5)
    a = (rng.standard_normal(96) * 10.0 ** rng.integers(-4, 9, 96)) \
        .astype(np.float32)
    return (b.done(), 3, 32, {"A": a, "Acc": np.zeros(2, np.float32),
                              "Old": np.zeros(96, np.float32),
                              "Last": np.zeros(4, np.float32)},
            ("Acc", "Old", "Last"))


def all_cases(ir=_ir) -> Iterator[Tuple[str, tuple]]:
    """(label, case) for every edge-grid program."""
    for op, dt in BINARY_CASES:
        yield f"{op}_{dt}", binary_case(op, dt, ir)
    for src, dst in CVT_CASES:
        yield f"CVT_{src}_{dst}", cvt_case(src, dst, ir)
    for op in UNARY_OPS:
        yield f"{op}_f32", unary_case(op, ir)
    yield "neg_zero_fold", neg_zero_fold_case(ir)
    yield "divergent_folds", divergent_folds_case(ir)
    yield "atomic_order", atomic_order_case(ir)
