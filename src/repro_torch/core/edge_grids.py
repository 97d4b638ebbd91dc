"""One-op hetIR programs over grids of edge values.

They pin the semantics where a CUDA or PyTorch port would round, wrap or
order differently from the reference interpreter: floor DIV/MOD with a
zero divisor and ``INT_MIN / -1``, shifts by 32 or more, NumPy's x86
float -> integer casts of NaN and out-of-range values, NaN-propagating
MIN/MAX on ``(±0, ±0)``, a float fold of all ``-0.0`` (``+0.0``), folds
and votes under divergence, ``REDUCE_MAX`` ties of ``±0`` and NaN, the
block-then-lane order of atomics and colliding stores, ``SHUFFLE`` from
lanes out of range, and a loop whose loads the CUDA kernel stages in
shared memory reading indices below 0 and past the end.  The programs
with cross-lane ops also come in blocks wider than 1024 lanes
(:func:`wide_cases`), where a thread of the CUDA kernel runs several
lanes.

Every builder takes the hetIR module to build with (``ir``, default this
package's), so the same programs can be built by the JAX package and held
against its interpreter.  Each case is ``(program, grid, block, args,
outputs)``.
"""
from __future__ import annotations

import dataclasses
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


def neg_zero_fold_case(ir=_ir, block: int = 4):
    """REDUCE_ADD and SCAN_ADD of all ``-0.0``: the fold starts from
    ``+0.0``, so both give ``+0.0``.  Two blocks of ``block`` lanes."""
    b = ir.Builder("neg_zero_fold", [ir.Ptr("A"), ir.Ptr("S"), ir.Ptr("C")])
    i = b.global_id(0)
    x = b.load("A", i)
    b.store("S", i, b.reduce_add(x))
    b.store("C", i, b.scan_add(x))
    n = 2 * block
    return (b.done(), 2, block, {"A": np.full(n, -0.0, np.float32),
                                 "S": np.ones(n, np.float32),
                                 "C": np.ones(n, np.float32)}, ("S", "C"))


def divergent_folds_case(ir=_ir, block: int = 32):
    """Folds, a scan and a vote under a predicate, over values of mixed
    magnitude with a NaN: lane order decides every rounding.  Two blocks
    of ``block`` lanes."""
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
    n = 2 * block
    a = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 8, n)) \
        .astype(np.float32)
    a[5] = np.nan
    return (b.done(), 2, block, {"A": a, "R": np.zeros(n, np.float32),
                                 "M": np.zeros(n, np.float32),
                                 "P": np.zeros(n, np.float32),
                                 "V": np.zeros(n, np.int32)},
            ("R", "M", "P", "V"))


def reduce_max_ties_case(ir=_ir, block: int = 48):
    """REDUCE_MAX where the maximum is shared: ``+0`` and ``-0`` compare
    equal and the fold keeps the later lane's, a NaN wins over everything
    (the first NaN); over every lane and under a predicate, in blocks of
    48 lanes (one whole warp and a partial one) or of ``block``.  The last
    block's maximum sits in three lanes whose middle one is off under the
    predicate; in wider blocks the ties also straddle the middle lane,
    where the CUDA kernel's threads move to their second lane."""
    b = ir.Builder("reduce_max_ties", [ir.Ptr("A"), ir.Ptr("M"),
                                       ir.Ptr("P")])
    i = b.global_id(0)
    t = b.thread_id()
    x = b.load("A", i)
    b.store("M", i, b.reduce_max(x))
    with b.when((t % b.const(5)).ne(b.const(3))):
        b.store("P", i, b.reduce_max(x))
    rng = np.random.default_rng(11)
    T = block
    zeros = np.where(rng.random(T) < 0.5, -0.0, 0.0).astype(np.float32)
    neg = zeros.copy()
    neg[rng.random(T) < 0.5] = -3.0
    nan = zeros.copy()
    nan[[7, 30]] = np.nan
    late = np.full(T, -np.inf, np.float32)
    # lane T - 5 is off under the mask; in wide blocks more ties straddle
    # the middle lane (T // 2) and T - 1
    off = T - 5 - (T - 5) % 5 + 3
    late[[off - 2, off - 1, off]] = (0.0, -0.0, 0.0)
    if T > 64:
        late[[T // 2 - 1, T // 2, T - 1]] = (-0.0, 0.0, -0.0)
    a = np.concatenate([zeros, neg, nan, late]).astype(np.float32)
    return (b.done(), 4, T, {"A": a, "M": np.ones(a.size, np.float32),
                             "P": np.ones(a.size, np.float32)}, ("M", "P"))


def staged_window_case(ir=_ir):
    """A loop of static trip count reading a buffer the segment never
    writes, at indices affine in the lane and the loop variable — the
    loads the CUDA kernel stages in shared memory.  One window (lane
    stride 5) reads negative indices down to ``-n``, which count from the
    end; the other (lane stride 32: padded rows) reads up to ``n - 1``.
    Rounded out to 16-byte chunks, the windows reach past both ends of
    the buffer (``n`` = 603), where staging reads 0 that no lane uses.
    The block fold at the end keeps the segment on the scalar kernel."""
    b = ir.Builder("staged_window", [ir.Ptr("A"), ir.Ptr("Out"),
                                     ir.Ptr("Sum"), ir.Scalar("base")])
    i = b.global_id(0)
    t = b.thread_id()
    blk = b.block_id()
    base = b.param("base")
    s = b.var(b.const(0.0, ir.F32), hint="s")
    with b.loop(8, hint="j") as j:
        near = base + blk * b.const(40) + t * b.const(5) + j
        far = t * b.const(32) + j * b.const(3) + b.const(101)
        b.assign(s, s + b.load("A", near) + b.load("A", far))
    b.store("Out", i, s)
    b.store("Sum", i, b.reduce_add(s))
    rng = np.random.default_rng(13)
    a = (rng.standard_normal(603) * 10.0 ** rng.integers(-3, 4, 603)) \
        .astype(np.float32)
    return (b.done(), 3, 16, {"A": a, "Out": np.zeros(48, np.float32),
                              "Sum": np.zeros(48, np.float32),
                              "base": -603}, ("Out", "Sum"))


def atomic_order_case(ir=_ir, block: int = 32):
    """Float atomics on one address apply block by block, lane by lane
    (the rounding of every add, and the old value each lane sees, depend
    on it); several lanes storing to one address leave the highest lane's
    value.  Three blocks of ``block`` lanes."""
    b = ir.Builder("atomics", [ir.Ptr("A"), ir.Ptr("Acc"), ir.Ptr("Old"),
                               ir.Ptr("Last")])
    i = b.global_id(0)
    t = b.thread_id()
    x = b.load("A", i)
    old = b.atomic_add("Acc", t % b.const(2), x)
    b.store("Old", i, old)
    b.store("Last", t % b.const(4), x)
    rng = np.random.default_rng(5)
    n = 3 * block
    a = (rng.standard_normal(n) * 10.0 ** rng.integers(-4, 9, n)) \
        .astype(np.float32)
    return (b.done(), 3, block, {"A": a, "Acc": np.zeros(2, np.float32),
                                 "Old": np.zeros(n, np.float32),
                                 "Last": np.zeros(4, np.float32)},
            ("Acc", "Old", "Last"))


def shuffle_case(ir=_ir, block: int = 32):
    """SHUFFLE from a lane each lane computes: below 0 and past the block
    (clamped to lanes 0 and T - 1), from lanes that are off under a
    predicate (a shuffle reads its source whatever the source's mask), and
    under a predicate itself.  Two blocks of ``block`` lanes."""
    b = ir.Builder("shuffle", [ir.Ptr("A"), ir.Ptr("X"), ir.Ptr("Y")])
    i = b.global_id(0)
    t = b.thread_id()
    dim = b.block_dim()
    x = b.var(b.const(-1.0, ir.F32), hint="x")
    with b.when((t % b.const(4)).ne(b.const(2))):
        b.assign(x, b.load("A", i))
    src = (t * b.const(37)) % (dim + b.const(9)) - b.const(4)
    b.store("X", i, b.shuffle(x, src))
    with b.when((t % b.const(3)).eq(b.const(0))):
        b.store("Y", i, b.shuffle(x, dim - t - b.const(1)))
    rng = np.random.default_rng(17)
    n = 2 * block
    return (b.done(), 2, block,
            {"A": rng.standard_normal(n).astype(np.float32),
             "X": np.zeros(n, np.float32), "Y": np.zeros(n, np.float32)},
            ("X", "Y"))


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
    yield "reduce_max_ties", reduce_max_ties_case(ir)
    yield "atomic_order", atomic_order_case(ir)
    yield "staged_window", staged_window_case(ir)
    yield "shuffle", shuffle_case(ir)


def wide_cases(block: int, ir=_ir) -> Iterator[Tuple[str, tuple]]:
    """(label, case) for the programs with cross-lane ops — folds, scans,
    votes, ``REDUCE_MAX`` ties, atomics and colliding stores, ``SHUFFLE`` —
    in blocks of ``block`` lanes (wider than 1024: several lanes to a
    thread of the CUDA kernel)."""
    yield "neg_zero_fold", neg_zero_fold_case(ir, block)
    yield "divergent_folds", divergent_folds_case(ir, block)
    yield "reduce_max_ties", reduce_max_ties_case(ir, block)
    yield "atomic_order", atomic_order_case(ir, block)
    yield "shuffle", shuffle_case(ir, block)


#: suite programs with cross-lane ops that :func:`wide_suite_case` runs
WIDE_SUITE = ("reduction", "inclusive_scan", "bitcount_vote", "dot_product")


def wide_suite_case(name: str, block: int, rng=None):
    """Suite program ``name`` (one of :data:`WIDE_SUITE`, from this
    package's ``kernels_suite``) at two blocks of ``block`` lanes, with
    inputs from ``rng`` and tails in ``n``: (program, grid, block, args,
    outputs).  The reduction's shared row (1024 elements) grows to the
    block."""
    from . import kernels_suite
    rng = np.random.default_rng(14) if rng is None else rng
    prog, _ = kernels_suite.SUITE[name]()
    if prog.shared_size:
        prog = dataclasses.replace(prog, shared_size=block)
    n = 2 * block
    a = rng.normal(size=n).astype(np.float32)
    args = {"reduction": {"A": a, "Out": np.zeros(1, np.float32),
                          "n": n - 7, "log2t": int(block).bit_length()},
            "inclusive_scan": {"A": a, "Out": np.zeros(n, np.float32),
                               "BlockSums": np.zeros(2, np.float32),
                               "n": n - 5},
            "bitcount_vote": {"A": a, "Out": np.zeros(2, np.float32),
                              "n": n - 3, "thresh": 0.25},
            "dot_product": {"A": a, "B": rng.normal(size=n)
                            .astype(np.float32),
                            "Out": np.zeros(1, np.float32), "n": n - 1}}
    outs = {"reduction": ("Out",), "inclusive_scan": ("Out", "BlockSums"),
            "bitcount_vote": ("Out",), "dot_product": ("Out",)}
    return prog, 2, block, args[name], outs[name]
