"""The paper's microbenchmark/validation kernel suite, in hetIR (§5.3/§6.1).

Ten kernels mirroring the paper's portability evaluation: vector add, SAXPY,
tiled matrix multiply (shared memory + barriers), reduction (shared-memory
tree + atomics), inclusive scan, bitcount via ballot vote, Monte-Carlo pi
(divergence + RNG + atomics), a small neural-net layer (matvec + ReLU),
a divergent 1-D stencil, and a persistent iterative kernel (the migration
test target).  Three loop-heavy kernels target the phase-2 optimizer
(see ``docs/PASSES.md``): ``poly_eval`` (constant-trip Horner loop —
unrolling + folding), ``swizzle_copy`` (power-of-two index arithmetic —
strength reduction), and ``tap_filter`` (a recomputed quotient spanning a
barrier — cross-segment value numbering).  Two *dynamic-trip* kernels
target launch-time specialization: ``dyn_matmul`` (the tile loop's trip
count is a launch scalar, unrollable only once bound) and ``dyn_fir``
(dynamic taps plus a loop-invariant load that the alias-aware hoist moves
once the trip count is known positive).  ``decode_gemv`` is the
serving-tier workload: one decode step's residual matvec, barriered per
tile so the fair-share scheduler preempts between tiles.

Each returns a :class:`~repro_torch.core.hetir.Program` plus a pure-numpy oracle.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import numpy as np

from . import hetir as ir
from .hetir import Builder, Ptr, Scalar


# ---------------------------------------------------------------------------
def vadd() -> Tuple[ir.Program, Callable]:
    b = Builder("vadd", [Ptr("A"), Ptr("B"), Ptr("C"), Scalar("n")])
    i = b.global_id(0)
    with b.when(i < b.param("n")):
        b.store("C", i, b.load("A", i) + b.load("B", i))
    prog = b.done()

    def oracle(args):
        n = int(args["n"])
        out = np.array(args["C"], dtype=np.float32)
        out[:n] = np.asarray(args["A"])[:n] + np.asarray(args["B"])[:n]
        return {"C": out}

    return prog, oracle


def saxpy() -> Tuple[ir.Program, Callable]:
    b = Builder("saxpy", [Ptr("X"), Ptr("Y"), Scalar("n"),
                          Scalar("a", ir.F32)])
    i = b.global_id(0)
    with b.when(i < b.param("n")):
        y = b.load("Y", i) + b.param("a") * b.load("X", i)
        b.store("Y", i, y)
    prog = b.done()

    def oracle(args):
        n, a = int(args["n"]), np.float32(args["a"])
        y = np.array(args["Y"], dtype=np.float32)
        y[:n] = y[:n] + a * np.asarray(args["X"])[:n]
        return {"Y": y}

    return prog, oracle


# ---------------------------------------------------------------------------
def matmul_tiled(tile_k: int = 8) -> Tuple[ir.Program, Callable]:
    """C[M,N] = A[M,K] @ B[K,N].  One block per row of C; ``block_size`` = N.
    K is consumed in ``tile_k`` chunks staged through shared memory with a
    barrier per tile — the paper's shared-memory matmul, and the canonical
    barrier-segmented kernel for migration tests."""
    b = Builder("matmul_tiled",
                [Ptr("A"), Ptr("B"), Ptr("C"), Scalar("K"), Scalar("N"),
                 Scalar("ktiles")],
                shared_size=tile_k)
    row = b.block_id()
    col = b.thread_id()
    n = b.param("N")
    k = b.param("K")
    acc = b.var(b.const(0.0, ir.F32), hint="acc")
    with b.loop("ktiles", hint="kt") as kt:
        # threads t < tile_k cooperatively stage A[row, kt*tile_k + t]
        t = b.thread_id()
        with b.when(t < b.const(tile_k)):
            a_idx = row * k + kt * b.const(tile_k) + t
            b.store_shared(t, b.load("A", a_idx))
        b.barrier("tile-staged")
        with b.loop(tile_k, hint="kk") as kk:
            a_val = b.load_shared(kk)
            b_idx = (kt * b.const(tile_k) + kk) * n + col
            b.assign(acc, b.fma(a_val, b.load("B", b_idx), acc))
        b.barrier("tile-consumed")
    b.store("C", row * n + col, acc)
    prog = b.done()

    def oracle(args):
        K, N = int(args["K"]), int(args["N"])
        A = np.asarray(args["A"], np.float32)
        B = np.asarray(args["B"], np.float32)
        M = A.size // K
        C = (A.reshape(M, K) @ B.reshape(K, N)).reshape(-1)
        return {"C": C.astype(np.float32)}

    return prog, oracle


# ---------------------------------------------------------------------------
def reduction() -> Tuple[ir.Program, Callable]:
    """Block-level shared-memory tree reduction + one atomic per block."""
    b = Builder("reduction", [Ptr("A"), Ptr("Out"), Scalar("n"),
                              Scalar("log2t")],
                shared_size=1024)
    i = b.global_id(0)
    t = b.thread_id()
    x = b.var(b.const(0.0, ir.F32), hint="x")
    with b.when(i < b.param("n")):
        b.assign(x, b.load("A", i))
    b.store_shared(t, x)
    b.barrier("loaded")
    dim = b.block_dim()
    with b.loop("log2t", hint="lv") as lv:
        # offset = block_dim >> (lv+1)
        off = dim >> (lv + b.const(1))
        with b.when(t < off):
            s = b.load_shared(t) + b.load_shared(t + off)
            b.store_shared(t, s)
        b.barrier("tree-step")
    with b.when(t.eq(b.const(0))):
        b.atomic_add("Out", b.const(0), b.load_shared(b.const(0)))
    prog = b.done()

    def oracle(args):
        n = int(args["n"])
        s = np.asarray(args["A"], np.float32)[:n].sum()
        out = np.array(args["Out"], np.float32)
        out[0] += s
        return {"Out": out}

    return prog, oracle


# ---------------------------------------------------------------------------
def inclusive_scan() -> Tuple[ir.Program, Callable]:
    """Per-block inclusive prefix sum (the paper rewrote warp-shuffle scan
    with portable collectives — ours uses the SCAN_ADD intrinsic)."""
    b = Builder("inclusive_scan", [Ptr("A"), Ptr("Out"), Ptr("BlockSums"),
                                   Scalar("n")])
    i = b.global_id(0)
    x = b.var(b.const(0.0, ir.F32), hint="x")
    with b.when(i < b.param("n")):
        b.assign(x, b.load("A", i))
    s = b.scan_add(x)
    with b.when(i < b.param("n")):
        b.store("Out", i, s)
    t = b.thread_id()
    last = b.block_dim() - b.const(1)
    with b.when(t.eq(last)):
        b.store("BlockSums", b.block_id(), s)
    prog = b.done()

    def oracle(args):
        n = int(args["n"])
        A = np.asarray(args["A"], np.float32)
        T = args["_block_size"]
        out = np.array(args["Out"], np.float32)
        bs = np.array(args["BlockSums"], np.float32)
        x = A.copy()
        x[n:] = 0
        blocks = x.reshape(-1, T)
        scans = np.cumsum(blocks, axis=1, dtype=np.float32)
        flat = scans.reshape(-1)
        out[:n] = flat[:n]
        bs[:scans.shape[0]] = scans[:, -1]
        return {"Out": out, "BlockSums": bs}

    return prog, oracle


# ---------------------------------------------------------------------------
def bitcount_vote() -> Tuple[ir.Program, Callable]:
    """Count of threads per block with A[i] > thresh, via VOTE_BALLOT."""
    b = Builder("bitcount_vote", [Ptr("A"), Ptr("Out"), Scalar("n"),
                                  Scalar("thresh", ir.F32)])
    i = b.global_id(0)
    inb = i < b.param("n")
    val = b.var(b.const(0.0, ir.F32), hint="val")
    with b.when(inb):
        b.assign(val, b.load("A", i))
    hit = (val > b.param("thresh")) & inb
    cnt = b.ballot(hit)
    with b.when(b.thread_id().eq(b.const(0))):
        b.store("Out", b.block_id(), cnt.astype(ir.F32))
    prog = b.done()

    def oracle(args):
        n, th = int(args["n"]), np.float32(args["thresh"])
        T = args["_block_size"]
        A = np.asarray(args["A"], np.float32).copy()
        mask = np.zeros(A.size, bool)
        mask[:n] = A[:n] > th
        counts = mask.reshape(-1, T).sum(axis=1)
        out = np.array(args["Out"], np.float32)
        out[:counts.size] = counts
        return {"Out": out}

    return prog, oracle


# ---------------------------------------------------------------------------
def montecarlo_pi(iters: int = 16) -> Tuple[ir.Program, Callable]:
    """Monte-Carlo pi with per-thread xorshift RNG — the paper's divergent
    kernel (divergence + atomics)."""
    b = Builder("montecarlo_pi", [Ptr("Count", ir.F32)])
    i = b.global_id(0)
    seed = (i + b.const(1)).astype(ir.U32)
    x = b.var(seed * b.const(2654435761, ir.U32), hint="rng")
    hits = b.var(b.const(0.0, ir.F32), hint="hits")
    inv = b.const(float(1.0 / (1 << 24)), ir.F32)
    with b.loop(iters, hint="mc"):
        # xorshift32 twice -> u, v
        def step(v):
            v1 = v ^ (v << b.const(13, ir.U32))
            v2 = v1 ^ (v1 >> b.const(17, ir.U32))
            return v2 ^ (v2 << b.const(5, ir.U32))

        r1 = step(x)
        r2 = step(r1)
        b.assign(x, r2)
        u = (r1 >> b.const(8, ir.U32)).astype(ir.F32) * inv
        v = (r2 >> b.const(8, ir.U32)).astype(ir.F32) * inv
        d = u * u + v * v
        with b.when(d < b.const(1.0, ir.F32)):
            b.assign(hits, hits + b.const(1.0, ir.F32))
    total = b.reduce_add(hits)
    with b.when(b.thread_id().eq(b.const(0))):
        b.atomic_add("Count", b.const(0), total)
    prog = b.done()

    def oracle(args):
        # RNG-exact oracle computed in numpy
        B, T = args["_num_blocks"], args["_block_size"]
        n = B * T
        gid = np.arange(n, dtype=np.uint32)
        x = (gid + 1) * np.uint32(2654435761)
        hits = np.zeros(n, np.float32)
        with np.errstate(over="ignore"):
            for _ in range(iters):
                def step(v):
                    v = v ^ (v << np.uint32(13))
                    v = v ^ (v >> np.uint32(17))
                    return v ^ (v << np.uint32(5))

                r1 = step(x)
                r2 = step(r1)
                x = r2
                u = (r1 >> np.uint32(8)).astype(np.float32) / (1 << 24)
                v = (r2 >> np.uint32(8)).astype(np.float32) / (1 << 24)
                hits += (u * u + v * v < 1.0).astype(np.float32)
        out = np.array(args["Count"], np.float32)
        out[0] += hits.sum()
        return {"Count": out}

    return prog, oracle


# ---------------------------------------------------------------------------
def nn_layer() -> Tuple[ir.Program, Callable]:
    """Small neural-net layer: out = relu(W @ x + bias); one block per
    output row, K-loop per thread (the paper's matvec+ReLU kernel)."""
    b = Builder("nn_layer", [Ptr("W"), Ptr("X"), Ptr("Bias"), Ptr("Out"),
                             Scalar("K"), Scalar("kchunks")])
    row = b.block_id()
    t = b.thread_id()
    k = b.param("K")
    dim = b.block_dim()
    acc = b.var(b.const(0.0, ir.F32), hint="acc")
    # threads stride over K; per-thread partials reduced block-wide
    with b.loop("kchunks", hint="kc") as kc:
        idx = kc * dim + t
        with b.when(idx < k):
            b.assign(acc, b.fma(b.load("W", row * k + idx),
                                b.load("X", idx), acc))
    total = b.reduce_add(acc)
    with b.when(t.eq(b.const(0))):
        val = total + b.load("Bias", row)
        b.store("Out", row, b.maximum(val, b.const(0.0, ir.F32)))
    prog = b.done()

    def oracle(args):
        K = int(args["K"])
        W = np.asarray(args["W"], np.float32)
        Xv = np.asarray(args["X"], np.float32)[:K]
        Bv = np.asarray(args["Bias"], np.float32)
        M = W.size // K
        out = np.maximum(W.reshape(M, K) @ Xv + Bv[:M], 0)
        res = np.array(args["Out"], np.float32)
        res[:M] = out
        return {"Out": res}

    return prog, oracle


# ---------------------------------------------------------------------------
def stencil_1d() -> Tuple[ir.Program, Callable]:
    """Divergent boundary-handling stencil."""
    b = Builder("stencil_1d", [Ptr("A"), Ptr("Out"), Scalar("n")])
    i = b.global_id(0)
    n = b.param("n")
    with b.when(i < n):
        c = b.load("A", i)
        left = b.var(c, hint="left")
        right = b.var(c, hint="right")
        with b.when(i > b.const(0)):
            b.assign(left, b.load("A", i - b.const(1)))
        with b.when(i < n - b.const(1)):
            b.assign(right, b.load("A", i + b.const(1)))
        b.store("Out", i, (left + c + right) * b.const(1.0 / 3.0, ir.F32))
    prog = b.done()

    def oracle(args):
        n = int(args["n"])
        A = np.asarray(args["A"], np.float32)[:n]
        out = np.array(args["Out"], np.float32)
        acc = A.copy()
        acc[1:] += A[:-1]
        acc[:-1] += A[1:]
        acc[0] += A[0]
        acc[-1] += A[-1]
        out[:n] = acc / 3.0
        return {"Out": out}

    return prog, oracle


# ---------------------------------------------------------------------------
def persistent_counter(outer: str = "iters") -> Tuple[ir.Program, Callable]:
    """The paper's migration-validation kernel: a persistent loop with
    internal per-thread state, a barrier per iteration, and a running
    global array update.  Loop counters + registers must survive
    migration for the final state to match a non-migrated run."""
    b = Builder("persistent_counter", [Ptr("State"), Scalar(outer)])
    i = b.global_id(0)
    carry = b.var(b.const(0.0, ir.F32), hint="carry")
    with b.loop(outer, hint="it") as it:
        prev = b.load("State", i)
        b.assign(carry, carry + prev * b.const(0.5, ir.F32)
                 + it.astype(ir.F32))
        b.store("State", i, prev + carry)
        b.barrier("iteration")
    prog = b.done()

    def oracle(args):
        iters = int(args[outer])
        st = np.asarray(args["State"], np.float32).copy()
        carry = np.zeros_like(st)
        for it in range(iters):
            prev = st.copy()
            carry = carry + prev * np.float32(0.5) + np.float32(it)
            st = prev + carry
        return {"State": st}

    return prog, oracle


# ---------------------------------------------------------------------------
def poly_eval(degree: int = 6) -> Tuple[ir.Program, Callable]:
    """Horner polynomial evaluation — the unrolling showcase: a constant
    trip-count loop whose per-iteration coefficient index (``degree - j``)
    is pure arithmetic on the loop variable.  Rolled, every trip pays
    CONST/SUB/loads; unrolled, the index folds to a constant per copy and
    DCE deletes the arithmetic, so the executed schedule shrinks on interp
    and pallas exactly as trace-unrolling always did on vectorized."""
    b = Builder("poly_eval", [Ptr("X"), Ptr("Coef"), Ptr("Out"),
                              Scalar("n")])
    i = b.global_id(0)
    x = b.var(b.const(0.0, ir.F32), hint="x")
    with b.when(i < b.param("n")):
        b.assign(x, b.load("X", i))
    acc = b.var(b.const(0.0, ir.F32), hint="pacc")
    with b.loop(degree + 1, hint="pj") as j:
        cidx = b.const(degree) - j       # folds once unrolled
        c = b.load("Coef", cidx)
        b.assign(acc, acc * x + c)       # fuses to FMA
    with b.when(i < b.param("n")):
        b.store("Out", i, acc)
    prog = b.done()

    def oracle(args):
        n = int(args["n"])
        X = np.asarray(args["X"], np.float32)
        C = np.asarray(args["Coef"], np.float32)
        out = np.array(args["Out"], np.float32)
        acc = np.zeros_like(X)
        for j in range(degree + 1):
            acc = acc * X + C[degree - j]
        out[:n] = acc[:n]
        return {"Out": out}

    return prog, oracle


# ---------------------------------------------------------------------------
def swizzle_copy(size: int = 128) -> Tuple[ir.Program, Callable]:
    """Power-of-two index swizzle — the strength-reduction showcase: the
    gather index is built from ``*8``, ``/4``, ``%16``, ``%size`` and a
    parity test, all by power-of-two constants, so at OPT_MAX every
    multiplicative op becomes a shift or mask.  Launch with
    ``grid * block == size`` (``size`` is baked in at build time so the
    wrap is a foldable constant, like a template parameter)."""
    assert size & (size - 1) == 0, "size must be a power of two"
    b = Builder("swizzle_copy", [Ptr("A"), Ptr("Out")])
    i = b.global_id(0)
    j = (i * b.const(8) + i / b.const(4) + i % b.const(16)) \
        % b.const(size)
    v = b.var(b.load("A", j), hint="sv")
    even = (i % b.const(2)).eq(b.const(0))
    with b.when(even):
        b.assign(v, v + b.load("A", i))
    b.store("Out", i, v)
    prog = b.done()

    def oracle(args):
        A = np.asarray(args["A"], np.float32)
        i = np.arange(size, dtype=np.int64)
        j = (i * 8 + i // 4 + i % 16) % size
        out = A[j].copy()
        out[i % 2 == 0] += A[i % 2 == 0]
        return {"Out": out.astype(np.float32)}

    return prog, oracle


# ---------------------------------------------------------------------------
def tap_filter(taps: int = 4, size: int = 64) -> Tuple[ir.Program, Callable]:
    """Two-phase tap filter across a barrier — the cross-segment
    value-numbering showcase.  Phase 1 recomputes ``i / 3`` (a DIV that
    :func:`~repro_torch.core.passes.hoist_invariants` refuses to move) inside a
    constant-trip tap loop; phase 2, a separate engine segment after the
    barrier, derives the same quotient again.  At OPT_MAX the loop unrolls,
    the per-iteration ``j * 5`` offsets fold, and value numbering keeps one
    ``i / 3`` alive across the segment boundary instead of three
    re-executions.  Launch with ``grid * block == size``."""
    b = Builder("tap_filter", [Ptr("A"), Ptr("W"), Ptr("Tmp"), Ptr("Out")])
    i = b.global_id(0)
    acc = b.var(b.const(0.0, ir.F32), hint="tacc")
    with b.loop(taps, hint="tp") as j:
        base = i / b.const(3)            # non-hoistable duplicate, per trip
        idx = (base + j * b.const(5)) % b.const(size)
        b.assign(acc, acc + b.load("A", idx) * b.load("W", j))
    b.store("Tmp", i, acc)
    b.barrier("phase")
    base2 = i / b.const(3)               # merges with the in-loop quotient
    nb = (base2 + i) % b.const(size)
    b.store("Out", i, b.load("Tmp", nb) + acc)
    prog = b.done()

    def oracle(args):
        A = np.asarray(args["A"], np.float32)
        W = np.asarray(args["W"], np.float32)
        i = np.arange(size, dtype=np.int64)
        base = i // 3
        acc = np.zeros(size, np.float32)
        for j in range(taps):
            acc = acc + A[(base + j * 5) % size] * W[j]
        out = acc[(base + i) % size] + acc
        return {"Tmp": acc, "Out": out.astype(np.float32)}

    return prog, oracle


# ---------------------------------------------------------------------------
def dyn_matmul(tile_k: int = 8) -> Tuple[ir.Program, Callable]:
    """:func:`matmul_tiled` with the inner K-tile loop's trip count a
    *launch scalar* (``tk``) — the launch-time-specialization showcase.
    Statically the inner loop is dynamic-trip, so the generic pipeline can
    never unroll it; binding ``tk`` at launch makes it static and the
    whole phase-2 cascade (unroll → fold → strength-reduce → CSE) fires on
    the per-tile index math.  Launch with ``tk == tile_k`` (the shared
    staging buffer is sized at build time, like a template parameter)."""
    b = Builder("dyn_matmul",
                [Ptr("A"), Ptr("B"), Ptr("C"), Scalar("K"), Scalar("N"),
                 Scalar("ktiles"), Scalar("tk")],
                shared_size=tile_k)
    row = b.block_id()
    col = b.thread_id()
    n = b.param("N")
    k = b.param("K")
    acc = b.var(b.const(0.0, ir.F32), hint="acc")
    with b.loop("ktiles", hint="kt") as kt:
        t = b.thread_id()
        with b.when(t < b.const(tile_k)):
            a_idx = row * k + kt * b.const(tile_k) + t
            b.store_shared(t, b.load("A", a_idx))
        b.barrier("tile-staged")
        with b.loop("tk", hint="kk") as kk:  # dynamic trip: scalar param
            # swizzled tile order (odd-stride permutation of 0..tile_k-1,
            # the classic bank-conflict dodge): uniform-on-kk index math
            # that the rolled loop pays every trip and an unrolled copy
            # folds to one constant
            kidx = (kk * b.const(5) + b.const(2)) % b.const(tile_k)
            a_val = b.load_shared(kidx)
            b_idx = (kt * b.const(tile_k) + kidx) * n + col
            b.assign(acc, b.fma(a_val, b.load("B", b_idx), acc))
        b.barrier("tile-consumed")
    b.store("C", row * n + col, acc)
    prog = b.done()

    def oracle(args):
        K, N = int(args["K"]), int(args["N"])
        A = np.asarray(args["A"], np.float32)
        B = np.asarray(args["B"], np.float32)
        M = A.size // K
        C = (A.reshape(M, K) @ B.reshape(K, N)).reshape(-1)
        return {"C": C.astype(np.float32)}

    return prog, oracle


# ---------------------------------------------------------------------------
def dyn_fir(size: int = 64) -> Tuple[ir.Program, Callable]:
    """FIR filter with a *dynamic* tap count (``taps``) and a
    loop-invariant gain load — the second specialization showcase, and the
    alias-aware load-hoist showcase in one kernel.  ``W[0]`` is re-loaded
    every trip; the only stores go to ``Out`` (a distinct buffer, so the
    alias analysis clears the hoist) — but hoisting needs a static trip
    count ≥ 1, which only launch-time specialization can provide here.
    Small bound tap counts additionally unroll, folding the per-tap
    ``j*3`` offsets.  Launch with ``grid * block == size``."""
    assert size & (size - 1) == 0, "size must be a power of two"
    b = Builder("dyn_fir", [Ptr("A"), Ptr("W"), Ptr("Out"), Scalar("taps")])
    i = b.global_id(0)
    acc = b.var(b.const(0.0, ir.F32), hint="facc")
    with b.loop("taps", hint="fj") as j:
        g = b.load("W", b.const(0))          # invariant: hoists once static
        # swizzled tap offset: a chain of uniform-on-j arithmetic that the
        # rolled loop re-executes every trip but collapses to one constant
        # per unrolled copy once the trip count is bound
        off = ((j * b.const(5) + b.const(2)) % b.const(8)) * b.const(4) \
            + j % b.const(4)
        idx = (i + off) % b.const(size)
        b.assign(acc, acc + b.load("A", idx) * (b.load("W", j) + g))
    b.store("Out", i, acc)
    prog = b.done()

    def oracle(args):
        taps = int(args["taps"])
        A = np.asarray(args["A"], np.float32)
        W = np.asarray(args["W"], np.float32)
        i = np.arange(size, dtype=np.int64)
        acc = np.zeros(size, np.float32)
        for j in range(taps):
            off = ((j * 5 + 2) % 8) * 4 + (j % 4)
            acc = acc + A[(i + off) % size] * (W[j] + W[0])
        out = np.array(args["Out"], np.float32)
        out[:size] = acc
        return {"Out": out}

    return prog, oracle


# ---------------------------------------------------------------------------
def decode_gemv(tile_k: int = 8) -> Tuple[ir.Program, Callable]:
    """The serving-tier workload: one decode step's matvec,
    ``Out = relu(W @ X + R)`` (``R`` the residual), with ``X`` staged
    through shared memory in ``tile_k`` chunks and a barrier per chunk.
    One output row per *thread* (``grid*block`` rows), dynamic ``ktiles``
    trip — so a single token's worth of work is many short segments, the
    shape the fair-share scheduler preempts between, and the
    specialization policy can bind the tile count at launch."""
    b = Builder("decode_gemv",
                [Ptr("W"), Ptr("X"), Ptr("R"), Ptr("Out"), Scalar("K"),
                 Scalar("ktiles")], shared_size=tile_k)
    row = b.global_id(0)
    t = b.thread_id()
    k = b.param("K")
    acc = b.var(b.const(0.0, ir.F32), hint="acc")
    with b.loop("ktiles", hint="kt") as kt:
        with b.when(t < b.const(tile_k)):
            b.store_shared(t, b.load("X", kt * b.const(tile_k) + t))
        b.barrier("x-staged")
        with b.loop(tile_k, hint="kk") as kk:
            idx = kt * b.const(tile_k) + kk
            b.assign(acc, b.fma(b.load("W", row * k + idx),
                                b.load_shared(kk), acc))
        b.barrier("x-consumed")
    val = acc + b.load("R", row)
    b.store("Out", row, b.maximum(val, b.const(0.0, ir.F32)))
    prog = b.done()

    def oracle(args):
        K = int(args["K"])
        used = int(args["ktiles"]) * tile_k
        W = np.asarray(args["W"], np.float32)
        X = np.asarray(args["X"], np.float32)
        R = np.asarray(args["R"], np.float32)
        M = W.size // K
        Wm = W.reshape(M, K)[:, :used]
        out = np.maximum(Wm @ X[:used] + R[:M], 0)
        res = np.array(args["Out"], np.float32)
        res[:M] = out
        return {"Out": res}

    return prog, oracle


# ---------------------------------------------------------------------------
def dot_product() -> Tuple[ir.Program, Callable]:
    b = Builder("dot_product", [Ptr("A"), Ptr("B"), Ptr("Out"), Scalar("n")])
    i = b.global_id(0)
    x = b.var(b.const(0.0, ir.F32), hint="x")
    with b.when(i < b.param("n")):
        b.assign(x, b.load("A", i) * b.load("B", i))
    s = b.reduce_add(x)
    with b.when(b.thread_id().eq(b.const(0))):
        b.atomic_add("Out", b.const(0), s)
    prog = b.done()

    def oracle(args):
        n = int(args["n"])
        r = (np.asarray(args["A"], np.float32)[:n]
             * np.asarray(args["B"], np.float32)[:n]).sum()
        out = np.array(args["Out"], np.float32)
        out[0] += r
        return {"Out": out}

    return prog, oracle


# ---------------------------------------------------------------------------
# Canonical example launches — one validated (grid, block, args, outputs)
# geometry per suite kernel, shared by the portability benchmark, the
# driver-API demo/tests, and anything else that wants to run the whole
# suite without re-deriving per-kernel argument shapes.
# ---------------------------------------------------------------------------

#: name -> (grid, block, make_args(rng) -> host args dict, output buffers)
EXAMPLES: Dict[str, Tuple[int, int, Callable, Tuple[str, ...]]] = {
    "vadd": (4, 32, lambda rng: {
        "A": rng.normal(size=128).astype(np.float32),
        "B": rng.normal(size=128).astype(np.float32),
        "C": np.zeros(128, np.float32), "n": 128}, ("C",)),
    "saxpy": (4, 32, lambda rng: {
        "X": rng.normal(size=128).astype(np.float32),
        "Y": rng.normal(size=128).astype(np.float32),
        "n": 128, "a": 1.5}, ("Y",)),
    "matmul_tiled": (8, 16, lambda rng: {
        "A": rng.normal(size=(8, 16)).astype(np.float32).reshape(-1),
        "B": rng.normal(size=(16, 16)).astype(np.float32).reshape(-1),
        "C": np.zeros(128, np.float32), "K": 16, "N": 16, "ktiles": 2},
        ("C",)),
    "reduction": (4, 32, lambda rng: {
        "A": rng.normal(size=128).astype(np.float32),
        "Out": np.zeros(1, np.float32), "n": 128, "log2t": 5}, ("Out",)),
    "inclusive_scan": (4, 32, lambda rng: {
        "A": rng.normal(size=128).astype(np.float32),
        "Out": np.zeros(128, np.float32),
        "BlockSums": np.zeros(4, np.float32), "n": 128},
        ("Out", "BlockSums")),
    "bitcount_vote": (4, 32, lambda rng: {
        "A": rng.normal(size=128).astype(np.float32),
        "Out": np.zeros(4, np.float32), "n": 128, "thresh": 0.0}, ("Out",)),
    "montecarlo_pi": (2, 32, lambda rng: {
        "Count": np.zeros(1, np.float32)}, ("Count",)),
    "nn_layer": (4, 16, lambda rng: {
        "W": rng.normal(size=(4, 32)).astype(np.float32).reshape(-1),
        "X": rng.normal(size=32).astype(np.float32),
        "Bias": rng.normal(size=4).astype(np.float32),
        "Out": np.zeros(4, np.float32), "K": 32, "kchunks": 2}, ("Out",)),
    "stencil_1d": (2, 32, lambda rng: {
        "A": rng.normal(size=64).astype(np.float32),
        "Out": np.zeros(64, np.float32), "n": 64}, ("Out",)),
    "persistent_counter": (2, 32, lambda rng: {
        "State": rng.normal(size=64).astype(np.float32), "iters": 4},
        ("State",)),
    "dot_product": (4, 32, lambda rng: {
        "A": rng.normal(size=128).astype(np.float32),
        "B": rng.normal(size=128).astype(np.float32),
        "Out": np.zeros(1, np.float32), "n": 128}, ("Out",)),
    "poly_eval": (4, 32, lambda rng: {
        "X": rng.normal(size=128).astype(np.float32),
        "Coef": rng.normal(size=7).astype(np.float32),
        "Out": np.zeros(128, np.float32), "n": 128}, ("Out",)),
    "swizzle_copy": (4, 32, lambda rng: {
        "A": rng.normal(size=128).astype(np.float32),
        "Out": np.zeros(128, np.float32)}, ("Out",)),
    "tap_filter": (2, 32, lambda rng: {
        "A": rng.normal(size=64).astype(np.float32),
        "W": rng.normal(size=4).astype(np.float32),
        "Tmp": np.zeros(64, np.float32),
        "Out": np.zeros(64, np.float32)}, ("Out",)),
    "dyn_matmul": (4, 16, lambda rng: {
        "A": rng.normal(size=(4, 32)).astype(np.float32).reshape(-1),
        "B": rng.normal(size=(32, 16)).astype(np.float32).reshape(-1),
        "C": np.zeros(64, np.float32), "K": 32, "N": 16, "ktiles": 4,
        "tk": 8}, ("C",)),
    "dyn_fir": (2, 32, lambda rng: {
        "A": rng.normal(size=64).astype(np.float32),
        "W": rng.normal(size=8).astype(np.float32),
        "Out": np.zeros(64, np.float32), "taps": 4}, ("Out",)),
    "decode_gemv": (4, 16, lambda rng: {
        "W": rng.normal(size=(64, 32)).astype(np.float32).reshape(-1),
        "X": rng.normal(size=32).astype(np.float32),
        "R": rng.normal(size=64).astype(np.float32),
        "Out": np.zeros(64, np.float32), "K": 32, "ktiles": 4}, ("Out",)),
}


def example_launch(name: str, rng=None
                   ) -> Tuple["ir.Program", Callable, int, int,
                              Dict[str, object], Tuple[str, ...]]:
    """Build the canonical example launch for kernel ``name``:
    ``(program, oracle, grid, block, host_args, output_buffer_names)``.

    Looks through the suite first, then every registered namespace (the
    model zoo registers under ``"zoo"``) — so roofline/benchmark/driver
    tooling runs zoo kernels with the same one-liner it uses for the
    suite."""
    if rng is None:
        rng = np.random.default_rng(42)
    kernels, examples = _registry_for(name)
    grid, block, mk, outs = examples[name]
    prog, oracle = kernels[name]()
    return prog, oracle, grid, block, mk(rng), outs


# ---------------------------------------------------------------------------
# Namespaced kernel registries.  The conformance harnesses pin their
# parametrization to ``SUITE``/``EXAMPLES`` at collection time (and
# test_passes asserts exact coverage of SUITE), so external workload
# packages must NOT mutate those dicts — they register under their own
# namespace here and the generic lookups below search all of them.
# ---------------------------------------------------------------------------

#: namespace -> (kernels dict, examples dict); "suite" is the built-in tier
REGISTRIES: Dict[str, Tuple[Dict[str, Callable], Dict[str, tuple]]] = {}


def register_kernel(name: str, builder: Callable, example=None,
                    registry: str = "zoo") -> None:
    """Register kernel ``builder`` (``() -> (Program, oracle)``) under a
    namespace, with an optional EXAMPLES-style canonical launch
    ``(grid, block, make_args(rng), output_names)``.  Idempotent per
    (registry, name); re-registering replaces the entry."""
    if registry == "suite":
        raise ValueError("the built-in suite is closed — register under "
                         "a new namespace (e.g. 'zoo')")
    kernels, examples = REGISTRIES.setdefault(registry, ({}, {}))
    kernels[name] = builder
    if example is not None:
        examples[name] = tuple(example)


def _registry_for(name: str) -> Tuple[Dict[str, Callable], Dict[str, tuple]]:
    if name in SUITE:
        return SUITE, EXAMPLES
    for kernels, examples in REGISTRIES.values():
        if name in kernels:
            return kernels, examples
    raise KeyError(f"unknown kernel {name!r} (suite: {sorted(SUITE)}; "
                   f"registries: {sorted(REGISTRIES)})")


def lookup(name: str) -> Callable:
    """The builder for ``name``, searching the suite then all registries."""
    return _registry_for(name)[0][name]


def registered_examples(registry: str) -> Dict[str, tuple]:
    """The canonical-launch table of one namespace (``"suite"`` included)."""
    if registry == "suite":
        return EXAMPLES
    return REGISTRIES[registry][1]


SUITE: Dict[str, Callable] = {
    "vadd": vadd,
    "saxpy": saxpy,
    "matmul_tiled": matmul_tiled,
    "reduction": reduction,
    "inclusive_scan": inclusive_scan,
    "bitcount_vote": bitcount_vote,
    "montecarlo_pi": montecarlo_pi,
    "nn_layer": nn_layer,
    "stencil_1d": stencil_1d,
    "persistent_counter": persistent_counter,
    "dot_product": dot_product,
    "poly_eval": poly_eval,
    "swizzle_copy": swizzle_copy,
    "tap_filter": tap_filter,
    "dyn_matmul": dyn_matmul,
    "dyn_fir": dyn_fir,
    "decode_gemv": decode_gemv,
}
