"""Model-zoo kernels: faithful hetIR reductions of the repo's real
workloads (``src/repro/kernels/*``), each paired with a *bit-exact*
NumPy oracle.

These are not microbenchmarks: they are the flash-decode attention row,
the top-1 MoE router + grouped matvec, the RG-LRU gated linear
recurrence and the mLSTM matrix-memory cell, rebuilt on the hetIR
Builder so one architecture-agnostic Program runs unmodified on the
interp, vectorized and pallas substrates.  Unlike the reference models
in ``kernels/*/ref.py`` (which compare under a tolerance), every oracle
here reproduces the kernel's exact float32 operation *order* — one op,
one rounding, lane-order sequential folds for the collectives, and
``portable_math.exp_np`` for every EXP — so conformance is asserted
with ``assert_array_equal``, the same contract the suite enjoys.

Oracle contract (documented in docs/ZOO.md):

* every scalar op is a single float32 rounding in program order;
* ``REDUCE_ADD``/``SCAN_ADD`` fold strictly in lane order from a
  zero of the destination dtype;
* ``REDUCE_MAX`` is an exact maximum (order-independent);
* ``EXP`` is the portable software exp shared by every backend
  (Cody-Waite reduction + Cephes polynomial, flush-to-zero outputs).

Registration happens at import under the ``"zoo"`` namespace via
:func:`repro_torch.core.kernels_suite.register_kernel`, so registry-aware
tooling (``example_launch``, roofline, the serving demo) picks the zoo
up with the same one-liners it uses for the suite.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

from ..core import hetir as ir
from ..core.hetir import Builder, Ptr, Scalar
from ..core.kernels_suite import register_kernel
from ..core.backends.portable_math import exp_np

_F32 = np.float32


def _f32(x) -> np.float32:
    return np.float32(x)


# ---------------------------------------------------------------------------
# attn_decode — single-query flash-decode attention row
# ---------------------------------------------------------------------------

ATTN_D = 16   #: head dimension (threads 0..D-1 own one output feature)
ATTN_T = 32   #: kv tile size == block size (one tile of keys per segment)


def attn_decode(D: int = ATTN_D, T: int = ATTN_T) -> Tuple[ir.Program, Callable]:
    """One decode step of flash attention for a single query token.

    Grid = heads, block = one kv tile of ``T`` lanes.  Each tile
    iteration computes the QK^T scores for ``T`` keys, folds them into
    the online (max, sum) softmax state via ``REDUCE_MAX``/``EXP``/
    ``REDUCE_ADD``, stages the probabilities through shared memory, and
    accumulates PV — with two barriers per tile, so a decode step is
    many short segments the scheduler can preempt (and the fleet can
    checkpoint/migrate) between.
    """
    b = Builder("attn_decode",
                [Ptr("Q"), Ptr("K"), Ptr("V"), Ptr("O"),
                 Scalar("ntiles"), Scalar("scale", ir.F32)],
                shared_size=D + T)
    h = b.block_id()
    tid = b.thread_id()
    dd = b.const(D)
    tt = b.const(T)
    ntl = b.param("ntiles")
    scale = b.param("scale")
    # feature index clamped for lanes >= D (they help stage p but own no
    # output feature; clamping keeps their V loads in bounds)
    jcl = b.select(tid < dd, tid, b.const(0))
    with b.when(tid < dd):
        b.store_shared(tid, b.load("Q", h * dd + tid))
    b.barrier("q-staged")
    m = b.var(b.const(float("-inf"), ir.F32), hint="m")
    l = b.var(b.const(0.0, ir.F32), hint="l")
    acc = b.var(b.const(0.0, ir.F32), hint="acc")
    with b.loop("ntiles", hint="kt") as kt:
        row = (h * ntl + kt) * tt + tid        # this lane's key row
        s = b.var(b.const(0.0, ir.F32), hint="s")
        with b.loop(D, hint="d") as d:
            b.assign(s, s + b.load_shared(d) * b.load("K", row * dd + d))
        sv = s * scale
        mn = b.maximum(m, b.reduce_max(sv))
        p = b.exp(sv - mn)
        b.store_shared(dd + tid, p)
        corr = b.exp(m - mn)
        b.assign(m, mn)
        b.assign(l, l * corr + b.reduce_add(p))
        b.barrier("p-staged")
        pv = b.var(b.const(0.0, ir.F32), hint="pv")
        with b.loop(T, hint="i") as i:
            vrow = (h * ntl + kt) * tt + i
            b.assign(pv, pv + b.load_shared(dd + i)
                     * b.load("V", vrow * dd + jcl))
        with b.when(tid < dd):
            b.assign(acc, acc * corr + pv)
        b.barrier("p-consumed")
    with b.when(tid < dd):
        b.store("O", h * dd + tid, acc / l)
    prog = b.done()

    def oracle(args):
        ntiles = int(args["ntiles"])
        scale = _f32(args["scale"])
        Q = np.asarray(args["Q"], _F32)
        K = np.asarray(args["K"], _F32)
        V = np.asarray(args["V"], _F32)
        H = Q.size // D
        S = ntiles * T
        Kr = K.reshape(H, S, D)
        Vr = V.reshape(H, S, D)
        out = np.array(args["O"], _F32)
        for h in range(H):
            q = Q[h * D:(h + 1) * D]
            m = _f32(-np.inf)
            l = _f32(0.0)
            acc = np.zeros(D, _F32)
            for kt in range(ntiles):
                rows = slice(kt * T, (kt + 1) * T)
                # per-lane sequential dot, vectorised across lanes
                s = np.zeros(T, _F32)
                for d in range(D):
                    s = s + q[d] * Kr[h, rows, d]
                sv = s * scale
                mn = np.maximum(m, np.max(sv))
                p = exp_np(sv - mn)
                corr = exp_np(_f32(m - mn))
                m = mn
                red = np.zeros((), _F32)
                for i in range(T):                 # lane-order fold
                    red = np.add(red, p[i], dtype=_F32)
                l = _f32(_f32(l * corr) + red)
                pv = np.zeros(D, _F32)
                for i in range(T):                 # sequential PV fold
                    pv = pv + p[i] * Vr[h, kt * T + i, :]
                acc = acc * corr + pv
            out[h * D:(h + 1) * D] = acc / l
        return {"O": out}

    return prog, oracle


# ---------------------------------------------------------------------------
# moe_route_gmm — top-1 router + grouped (gathered) expert matvec
# ---------------------------------------------------------------------------

MOE_E = 4   #: experts
MOE_F = 8   #: model width (router in-dim == expert in/out-dim)


def moe_route_gmm() -> Tuple[ir.Program, Callable]:
    """Top-1 MoE routing and the routed expert matvec, one token per
    thread.  The router is an argmax over per-expert logits (strict
    ``>``, first winner kept — the reference ``moe_gmm_ref`` tie rule);
    the expert weights are then *gathered* through the data-dependent
    expert index, the access pattern block_lower must legitimately
    refuse (``opaque-index``/``unprovable-base``).  The winning logit
    gates the output through a sigmoid built on the portable EXP.
    """
    b = Builder("moe_route_gmm",
                [Ptr("X"), Ptr("Wg"), Ptr("We"), Ptr("Y"),
                 Ptr("Eidx", ir.I32), Scalar("E"), Scalar("F")])
    n = b.global_id(0)
    Fp = b.param("F")
    best = b.var(b.const(float("-inf"), ir.F32), hint="best")
    bidx = b.var(b.const(0), hint="bidx")
    with b.loop("E", hint="e") as e:
        dot = b.var(b.const(0.0, ir.F32), hint="dot")
        with b.loop("F", hint="k") as k:
            b.assign(dot, dot + b.load("X", n * Fp + k)
                     * b.load("Wg", e * Fp + k))
        better = dot > best
        b.assign(best, b.select(better, dot, best))
        b.assign(bidx, b.select(better, e, bidx))
    b.store("Eidx", n, bidx)
    gate = b.const(1.0, ir.F32) / (b.const(1.0, ir.F32)
                                   + b.exp(b.const(0.0, ir.F32) - best))
    with b.loop("F", hint="f") as f:
        acc = b.var(b.const(0.0, ir.F32), hint="acc")
        with b.loop("F", hint="k2") as k2:
            b.assign(acc, acc + b.load("We", (bidx * Fp + f) * Fp + k2)
                     * b.load("X", n * Fp + k2))
        b.store("Y", n * Fp + f, acc * gate)
    prog = b.done()

    def oracle(args):
        E = int(args["E"])
        F = int(args["F"])
        X = np.asarray(args["X"], _F32)
        Wg = np.asarray(args["Wg"], _F32).reshape(E, F)
        We = np.asarray(args["We"], _F32).reshape(E, F, F)
        N = X.size // F
        Xm = X.reshape(N, F)
        Y = np.array(args["Y"], _F32).reshape(N, F)
        Eidx = np.array(args["Eidx"], np.int32)
        for nn in range(N):
            best = _f32(-np.inf)
            bi = 0
            for e in range(E):
                dot = _f32(0.0)
                for k in range(F):
                    dot = _f32(dot + _f32(Xm[nn, k] * Wg[e, k]))
                if dot > best:
                    best, bi = dot, e
            Eidx[nn] = bi
            gate = _f32(_f32(1.0)
                        / _f32(_f32(1.0) + exp_np(_f32(_f32(0.0) - best))))
            for ff in range(F):
                acc = _f32(0.0)
                for k in range(F):
                    acc = _f32(acc + _f32(We[bi, ff, k] * Xm[nn, k]))
                Y[nn, ff] = _f32(acc * gate)
        return {"Y": Y.reshape(-1), "Eidx": Eidx}

    return prog, oracle


# ---------------------------------------------------------------------------
# rglru_step — gated linear recurrence via log-space SCAN_ADD
# ---------------------------------------------------------------------------

RGLRU_T = 32   #: timesteps per block (one channel per block)


def rglru_step(T: int = RGLRU_T) -> Tuple[ir.Program, Callable]:
    """One RG-LRU chunk: ``h_t = a_t * h_{t-1} + x_t`` with pre-logged
    gates ``la_t = log a_t``, solved closed-form in log space —
    ``h_t = exp(cum_t) * (h0 + sum_{s<=t} exp(-cum_s) x_s)`` where
    ``cum`` is the inclusive ``SCAN_ADD`` of the log gates.  Exercises
    SCAN_ADD composed with EXP, the pattern ``rglru_scan_ref``'s
    ``lax.scan`` hides from the het core.
    """
    b = Builder("rglru_step", [Ptr("LA"), Ptr("Xv"), Ptr("H0"), Ptr("Hout")])
    c = b.block_id()
    tid = b.thread_id()
    tt = b.const(T)
    idx = c * tt + tid
    la = b.load("LA", idx)
    cum = b.scan_add(la)
    w = b.exp(b.const(0.0, ir.F32) - cum) * b.load("Xv", idx)
    ssum = b.scan_add(w)
    hv = b.exp(cum) * (b.load("H0", c) + ssum)
    b.store("Hout", idx, hv)
    prog = b.done()

    def oracle(args):
        LA = np.asarray(args["LA"], _F32)
        Xv = np.asarray(args["Xv"], _F32)
        H0 = np.asarray(args["H0"], _F32)
        C = LA.size // T
        out = np.array(args["Hout"], _F32)
        for c in range(C):
            la = LA[c * T:(c + 1) * T]
            xv = Xv[c * T:(c + 1) * T]
            cum = np.zeros(T, _F32)
            acc = _f32(0.0)
            for t in range(T):                 # lane-order inclusive scan
                acc = _f32(acc + la[t])
                cum[t] = acc
            w = exp_np(_f32(0.0) - cum) * xv
            ssum = np.zeros(T, _F32)
            acc = _f32(0.0)
            for t in range(T):
                acc = _f32(acc + w[t])
                ssum[t] = acc
            out[c * T:(c + 1) * T] = exp_np(cum) * (H0[c] + ssum)
        return {"Hout": out}

    return prog, oracle


# ---------------------------------------------------------------------------
# mlstm_cell — matrix-memory update + normalized read
# ---------------------------------------------------------------------------

MLSTM_D = 8   #: key/value dim; block = d*d threads, one per C entry


def mlstm_cell(d: int = MLSTM_D) -> Tuple[ir.Program, Callable]:
    """One mLSTM cell step (the inner recurrence of ``mlstm_chunk_ref``):
    matrix memory ``C' = f*C + i*(k (x) v)``, normalizer
    ``n' = f*n + i*k``, and the normalized read
    ``h = (q @ C') / max(|q . n'|, 1)``.  One thread per C entry
    (block = d*d); k/v/q are staged through shared memory and the
    stabilizer dot uses ``REDUCE_ADD`` with masked-to-zero lanes.
    """
    b = Builder("mlstm_cell",
                [Ptr("Q"), Ptr("K"), Ptr("V"), Ptr("Cin"), Ptr("Nin"),
                 Ptr("Cout"), Ptr("Nout"), Ptr("Hout"),
                 Scalar("fg", ir.F32), Scalar("ig", ir.F32)],
                shared_size=3 * d)
    assert d & (d - 1) == 0, "d must be a power of two (index math uses shifts)"
    shift = d.bit_length() - 1
    h = b.block_id()
    tid = b.thread_id()
    dd = b.const(d)
    fg = b.param("fg")
    ig = b.param("ig")
    row = tid >> b.const(shift)
    col = tid & b.const(d - 1)
    lane = b.select(tid < dd, tid, b.const(0))   # clamped d-range index
    with b.when(tid < dd):
        b.store_shared(tid, b.load("K", h * dd + tid))
        b.store_shared(dd + tid, b.load("V", h * dd + tid))
        b.store_shared(b.const(2 * d) + tid, b.load("Q", h * dd + tid))
    b.barrier("kvq-staged")
    ki = b.load_shared(row)
    vj = b.load_shared(dd + col)
    cidx = h * b.const(d * d) + tid              # == (h*d+row)*d+col
    cnew = fg * b.load("Cin", cidx) + ig * ki * vj
    b.store("Cout", cidx, cnew)
    nnew = fg * b.load("Nin", h * dd + lane) + ig * b.load_shared(lane)
    with b.when(tid < dd):
        b.store("Nout", h * dd + tid, nnew)
    qn = b.load_shared(b.const(2 * d) + lane) * nnew
    contrib = b.select(tid < dd, qn, b.const(0.0, ir.F32))
    den = b.maximum(b.abs(b.reduce_add(contrib)), b.const(1.0, ir.F32))
    b.barrier("c-flushed")
    num = b.var(b.const(0.0, ir.F32), hint="num")
    with b.loop(d, hint="ii") as ii:
        b.assign(num, num + b.load_shared(b.const(2 * d) + ii)
                 * b.load("Cout", (h * dd + ii) * dd + lane))
    with b.when(tid < dd):
        b.store("Hout", h * dd + tid, num / den)
    prog = b.done()

    def oracle(args):
        fg = _f32(args["fg"])
        ig = _f32(args["ig"])
        Q = np.asarray(args["Q"], _F32)
        K = np.asarray(args["K"], _F32)
        V = np.asarray(args["V"], _F32)
        H = Q.size // d
        Cin = np.asarray(args["Cin"], _F32).reshape(H, d, d)
        Nin = np.asarray(args["Nin"], _F32).reshape(H, d)
        Cout = np.array(args["Cout"], _F32).reshape(H, d, d)
        Nout = np.array(args["Nout"], _F32).reshape(H, d)
        Hout = np.array(args["Hout"], _F32).reshape(H, d)
        B = d * d
        for hh in range(H):
            q = Q[hh * d:(hh + 1) * d]
            k = K[hh * d:(hh + 1) * d]
            v = V[hh * d:(hh + 1) * d]
            ik = ig * k
            cnew = (fg * Cin[hh]) + ik[:, None] * v[None, :]
            Cout[hh] = cnew
            nnew = (fg * Nin[hh]) + ik
            Nout[hh] = nnew
            qn = q * nnew
            contrib = np.zeros(B, _F32)
            contrib[:d] = qn
            dot = np.zeros((), _F32)
            for t in range(B):                 # lane-order fold (incl. zeros)
                dot = np.add(dot, contrib[t], dtype=_F32)
            den = np.maximum(np.abs(dot), _f32(1.0))
            num = np.zeros(d, _F32)
            for ii in range(d):
                num = num + q[ii] * cnew[ii, :]
            Hout[hh] = num / den
        return {"Cout": Cout.reshape(-1), "Nout": Nout.reshape(-1),
                "Hout": Hout.reshape(-1)}

    return prog, oracle


# ---------------------------------------------------------------------------
# Canonical launches, EXAMPLES-style: name -> (grid, block, make_args, outs)
# ---------------------------------------------------------------------------

_ATTN_H = 4
_ATTN_NTILES = 3
_MOE_N = 64        # grid 4 x block 16
_RGLRU_C = 8
_MLSTM_H = 4


def _attn_args(rng):
    H, D, T, nt = _ATTN_H, ATTN_D, ATTN_T, _ATTN_NTILES
    S = nt * T
    return {
        "Q": rng.standard_normal(H * D).astype(_F32),
        "K": rng.standard_normal(H * S * D).astype(_F32),
        "V": rng.standard_normal(H * S * D).astype(_F32),
        "O": np.zeros(H * D, _F32),
        "ntiles": nt,
        "scale": _f32(1.0 / np.sqrt(D)),
    }


def _moe_args(rng):
    N, E, F = _MOE_N, MOE_E, MOE_F
    return {
        "X": rng.standard_normal(N * F).astype(_F32),
        "Wg": rng.standard_normal(E * F).astype(_F32),
        "We": rng.standard_normal(E * F * F).astype(_F32),
        "Y": np.zeros(N * F, _F32),
        "Eidx": np.zeros(N, np.int32),
        "E": E,
        "F": F,
    }


def _rglru_args(rng):
    C, T = _RGLRU_C, RGLRU_T
    return {
        # log gates in [-0.5, -0.01]: decaying memory, exp() well-conditioned
        "LA": (-(rng.random(C * T) * 0.49 + 0.01)).astype(_F32),
        "Xv": rng.standard_normal(C * T).astype(_F32),
        "H0": rng.standard_normal(C).astype(_F32),
        "Hout": np.zeros(C * T, _F32),
    }


def _mlstm_args(rng):
    H, d = _MLSTM_H, MLSTM_D
    return {
        "Q": rng.standard_normal(H * d).astype(_F32),
        "K": rng.standard_normal(H * d).astype(_F32),
        "V": rng.standard_normal(H * d).astype(_F32),
        "Cin": rng.standard_normal(H * d * d).astype(_F32),
        "Nin": rng.standard_normal(H * d).astype(_F32),
        "Cout": np.zeros(H * d * d, _F32),
        "Nout": np.zeros(H * d, _F32),
        "Hout": np.zeros(H * d, _F32),
        "fg": _f32(0.9),
        "ig": _f32(0.4),
    }


ZOO: Dict[str, Callable] = {
    "attn_decode": attn_decode,
    "moe_route_gmm": moe_route_gmm,
    "rglru_step": rglru_step,
    "mlstm_cell": mlstm_cell,
}

ZOO_EXAMPLES: Dict[str, tuple] = {
    "attn_decode": (_ATTN_H, ATTN_T, _attn_args, ("O",)),
    "moe_route_gmm": (4, 16, _moe_args, ("Y", "Eidx")),
    "rglru_step": (_RGLRU_C, RGLRU_T, _rglru_args, ("Hout",)),
    "mlstm_cell": (_MLSTM_H, MLSTM_D * MLSTM_D, _mlstm_args,
                   ("Cout", "Nout", "Hout")),
}

for _name, _builder in ZOO.items():
    register_kernel(_name, _builder, ZOO_EXAMPLES[_name], registry="zoo")
