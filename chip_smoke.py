#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``src/repro_torch``) on one NVIDIA
GPU.  Run from the root of a checkout:

    python3 chip_smoke.py

It drives the port's main path — ``HetSession.load`` →
``Function.launch_async`` → ``Engine`` → ``CudaBackend.run_segment`` → the
translated CUDA segment kernels — and holds every result against the plain
version of the kernels (the eager-PyTorch ``vectorized`` backend on the same
card) and against the NumPy oracles:

0. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the ``nvcc`` build of every segment library used below (one ``nvcc``
   per optimized program and lanes a thread) and of the six hand-written
   kernels of ``repro_torch.kernels`` (one ``nvcc`` per source), in one
   batch that runs one ``nvcc`` per CPU core at a time, with ``ptxas``'s
   registers and spills of every hand-written kernel's builds;
1. all 17 suite and 4 zoo kernels at their canonical launch, at O0 and
   OPT_MAX: bits equal to the plain version on the card and to the NumPy
   interpreter on the CPU (NaN compared as NaN), within 1e-5 of the suite
   oracles and bit-equal to the zoo oracles; ``block_stats`` equal to the
   verdicts pinned below (checked against the JAX reference by the CPU
   tests); then the one-op edge-grid programs of
   ``repro_torch.core.edge_grids`` (DIV/MOD/shifts/casts/MIN/MAX on edge
   values, folds of ``-0.0``, folds and votes under divergence, atomic and
   store order, shuffles), bits equal to the plain version and the
   interpreter; then the programs with cross-lane ops (folds, scans,
   votes, ``REDUCE_MAX`` ties, atomics, shuffles, and the suite's
   reduction, scan, vote and dot product) in blocks of 2048 lanes, two to
   a thread of the scalar kernels, bits equal likewise;
2. full width, scalar path: one ``attn_decode`` step at Llama 3.2 3B's 24
   query heads of width 128 over a 4096-token window (K and V 48 MiB each),
   bits equal to the zoo oracle and to the plain version; then a second
   launch paused after 3 segments, checkpointed, restored in a CPU
   ``vectorized`` session, advanced 2 segments there, migrated back to the
   card and finished — bits unchanged; the step must have run a segment
   kernel that staged its K tile in shared memory and one that folded
   ``REDUCE_MAX`` by a shuffle tree (``CudaBackend.scalar_paths``);
3. full width, block path: ``vadd`` over 2^24 elements, whose block kernel
   must move no register array (per-segment liveness): the bytes per
   element its slots imply are printed;
4. times: one launch of 2 and of 3 (median over warm launches, CUDA
   events), the device time of its segment kernels alone, their plain
   versions, one PyTorch call computing the same function as a yardstick,
   and each kernel's bound; then one launch of each under
   ``torch.profiler``, with the device time of every kernel it ran (the
   segment kernels and the engine's copies) and the device's busy share.

5. the kernel library (``repro_torch.kernels``) at full width, through
   its user entry points (the ``autograd.Function`` ops): flash attention
   at Llama 3.2 3B's prefill (24 heads of 128 over 4096 tokens, causal,
   bf16 on the wgmma/TMA kernel and f32 on the CUDA-core one, each with
   its own launch count) and recurrentgemma-2b's local attention (10
   heads of 256, window 2048, bf16 and f32); the MoE grouped matmul at granite-moe-3b-a800m's
   experts (40 x 1024 rows x 1536 -> 512, seeded counts with an empty and
   a full expert; bf16 on the wgmma/TMA kernel, f32 on the CUDA-core one,
   each with its own launch count); the RG-LRU scan at recurrentgemma-2b's
   width (4096 steps x 2560 channels, bf16); the mLSTM chunk kernels at
   xlstm-125m's width (32 batch-heads x 4096 steps, dk = dv = 384, f32,
   bt 128), with the operations they execute against the bound's; and the
   domain the port repaired: bf16 attention that TMA cannot load (d =
   100, 4 bytes off 16-byte alignment: the CUDA-core kernel's bf16
   build), a head of 320 (its wide build), the mLSTM with chunks of 256
   and keys of 704.  Each result is held against the kernel's plain version and
   the torch oracle on the card, at the JAX tests' tolerances in the
   working type (grouped matmul 5e-2 bf16, 1e-4 f32) — except bf16
   attention, held to one bf16 step (``BF16_ATTN_TOL``): at 4096 tokens
   its outputs are near 0.03, so the tests' 2e-2 would hide a mask error; each attention case also checks
   that oracles with a planted mask error (a band one key short or long,
   late rows missing their first kv tile) fall outside its tolerance;
   empty experts must be exact zeros, the scan bit-equal,
   the mLSTM kernels at bt 32 within 1e-3 of bt 128 and executing at most
   1.15 times the bound's operations; one small gradient per
   op through its ``autograd.Function`` against autograd of the oracle;
   and ``het_kernel`` runs a suite program on the card bit-equal to
   ``het_kernel_ref``.

Phase 4 runs last and also times the six library kernels (CUDA events,
median of warm launches, and the profiler's device time), their plain
versions, and the one PyTorch call that computes the same function where
there is one (``scaled_dot_product_attention`` for flash attention,
``torch.bmm`` for the grouped matmul).

In the ``kernels`` line, a segment kernel's ``ms`` is the device time of
the segment kernels of one launch, ``launch_ms`` the latency of the whole
launch (host work and the engine's copies included), ``plain_ms`` the same
launch through the plain version on the card; a library kernel's ``ms`` is
the time of one call at the main path's shape (CUDA events around the
call, so the host's work before the launch counts where the device waits
for it), ``device_ms`` the device time of its kernels alone (from
``torch.profiler``; null where the profiler saw no device activity),
``plain_ms`` its plain version's; ``library_ms`` and
``library_device_ms`` the same two for the PyTorch call.

The launch counts of the kernels are reset before phases 2-3 and read after
them, and reset before phase 5's main path and read after it.  Any
mismatch or launch error ends the run with a non-zero code.  The last line
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: memory rate of one H100 SXM (NVIDIA data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
#: float32 rate outside the tensor cores (same source)
F32_OPS_PER_S = 67e12
#: dense bf16 rate of the tensor cores (same source)
BF16_OPS_PER_S = 989e12

#: block-path verdicts per kernel and opt level at the canonical launch:
#: (tiled segment executions, scalar executions, refusal categories).
#: tests/test_torch_ir.py holds this table against the JAX reference.
PINNED_BLOCK_STATS = {
    "vadd": {0: (1, 0, {}), 3: (1, 0, {})},
    "saxpy": {0: (1, 0, {}), 3: (1, 0, {})},
    "matmul_tiled": {0: (1, 5, {"shared-memory": 4, "unprovable-base": 1}),
                     3: (1, 5, {"shared-memory": 4, "unprovable-base": 1})},
    "reduction": {0: (1, 7, {"shared-memory": 7}),
                  3: (1, 7, {"shared-memory": 7})},
    "inclusive_scan": {0: (0, 1, {"collective": 1}),
                       3: (0, 1, {"collective": 1})},
    "bitcount_vote": {0: (0, 1, {"collective": 1}),
                      3: (0, 1, {"collective": 1})},
    "montecarlo_pi": {0: (0, 1, {"collective": 1}),
                      3: (0, 1, {"collective": 1})},
    "nn_layer": {0: (0, 1, {"collective": 1}), 3: (0, 1, {"collective": 1})},
    "stencil_1d": {0: (1, 0, {}), 3: (1, 0, {})},
    "persistent_counter": {0: (1, 4, {"opaque-index": 4}),
                           3: (1, 4, {"opaque-index": 4})},
    "dot_product": {0: (0, 1, {"collective": 1}),
                    3: (0, 1, {"collective": 1})},
    "poly_eval": {0: (1, 0, {}), 3: (1, 0, {})},
    "swizzle_copy": {0: (1, 0, {}), 3: (1, 0, {})},
    "tap_filter": {0: (1, 1, {"opaque-index": 1}),
                   3: (1, 1, {"opaque-index": 1})},
    "dyn_matmul": {0: (1, 9, {"shared-memory": 8, "unprovable-base": 1}),
                   3: (1, 9, {"shared-memory": 8, "unprovable-base": 1})},
    "dyn_fir": {0: (1, 0, {}), 3: (1, 0, {})},
    "decode_gemv": {0: (1, 9, {"opaque-index": 1, "shared-memory": 8}),
                    3: (1, 9, {"opaque-index": 1, "shared-memory": 8})},
    "attn_decode": {0: (1, 8, {"shared-memory": 7, "unprovable-base": 1}),
                    3: (1, 8, {"shared-memory": 7, "unprovable-base": 1})},
    "moe_route_gmm": {0: (0, 1, {"unprovable-base": 1}),
                      3: (0, 1, {"unprovable-base": 1})},
    "rglru_step": {0: (0, 1, {"collective": 1}), 3: (0, 1, {"collective": 1})},
    "mlstm_cell": {0: (0, 3, {"shared-memory": 3}),
                   3: (0, 3, {"shared-memory": 3})},
}

#: full-width decode step: Llama 3.2 3B (src/repro/configs/llama3_2_3b.py)
#: has 24 query heads of width 128; 32 kv tiles of 128 keys = 4096 tokens
ATTN_H, ATTN_D, ATTN_T, ATTN_NTILES = 24, 128, 128, 32
#: full-width elementwise launch: 2^24 float32 elements, block 256
VADD_N, VADD_BLOCK = 1 << 24, 256

#: phase 5 shapes, from the repo's model configurations (src/repro/configs):
#: Llama 3.2 3B prefill: 24 query heads of 128 (kv repeated), 4096 tokens
FA_B, FA_H, FA_S, FA_D = 1, 24, 4096, 128
#: recurrentgemma-2b local attention: 10 heads of 2560 / 10, window 2048
RGA_H, RGA_D, RGA_WINDOW = 10, 256, 2048
#: granite-moe-3b-a800m experts: 40 experts, d_model 1536, d_ff 512 each;
#: capacity of a 4096-token batch at top-8 and factor 1.25:
#: ceil(4096 * 8 / 40 * 1.25) = 1024 rows
GMM_E, GMM_C, GMM_D, GMM_F = 40, 1024, 1536, 512
#: recurrentgemma-2b RG-LRU: d_rnn 2560, 4096 steps, one sequence
RG_B, RG_S, RG_D = 1, 4096, 2560
#: xlstm-125m mLSTM: 4 heads of (2 * 768) / 4 = 384 keys and values, a
#: batch of 8 sequences of 4096 steps, chunks of 128
ML_BH, ML_S, ML_DK, ML_BT = 8 * 4, 4096, 384, 128
#: the port's repaired domain (phase 5): bf16 flash attention that TMA
#: cannot load (d = 100, tensors 4 bytes off 16-byte alignment) and a head
#: wider than 256, at 8 heads over 2048 tokens; the mLSTM with chunks of
#: 256 steps (run as 128) and keys of 704, at 2 batch-heads of 1024 steps
REPAIR_H, REPAIR_S, REPAIR_D_BF16, REPAIR_D_WIDE = 8, 2048, 100, 320
REPAIR_ML_BH, REPAIR_ML_S, REPAIR_ML_DK, REPAIR_ML_DV, REPAIR_ML_BT = \
    2, 1024, 704, 64, 256
#: the hetIR block of phase 1's wide launches: two lanes a CUDA thread
WIDE_BLOCK = 2048
#: bf16 attention outputs, (atol, rtol): the kernel, its plain version and
#: the oracle all round an f32 result to bf16, and f32 sums in another
#: order round at most one bf16 step (2^-7 of the value) apart; 1e-3
#: absolute for outputs near 0
BF16_ATTN_TOL = (1e-3, 2.0 ** -7)
#: the TPU kernel each library kernel replaces (its Pallas wrapper)
REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:98",
    "flash_attention_sm90": "src/repro/kernels/flash_attention/kernel.py:98",
    "flash_attention_bf16": "src/repro/kernels/flash_attention/kernel.py:98",
    "flash_attention_wide": "src/repro/kernels/flash_attention/kernel.py:98",
    "moe_gmm": "src/repro/kernels/moe_gmm/kernel.py:47",
    "moe_gmm_sm90": "src/repro/kernels/moe_gmm/kernel.py:47",
    "rglru_scan": "src/repro/kernels/rglru_scan/kernel.py:54",
    "mlstm_chunk": "src/repro/kernels/mlstm_chunk/kernel.py:79",
}
#: the CUDA source of each kernel in the kernels line (the bf16 and wide
#: flash builds are builds of flash_attention.cu)
KERNEL_SOURCE = {"flash_attention_bf16": "flash_attention",
                 "flash_attention_wide": "flash_attention"}


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def same_bits(a, b) -> bool:
    """Raw 32-bit equality with every NaN mapped to one pattern: x86 and
    the card produce different NaN payloads (0xFFC00000 vs 0x7FFFFFFF for
    0/0), and no hetIR op reads a payload."""
    import numpy as np
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == np.float32:
        na, nb = np.isnan(a), np.isnan(b)
        return bool(np.array_equal(na, nb)) and bool(np.array_equal(
            a[~na].view(np.uint32), b[~nb].view(np.uint32)))
    return bool(np.array_equal(a, b))


def max_abs_err(a, b) -> float:
    import numpy as np
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    both_nan = np.isnan(a) & np.isnan(b)
    d = np.abs(np.where(both_nan, 0.0, a - b))
    return float(np.nanmax(d)) if d.size else 0.0


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def ptxas_report(log: str) -> list:
    """``(entry, line)`` for each registers and spill line of ``ptxas -v``
    output, the entry function as ``name<template arguments>`` (mangled:
    ``Li128E`` is the int 128, ``Lb1E`` true, ``f`` float)."""
    import re
    found, entry = [], "?"
    for line in log.splitlines():
        m = re.search(r"entry function '_ZN?([^']+)'", line)
        if m:   # (<length><identifier>)+ [I<arguments>E] E v ...
            name, rest = "?", m.group(1)
            while rest[:1].isdigit():
                n = re.match(r"\d+", rest).group()
                name, rest = rest[len(n):len(n) + int(n)], rest[len(n) + int(n):]
            entry = f"{name}<{rest[1:rest.find('EEv')]}>" \
                if rest.startswith("I") else name
        elif "registers" in line or "spill" in line:
            found.append((entry, line.split(":", 1)[-1].strip()))
    return found


def run_launch(session, prog, grid, block, args, outs):
    """One launch through the driver API; returns (record, host outputs)."""
    from repro_torch.core import hetir as ir
    fn = session.load(prog).function()
    bound = {}
    for p in prog.params:
        if isinstance(p, ir.Ptr):
            bound[p.name] = session.alloc(
                int(args[p.name].size), p.dtype).copy_from_host(args[p.name])
        else:
            bound[p.name] = args[p.name]
    rec = fn.launch_async(grid, block, bound)
    check(rec.wait(), f"{prog.name}: launch did not finish")
    return rec, {o: rec.buffer(o).copy_to_host() for o in outs}


def time_ms(fn, reps: int) -> float:
    """Median time of ``fn()`` over ``reps`` warm calls, CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_device_ms(backend, go) -> tuple:
    """Device time of the segment kernels one call of ``go()`` launches —
    CUDA events recorded on the stream right before and after each kernel
    launch call — their number, and ``{(segment, mode): [ms, launches]}``.
    The rest of a launch's time is host work the device waits for."""
    import torch
    events = []
    wrapped = []

    def timing(key, fn):
        def timed(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            err = fn(*args)
            end.record()
            events.append((key, start, end))
            return err
        return timed

    for mod in backend._modules.values():
        for key, fn in list(mod.fns.items()):
            wrapped.append((mod, key, fn))
            mod.fns[key] = timing(key, fn)
    try:
        go()
    finally:
        for mod, key, fn in wrapped:
            mod.fns[key] = fn
    torch.cuda.synchronize()
    per = {}
    for key, a, b in events:
        ms = a.elapsed_time(b)
        per.setdefault(key, [0.0, 0])
        per[key][0] += ms
        per[key][1] += 1
    return sum(ms for ms, _ in per.values()), len(events), per


def profile_launch(go) -> dict:
    """Device time (ms) of every kernel and copy that one warm call of
    ``go()`` runs, by name, from a ``torch.profiler`` trace; empty when the
    profiler recorded no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    go()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        go()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    return by_name


def print_profile(what: str, by_name: dict, launch_ms: float) -> None:
    if not by_name:
        print(f"# profile {what}: torch.profiler recorded no device "
              "activity (device busy share not measured)")
        return
    busy = sum(by_name.values())
    print(f"# profile {what}: device busy {busy:.4f} ms of a "
          f"{launch_ms:.4f} ms launch (busy share {busy / launch_ms:.4f})")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        print(f"#   {ms:.4f} ms  {name[:90]}")


def wide_cases(block: int) -> list:
    """(label, case) of the programs with cross-lane ops in blocks of
    ``block`` lanes: the edge grids' and the suite's."""
    from repro_torch.core import edge_grids
    return list(edge_grids.wide_cases(block)) + [
        (name, edge_grids.wide_suite_case(name, block))
        for name in edge_grids.WIDE_SUITE]


def check_edge_grids(dev, cases=None) -> int:
    """Every edge-grid program (or every one of ``cases``) through
    ``HetSession("cuda")`` on ``dev``, bits equal to the plain version on
    ``dev`` and to the interpreter on the CPU (NaN as NaN); returns the
    number of programs."""
    from repro_torch.core import HetSession, TranslationCache
    from repro_torch.core import edge_grids
    cases = list(edge_grids.all_cases()) if cases is None else cases
    for label, (prog, grid, block, args, outs) in cases:
        got = {}
        for backend, device in (("cuda", dev), ("vectorized", dev),
                                ("interp", "cpu")):
            s = HetSession(backend, opt_level=0, device=device,
                           cache=TranslationCache())
            _, got[backend] = run_launch(s, prog, grid, block, args, outs)
        for o in outs:
            check(same_bits(got["cuda"][o], got["vectorized"][o]),
                  f"edge grid {label} {o}: kernel != plain version")
            check(same_bits(got["cuda"][o], got["interp"][o]),
                  f"edge grid {label} {o}: kernel != interpreter")
    return len(cases)


def _outs(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def _close(got, want, tol) -> bool:
    """Within ``tol``: ``(atol, rtol)``, or one number for both; bit-equal
    for 0."""
    import torch
    atol, rtol = tol if isinstance(tol, tuple) else (tol, tol)
    return all(torch.equal(g, w) if tol == 0 else
               torch.allclose(g.float(), w.float(), atol=atol, rtol=rtol)
               for g, w in zip(_outs(got), _outs(want)))


def _err(got, want) -> float:
    return max(float((g.float() - w.float()).abs().max())
               for g, w in zip(_outs(got), _outs(want)))


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class LibCase:
    """One full-width call of a library kernel: the user entry point
    (``op``, the main path), the wrapper alone (``fwd``, for timing), its
    plain version and oracle on the same inputs, the tolerance in the
    working type (0: bit-equal), the bytes and operations of its bound,
    the PyTorch call that computes the same function where there is one,
    a second tiling of the kernel that must agree within 1e-3, a
    predicate the output must meet (its docstring says what failed), and
    oracles with a planted error, ``(what, call)``, that the tolerance must
    refuse."""

    def __init__(self, kernel, label, op, fwd, plain, ref, tol, nbytes,
                 ops, ops_rate, library=None, retiled=None, invariant=None,
                 planted=()):
        self.kernel, self.label = kernel, label
        self.op, self.fwd, self.plain, self.ref = op, fwd, plain, ref
        self.tol, self.nbytes, self.ops = tol, nbytes, ops
        self.ops_rate, self.library, self.retiled = ops_rate, library, retiled
        self.invariant, self.planted = invariant, planted
        self.out = self.err = None

    def bound(self) -> tuple:
        """(bound in ms, "bytes" or "operations")."""
        t_bytes = self.nbytes / HBM_BYTES_PER_S
        t_ops = self.ops / self.ops_rate
        return max(t_bytes, t_ops) * 1e3, \
            "bytes" if t_bytes >= t_ops else "operations"


def library_cases(dev) -> list:
    """The phase 5 calls, on inputs made on the card from a seed."""
    import torch
    import torch.nn.functional as tf
    from repro_torch.kernels import (flash_attention, mlstm_chunk, moe_gmm,
                                     rglru_scan)
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.mlstm_chunk import kernel as ml
    from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_ref
    from repro_torch.kernels.moe_gmm import kernel as gmm
    from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref
    from repro_torch.kernels.rglru_scan import kernel as rg
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

    gen = torch.Generator(device=dev).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, scale=1.0, dtype=f32):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def uniform(lo, hi, *shape):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    def attn_pairs(S, window):
        q = torch.arange(S, dtype=torch.float64)
        seen = q + 1 if window is None else torch.clamp(q + 1, max=window)
        return float(seen.sum())

    cases = []

    def flash(label, q, k, v, window, library, kernel=None):
        B, H, S, d = q.shape
        rate = BF16_OPS_PER_S if q.dtype == bf16 else F32_OPS_PER_S
        if window is None:   # rows S-32.. miss up to 32 of their first keys
            planted = [("late rows missing their first kv tile",
                        lambda: attention_ref(q, k, v, causal=True,
                                              window=S - 32))]
        else:
            planted = [(f"the band one key {what}",
                        lambda w=window + dw: attention_ref(
                            q, k, v, causal=True, window=w))
                       for what, dw in (("short", -1), ("long", 1))]
        # bf16 runs on the wgmma/TMA kernel, f32 on the CUDA-core one
        cases.append(LibCase(
            kernel or ("flash_attention_sm90" if q.dtype == bf16
                       else "flash_attention"),
            label,
            lambda: flash_attention(q, k, v, True, window),
            lambda: fa.flash_attention_fwd(q, k, v, causal=True,
                                           window=window),
            lambda: fa.flash_attention_plain(q, k, v, causal=True,
                                             window=window),
            lambda: attention_ref(q, k, v, causal=True, window=window),
            BF16_ATTN_TOL if q.dtype == bf16 else 2e-5, _nbytes(q, k, v, q),
            4 * d * B * H * attn_pairs(S, window), rate, library,
            planted=planted))

    qkv = [randn(FA_B, FA_H, FA_S, FA_D, dtype=bf16) for _ in range(3)]
    flash("Llama 3.2 3B prefill, bf16", *qkv, None,
          lambda: tf.scaled_dot_product_attention(*qkv, is_causal=True))
    qkv32 = [t.float() for t in qkv]
    flash("Llama 3.2 3B prefill, f32", *qkv32, None,
          lambda: tf.scaled_dot_product_attention(*qkv32, is_causal=True))
    rqkv = [randn(1, RGA_H, FA_S, RGA_D, dtype=bf16) for _ in range(3)]
    pos = torch.arange(FA_S, device=dev)
    band = (pos[None, :] <= pos[:, None]) \
        & (pos[None, :] > pos[:, None] - RGA_WINDOW)
    flash("recurrentgemma-2b local attention, bf16", *rqkv, RGA_WINDOW,
          lambda: tf.scaled_dot_product_attention(*rqkv, attn_mask=band))
    rqkv32 = [t.float() for t in rqkv]
    flash("recurrentgemma-2b local attention, f32", *rqkv32, RGA_WINDOW,
          lambda: tf.scaled_dot_product_attention(*rqkv32, attn_mask=band))

    counts = torch.randint(0, GMM_C + 1, (GMM_E,), generator=gen,
                           device=dev, dtype=torch.int32)
    counts[0], counts[1] = 0, GMM_C          # one empty, one full expert
    x = randn(GMM_E, GMM_C, GMM_D, dtype=bf16)
    w = randn(GMM_E, GMM_D, GMM_F, scale=GMM_D ** -0.5, dtype=bf16)
    live = counts.long()
    dead = torch.arange(GMM_C, device=dev)[None, :] >= counts[:, None]
    x[dead] = 0                # the contract: rows past counts[e] are zero

    def dead_rows_zero(out):
        """rows past counts[e] (all of the empty expert) are not zeros"""
        return bool((out[dead] == 0).all())

    # bf16 runs on the wgmma/TMA kernel, f32 on the CUDA-core one; the
    # bound counts live rows of x, the weights of experts with a live row,
    # all of the output and the counts
    for kernel, xe, we, rate, tol in (
            ("moe_gmm_sm90", x, w, BF16_OPS_PER_S, 5e-2),
            ("moe_gmm", x.float(), w.float(), F32_OPS_PER_S, 1e-4)):
        size = xe.element_size()
        cases.append(LibCase(
            kernel, "granite-moe-3b-a800m experts, "
            + ("bf16" if xe.dtype == bf16 else "f32"),
            lambda xe=xe, we=we: moe_gmm(xe, we, counts),
            lambda xe=xe, we=we: gmm.moe_gmm_fwd(xe, we, counts),
            lambda xe=xe, we=we: gmm.moe_gmm_plain(xe, we, counts),
            lambda xe=xe, we=we: moe_gmm_ref(xe, we, counts), tol,
            (int(live.sum()) * GMM_D + int((live > 0).sum()) * GMM_D * GMM_F
             + GMM_E * GMM_C * GMM_F) * size + 4 * GMM_E,
            2.0 * int(live.sum()) * GMM_D * GMM_F, rate,
            lambda xe=xe, we=we: torch.bmm(xe, we), invariant=dead_rows_zero))

    a = uniform(0.7, 0.999, RG_B, RG_S, RG_D).to(bf16)
    xr = randn(RG_B, RG_S, RG_D, scale=0.1, dtype=bf16)
    h0 = randn(RG_B, RG_D, scale=0.1)
    cases.append(LibCase(
        "rglru_scan", "recurrentgemma-2b RG-LRU, bf16",
        lambda: rglru_scan(a, xr, h0), lambda: rg.rglru_scan_fwd(a, xr, h0),
        lambda: rg.rglru_scan_plain(a, xr, h0),
        lambda: rglru_scan_ref(a, xr, h0), 0.0,
        _nbytes(a, xr, a, h0, h0), 2.0 * RG_B * RG_S * RG_D,
        F32_OPS_PER_S))

    def mlstm(label, BH, S, dk, dv, bt, retiled):
        q, k = (randn(BH, S, dk, scale=0.5) for _ in range(2))
        v = randn(BH, S, dv, scale=0.5)
        lf = torch.log(uniform(0.9, 0.999, BH, S, 1))
        gi = uniform(0.1, 1.0, BH, S, 1)
        n = bt
        # multiply-adds of a chunk of bt steps: q k^T and (s * decay) v
        # over the causal triangle of n(n+1)/2 pairs, q @ C and the state
        # update k^T v in full
        per_chunk = 2 * ((n * (n + 1) // 2) * (dk + dv) + 2 * n * dk * dv)
        case = LibCase(
            "mlstm_chunk", label,
            lambda: mlstm_chunk(q, k, v, lf, gi, bt),
            lambda: ml.mlstm_chunk_fwd(q, k, v, lf, gi, bt=bt),
            lambda: ml.mlstm_chunk_plain(q, k, v, lf, gi, bt=bt),
            lambda: mlstm_chunk_ref(q, k, v, lf, gi), 2e-3,
            _nbytes(q, k, v, lf, gi, v) + BH * dk * dv * 4,
            float(per_chunk) * BH * (S // bt), F32_OPS_PER_S,
            retiled=(lambda: ml.mlstm_chunk_fwd(q, k, v, lf, gi, bt=32))
            if retiled else None)
        # what the three kernels execute, tiles and padding included
        case.executed = ml.executed_ops(BH, S, dk, dv, bt)
        cases.append(case)

    mlstm("xlstm-125m mLSTM, f32, bt 128", ML_BH, ML_S, ML_DK, ML_DK, ML_BT,
          True)

    # the repaired domain, last, so that the cases above draw the inputs
    # of earlier runs: bf16 that TMA cannot load (d = 100, 4 bytes off
    # 16-byte alignment) on the CUDA-core kernel's bf16 build, and a head
    # of 320 on its wide build
    def off16(t):
        buf = torch.empty(t.numel() + 2, dtype=t.dtype, device=dev)
        out = buf[2:].view(t.shape)
        out.copy_(t)
        return out

    bqkv = [off16(randn(1, REPAIR_H, REPAIR_S, REPAIR_D_BF16, dtype=bf16))
            for _ in range(3)]
    check(all(t.data_ptr() % 16 == 4 for t in bqkv),
          "the unaligned bf16 inputs are aligned")
    flash(f"bf16 d={REPAIR_D_BF16}, 4 bytes off 16-byte alignment", *bqkv,
          None, lambda: tf.scaled_dot_product_attention(*bqkv,
                                                        is_causal=True),
          kernel="flash_attention_bf16")
    wqkv = [randn(1, REPAIR_H, REPAIR_S, REPAIR_D_WIDE) for _ in range(3)]
    flash(f"f32 d={REPAIR_D_WIDE}", *wqkv, None,
          lambda: tf.scaled_dot_product_attention(*wqkv, is_causal=True),
          kernel="flash_attention_wide")

    mlstm(f"mLSTM, f32, bt {REPAIR_ML_BT}, dk {REPAIR_ML_DK}", REPAIR_ML_BH,
          REPAIR_ML_S, REPAIR_ML_DK, REPAIR_ML_DV, REPAIR_ML_BT, False)
    return cases


def _tol_text(tol) -> str:
    return f"{tol[0]} + {tol[1]:.4g}|x|" if isinstance(tol, tuple) \
        else str(tol)


def check_library_case(c: LibCase) -> None:
    """Hold phase 5's output of one case against the plain version and the
    oracle, its invariant and second tiling; check that its tolerance
    refuses each planted error; print what was found."""
    want = c.plain()
    check(_close(c.out, want, c.tol), f"{c.label}: kernel != plain version")
    c.err = _err(c.out, want)
    want = c.ref()
    check(_close(c.out, want, c.tol), f"{c.label}: kernel != oracle")
    ref_err = _err(c.out, want)
    also = ""
    if c.invariant is not None:
        check(c.invariant(c.out), f"{c.label}: {c.invariant.__doc__}")
        also += "; dead rows exact zeros"
    if c.retiled is not None:
        check(_close(c.out, c.retiled(), 1e-3),
              f"{c.label}: bt 32 != bt {ML_BT}")
        also += f"; bt 32 within 1e-3 of bt {ML_BT}"
        # the redesign's budget: at most 1.15 times the bound's operations
        check(c.executed <= 1.15 * c.ops,
              f"{c.label}: the kernels execute {c.executed:.6g} operations, "
              f"more than 1.15 x the bound's {c.ops:.6g}")
        also += (f"; executes {c.executed / c.ops:.4f} x the bound's "
                 "operations")
    for what, call in c.planted:
        bad = call()
        check(not _close(bad, want, c.tol),
              f"{c.label}: tolerance {_tol_text(c.tol)} misses {what}")
        seen = "also" if not _close(bad, want, 2e-2) else "not"
        also += (f"; refuses {what} (max abs err {_err(bad, want):.4g}, "
                 f"{seen} refused at 2e-2)")
        del bad
    print(f"phase 5: {c.label}: kernel within {_tol_text(c.tol)} of the "
          f"plain version (max abs err {c.err:.4g}) and the oracle "
          f"({ref_err:.4g}){also}")


def check_library_grads(dev) -> None:
    """One small gradient per op: its ``autograd.Function`` (forward
    kernel, backward through the oracle) against autograd of the oracle,
    at 1e-3."""
    import torch
    from repro_torch.kernels import (flash_attention, mlstm_chunk, moe_gmm,
                                     rglru_scan)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_ref
    from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref

    gen = torch.Generator(device=dev).manual_seed(1)

    def leaf(*shape, lo=None, hi=None):
        t = torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo \
            if lo is not None else \
            torch.randn(shape, generator=gen, device=dev) * 0.5
        return t.requires_grad_()

    def grads(fn, ins):
        loss = sum((o.float() ** 2).sum() for o in _outs(fn(*ins)))
        return torch.autograd.grad(loss, ins)

    counts = torch.tensor([20, 64], dtype=torch.int32, device=dev)
    xg = torch.randn((2, 64, 24), generator=gen, device=dev)
    xg[0, 20:] = 0
    pairs = {
        "flash_attention": (
            lambda q, k, v: flash_attention(q, k, v, True, None),
            lambda q, k, v: attention_ref(q, k, v, causal=True),
            [leaf(1, 2, 70, 64) for _ in range(3)]),
        "moe_gmm": (lambda x, w: moe_gmm(x, w, counts),
                    lambda x, w: moe_gmm_ref(x, w, counts),
                    [xg.requires_grad_(), leaf(2, 24, 40)]),
        "rglru_scan": (rglru_scan, rglru_scan_ref,
                       [leaf(1, 40, 16, lo=0.7, hi=0.99), leaf(1, 40, 16),
                        leaf(1, 16)]),
        "mlstm_chunk": (mlstm_chunk, mlstm_chunk_ref,
                        [leaf(2, 40, 8) for _ in range(3)]
                        + [torch.log(leaf(2, 40, 1, lo=0.9, hi=0.99))
                           .detach().requires_grad_(),
                           leaf(2, 40, 1, lo=0.1, hi=1.0)]),
    }
    for name, (op, ref, ins) in pairs.items():
        for g, r in zip(grads(op, ins), grads(ref, ins)):
            check(torch.allclose(g, r, atol=1e-3, rtol=1e-3),
                  f"{name}: gradient through the op != oracle's")


def main() -> int:
    if not (SRC / "repro_torch" / "core").is_dir():
        print("chip_smoke.py: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch import zoo
    from repro_torch.core import (Engine, HetSession, OPT_MAX,
                                  TranslationCache, migrate)
    from repro_torch.core import edge_grids
    from repro_torch.core import kernels_suite as ks
    from repro_torch.core.backends import get_backend, nvcc_build
    from repro_torch.core.backends.cuda_backend import (emit_module,
                                                        lanes_per_thread)
    from repro_torch.kernels import _cuda as kernel_lib

    dev = torch.device("cuda", 0)
    smi = smi_line()
    print(f"# card: {smi}")
    print(f"# torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    names = list(ks.SUITE) + list(ks.registered_examples("zoo"))
    levels = (0, OPT_MAX)

    # -- phase 0: build every segment library the run needs -----------------
    rng = np.random.default_rng(0)
    attn_prog, attn_oracle = zoo.attn_decode(D=ATTN_D, T=ATTN_T)
    S = ATTN_NTILES * ATTN_T
    attn_args = {
        "Q": rng.standard_normal(ATTN_H * ATTN_D).astype(np.float32),
        "K": rng.standard_normal(ATTN_H * S * ATTN_D).astype(np.float32),
        "V": rng.standard_normal(ATTN_H * S * ATTN_D).astype(np.float32),
        "O": np.zeros(ATTN_H * ATTN_D, np.float32),
        "ntiles": ATTN_NTILES,
        "scale": np.float32(1.0 / math.sqrt(ATTN_D)),
    }
    vadd_prog, _ = ks.vadd()
    vadd_args = {
        "A": rng.standard_normal(VADD_N).astype(np.float32),
        "B": rng.standard_normal(VADD_N).astype(np.float32),
        "C": np.zeros(VADD_N, np.float32), "n": VADD_N,
    }
    builder = get_backend("cuda", device=dev)
    optimized = []
    for name in names:
        for lvl in levels:
            prog, _, grid, block, args, _ = ks.example_launch(
                name, rng=np.random.default_rng(42))
            optimized.append(
                Engine(prog, builder, grid, block, args, opt_level=lvl).program)
    optimized.append(Engine(attn_prog, builder, ATTN_H, ATTN_T, attn_args,
                            opt_level=OPT_MAX).program)
    optimized.append(Engine(vadd_prog, builder, VADD_N // VADD_BLOCK,
                            VADD_BLOCK, vadd_args, opt_level=OPT_MAX).program)
    for _, (prog, grid, block, args, _) in edge_grids.all_cases():
        optimized.append(
            Engine(prog, builder, grid, block, args, opt_level=0).program)
    # the wide launches of phase 1: their scalar kernels at two lanes a
    # thread, in libraries of their own
    wide = wide_cases(WIDE_BLOCK)
    lanes = lanes_per_thread(WIDE_BLOCK)
    wide_optimized = [Engine(prog, builder, grid, block, args,
                             opt_level=0).program
                      for _, (prog, grid, block, args, _) in wide]
    # one batch: an nvcc per generated source and per hand-written kernel
    jobs = [nvcc_build.segment_job(emit_module(p)[0]) for p in optimized]
    jobs += [nvcc_build.segment_job(emit_module(p, lanes)[0])
             for p in wide_optimized]
    jobs += [nvcc_build.kernel_job(n) for n in kernel_lib.SOURCES]
    built = nvcc_build.build(jobs)
    print(f"# nvcc: {built['built']} libraries built in "
          f"{built['seconds']:.1f} s for {len(optimized)} optimized programs, "
          f"{len(wide_optimized)} more at {lanes} lanes a thread and the "
          f"{len(kernel_lib.SOURCES)} hand-written kernels (one nvcc per "
          "source, one per CPU core at a time)")
    # ptxas's report of every hand-written kernel: registers and spills of
    # each template build
    for name in kernel_lib.SOURCES:
        log = built["logs"].get(nvcc_build.kernel_job(name)[1], "")
        for fn, line in ptxas_report(log):
            print(f"# ptxas {name} {fn}: {line}")

    # -- phase 1: every kernel against its plain version and the oracle ---------
    for name in names:
        for lvl in levels:
            got = {}
            for backend, device in (("cuda", dev), ("vectorized", dev),
                                    ("interp", "cpu")):
                prog, oracle, grid, block, args, outs = ks.example_launch(
                    name, rng=np.random.default_rng(42))
                s = HetSession(backend, opt_level=lvl, device=device,
                               cache=TranslationCache())
                _, got[backend] = run_launch(s, prog, grid, block, args, outs)
                if backend == "cuda":
                    st = s.block_stats()
                    torch.cuda.synchronize()
            oargs = dict(args, _num_blocks=grid, _block_size=block)
            want = oracle(oargs)
            for o in outs:
                k = got["cuda"][o]
                check(same_bits(k, got["vectorized"][o]),
                      f"{name} O{lvl} {o}: kernel != plain version")
                check(same_bits(k, got["interp"][o]),
                      f"{name} O{lvl} {o}: kernel != interpreter")
                if name in zoo.ZOO:
                    check(same_bits(k, np.asarray(want[o])),
                          f"{name} O{lvl} {o}: kernel != zoo oracle bits")
                else:
                    check(np.allclose(k, want[o], atol=1e-5, rtol=1e-5),
                          f"{name} O{lvl} {o}: kernel != suite oracle")
            pinned = PINNED_BLOCK_STATS[name][lvl]
            check((st["tiled"], st["scalar"], st["reasons"]) == pinned,
                  f"{name} O{lvl}: block_stats {st} != pinned {pinned}")
    print(f"phase 1: {len(names)} kernels x O0/O{OPT_MAX}: bits equal to the "
          "plain version and the interpreter, oracles met, block_stats as "
          "pinned")
    n_edge = check_edge_grids(dev)
    print(f"phase 1: {n_edge} edge-grid programs: bits equal to the plain "
          "version and the interpreter")
    n_wide = check_edge_grids(dev, wide)
    print(f"phase 1: {n_wide} programs with cross-lane ops in blocks of "
          f"{WIDE_BLOCK} lanes ({lanes} a thread): bits equal to the plain "
          "version and the interpreter")

    # -- phases 2-3: the main path at full width -------------------------------
    attn_want = attn_oracle(dict(attn_args))["O"]
    vadd_want = vadd_args["A"] + vadd_args["B"]
    gpu = HetSession("cuda", device=dev)
    vgpu = HetSession("cuda", device=dev)
    main_backends = (gpu.backend, vgpu.backend)
    for b in main_backends:
        b.launches.update(scalar=0, block=0)
        b.scalar_paths.update(staged=0, tree_fold=0)

    rec, out = run_launch(gpu, attn_prog, ATTN_H, ATTN_T, attn_args, ("O",))
    torch.cuda.synchronize()
    check(same_bits(out["O"], attn_want),
          "attn_decode full width: kernel != zoo oracle bits")
    step_launches = dict(gpu.backend.launches, **gpu.backend.scalar_paths)
    check(step_launches["staged"] > 0 and step_launches["tree_fold"] > 0,
          "attn_decode step: no segment kernel staged its K tile or folded "
          f"REDUCE_MAX by a shuffle tree: {step_launches}")
    segs_per_step = rec.engine.executed_ops and len(
        [t for t in gpu.sched_trace if t["seq"] == rec.seq])

    # second launch: pause after 3 segments, checkpoint, CPU hop, back
    fn = gpu.function("attn_decode")
    bufs = {p: gpu.alloc(attn_args[p].size).copy_from_host(attn_args[p])
            for p in ("Q", "K", "V", "O")}
    rec2 = fn.launch_async(ATTN_H, ATTN_T, dict(
        bufs, ntiles=ATTN_NTILES, scale=attn_args["scale"]))
    check(not rec2.advance(3), "attn_decode finished within 3 segments")
    blob = gpu.checkpoint(rec2)
    rec2.cancel()
    cpu = HetSession("vectorized", device="cpu")
    cpu.load(attn_prog)
    on_cpu = cpu.restore("attn_decode", blob)
    check(not on_cpu.advance(2), "attn_decode finished on the CPU hop")
    back = migrate(on_cpu, cpu, gpu, "attn_decode")
    check(back.wait(), "migrated attn_decode did not finish")
    torch.cuda.synchronize()
    check(same_bits(back.buffer("O").copy_to_host(), attn_want),
          "attn_decode cuda -> CPU eager -> cuda: bits changed")

    vrec, vout = run_launch(vgpu, vadd_prog, VADD_N // VADD_BLOCK, VADD_BLOCK,
                            vadd_args, ("C",))
    torch.cuda.synchronize()
    check(same_bits(vout["C"], vadd_want),
          "vadd 2^24: kernel != oracle bits")
    # the block kernel moves the buffers' words and no register array
    (vmod,) = vgpu.backend._modules.values()
    (vsl,) = [k.slots for k in vmod.kernels.values() if k.has_block]
    check(not vsl.inputs and not vsl.outputs,
          f"vadd block kernel has register slots: in {vsl.inputs}, out "
          f"{vsl.outputs}")
    vadd_slot_bytes = 4 * len(vsl.buffers + vsl.inputs + vsl.outputs)
    launches = {k: sum(dict(b.launches, **b.scalar_paths)[k]
                       for b in main_backends)
                for k in ("scalar", "block", "staged", "tree_fold")}
    check(launches["scalar"] > 0 and launches["block"] > 0,
          f"main path missed a kernel: launches {launches}")
    print("phase 2: attn_decode H=24 D=128 window 4096: bits equal to the "
          "oracle; cuda -> CPU eager -> cuda migration bit-identical")
    print(f"phase 3: vadd 2^24: bits equal to the oracle; its block kernel "
          f"has no register slot: {vadd_slot_bytes} B per element "
          f"({len(vsl.buffers)} buffer words)")
    print(f"# segment-kernel launches per decode step: {step_launches} "
          f"({segs_per_step} segments)")

    # -- plain versions at full width (on the card) ---------------------------
    plain = HetSession("vectorized", device=dev)
    _, pout = run_launch(plain, attn_prog, ATTN_H, ATTN_T, attn_args, ("O",))
    check(same_bits(out["O"], pout["O"]),
          "attn_decode full width: kernel != plain version")
    attn_err = max_abs_err(out["O"], pout["O"])
    _, pvout = run_launch(plain, vadd_prog, VADD_N // VADD_BLOCK, VADD_BLOCK,
                          vadd_args, ("C",))
    check(same_bits(vout["C"], pvout["C"]),
          "vadd 2^24: kernel != plain version")
    vadd_err = max_abs_err(vout["C"], pvout["C"])

    # -- phase 5: the kernel library at full width ----------------------------
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.hetir_gen import het_kernel
    from repro_torch.kernels.hetir_gen.ref import het_kernel_ref
    from repro_torch.kernels.mlstm_chunk.kernel import mlstm_chunk_fwd
    from repro_torch.kernels.moe_gmm.kernel import moe_gmm_fwd
    from repro_torch.kernels.rglru_scan.kernel import rglru_scan_fwd
    torch.backends.cuda.matmul.allow_tf32 = False   # the oracles in IEEE f32
    torch.backends.cudnn.allow_tf32 = False
    # each kernel's launch count: (wrapper, attribute)
    counters = {"flash_attention": (flash_attention_fwd, "launches"),
                "flash_attention_sm90": (flash_attention_fwd,
                                         "sm90_launches"),
                "flash_attention_bf16": (flash_attention_fwd,
                                         "simt_bf16_launches"),
                "flash_attention_wide": (flash_attention_fwd,
                                         "wide_launches"),
                "moe_gmm": (moe_gmm_fwd, "launches"),
                "moe_gmm_sm90": (moe_gmm_fwd, "sm90_launches"),
                "rglru_scan": (rglru_scan_fwd, "launches"),
                "mlstm_chunk": (mlstm_chunk_fwd, "launches")}
    cases = library_cases(dev)
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    for c in cases:
        c.out = c.op()
    torch.cuda.synchronize()
    lib_launches = {n: getattr(fn, attr)
                    for n, (fn, attr) in counters.items()}
    check(all(v > 0 for v in lib_launches.values()),
          f"phase 5 main path missed a kernel: launches {lib_launches}")
    for c in cases:
        check_library_case(c)
    check_library_grads(dev)
    print("phase 5: each op's gradient through its autograd.Function equals "
          "autograd of its oracle within 1e-3")
    prog, _, grid, block, args, _ = ks.example_launch(
        "matmul_tiled", rng=np.random.default_rng(42))
    het = het_kernel(prog, grid, block)
    got, want = het(**args), het_kernel_ref(prog, grid, block)(**args)
    torch.cuda.synchronize()
    check(all(same_bits(got[b], want[b]) for b in want),
          "het_kernel on the card != het_kernel_ref")
    check(sum(het.backend.launches.values()) > 0,
          "het_kernel launched no segment kernel")
    print(f"phase 5: het_kernel(matmul_tiled) on the card bit-equal to "
          f"het_kernel_ref; segment launches {dict(het.backend.launches)}")
    print(f"# kernel-library launches in phase 5's main path: {lib_launches}")

    # -- phase 4: times ---------------------------------------------------------
    def launcher(session, prog, grid, block, args):
        fn = session.load(prog).function()
        from repro_torch.core import hetir as ir
        bound = {}
        for p in prog.params:
            bound[p.name] = session.alloc(
                int(args[p.name].size), p.dtype).copy_from_host(
                    args[p.name]) if isinstance(p, ir.Ptr) else args[p.name]

        def go():
            r = fn.launch_async(grid, block, bound)
            check(r.wait(), "timed launch did not finish")
        return go

    attn_go = launcher(gpu, attn_prog, ATTN_H, ATTN_T, attn_args)
    attn_ms = time_ms(attn_go, 5)
    attn_dev_ms, attn_nk, attn_per = kernel_device_ms(gpu.backend, attn_go)
    attn_plain_ms = time_ms(launcher(plain, attn_prog, ATTN_H, ATTN_T,
                                     attn_args), 2)
    vadd_go = launcher(vgpu, vadd_prog, VADD_N // VADD_BLOCK, VADD_BLOCK,
                       vadd_args)
    vadd_ms = time_ms(vadd_go, 20)
    vadd_dev_ms, vadd_nk, _ = kernel_device_ms(vgpu.backend, vadd_go)
    vadd_plain_ms = time_ms(launcher(plain, vadd_prog, VADD_N // VADD_BLOCK,
                                     VADD_BLOCK, vadd_args), 5)

    q = torch.from_numpy(attn_args["Q"]).to(dev).view(ATTN_H, 1, ATTN_D)
    kk = torch.from_numpy(attn_args["K"]).to(dev).view(ATTN_H, S, ATTN_D)
    vv = torch.from_numpy(attn_args["V"]).to(dev).view(ATTN_H, S, ATTN_D)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    attn_lib_ms = time_ms(lambda: sdpa(q, kk, vv,
                                       scale=float(attn_args["scale"])), 20)
    a = torch.from_numpy(vadd_args["A"]).to(dev)
    b = torch.from_numpy(vadd_args["B"]).to(dev)
    c = torch.empty_like(a)
    vadd_lib_ms = time_ms(lambda: torch.add(a, b, out=c), 20)
    # the library calls' device time alone, as for the library kernels
    attn_lib_dev_ms = sum(profile_launch(lambda: sdpa(
        q, kk, vv, scale=float(attn_args["scale"]))).values()) or None
    vadd_lib_dev_ms = sum(profile_launch(
        lambda: torch.add(a, b, out=c)).values()) or None

    attn_bytes = 4 * (attn_args["Q"].size + attn_args["K"].size
                      + attn_args["V"].size + attn_args["O"].size)
    attn_ops = 4 * ATTN_H * S * ATTN_D          # q.k and p.v multiply-adds
    attn_bound_ms = max(attn_bytes / HBM_BYTES_PER_S,
                        attn_ops / F32_OPS_PER_S) * 1e3
    vadd_bytes = 4 * 3 * VADD_N
    vadd_bound_ms = max(vadd_bytes / HBM_BYTES_PER_S,
                        VADD_N / F32_OPS_PER_S) * 1e3
    print(f"# attn_decode step: {attn_ms:.4f} ms (plain {attn_plain_ms:.4f} "
          f"ms, SDPA fp32 {attn_lib_ms:.4f} ms (device {attn_lib_dev_ms} "
          f"ms), bound {attn_bound_ms:.4f} ms "
          f"= {attn_bytes} B / 3.35 TB/s) on {smi}")
    print(f"# attn_decode step: {attn_nk} segment kernels take "
          f"{attn_dev_ms:.4f} ms of device time; the rest is host work")
    # the two tile kernels (one launch per kv tile each) against the rest
    tiles = sorted(attn_per.items(), key=lambda kv: -kv[1][1])[:2]
    for (seg, mode), (ms, n) in sorted(tiles):
        print(f"#   segment {seg} ({mode}): {n} launches, {ms:.4f} ms")
    rest = attn_dev_ms - sum(ms for _, (ms, _) in tiles)
    print(f"#   the other {attn_nk - sum(n for _, (_, n) in tiles)} "
          f"launches: {rest:.4f} ms")
    print(f"# vadd 2^24: {vadd_ms:.4f} ms (plain {vadd_plain_ms:.4f} ms, "
          f"torch.add {vadd_lib_ms:.4f} ms (device {vadd_lib_dev_ms} ms), "
          f"bound {vadd_bound_ms:.4f} ms "
          f"= {vadd_bytes} B / 3.35 TB/s) on {smi}")
    print(f"# vadd 2^24: {vadd_nk} segment kernel takes {vadd_dev_ms:.4f} ms "
          "of device time")
    print_profile("attn_decode step", profile_launch(attn_go), attn_ms)
    print_profile("vadd 2^24", profile_launch(vadd_go), vadd_ms)
    src = "src/repro_torch/core/backends/cuda_backend.py"
    kernels = [
        {"name": "hetir_segment_scalar", "route": "cuda", "source": src,
         "replaces": "src/repro/core/backends/pallas_backend.py:120",
         "launches": launches["scalar"],
         "staged_launches": launches["staged"],
         "tree_fold_launches": launches["tree_fold"],
         "max_abs_err": attn_err,
         "ms": attn_dev_ms, "launch_ms": attn_ms,
         "plain_ms": attn_plain_ms,
         "bound_ms": attn_bound_ms, "bound_by": "bytes",
         "library_ms": attn_lib_ms, "library_device_ms": attn_lib_dev_ms},
        {"name": "hetir_segment_block", "route": "cuda", "source": src,
         "replaces": "src/repro/core/backends/pallas_backend.py:263",
         "launches": launches["block"], "max_abs_err": vadd_err,
         "ms": vadd_dev_ms, "launch_ms": vadd_ms,
         "plain_ms": vadd_plain_ms,
         "bound_ms": vadd_bound_ms, "bound_by": "bytes",
         "library_ms": vadd_lib_ms, "library_device_ms": vadd_lib_dev_ms},
    ]
    # the kernel library at phase 5's shapes: the first case of each kernel
    # goes into the kernels line
    for c in cases:
        ms = time_ms(c.fwd, 10)
        plain_ms = time_ms(c.plain, 3)
        # rglru_scan and mlstm_chunk: no single PyTorch call computes a
        # linear recurrence or chunked gated linear attention, so null
        lib_ms = time_ms(c.library, 10) if c.library is not None else None
        # the device alone (the profiler's kernel times of one warm call):
        # a call's event time also holds the host's work before the launch
        # when the device is idle
        by_name = profile_launch(c.fwd)
        dev_ms = sum(by_name.values()) or None
        lib_dev_ms = sum(profile_launch(c.library).values()) or None \
            if c.library is not None else None
        bound_ms, bound_by = c.bound()
        if len(by_name) > 1:   # a call of several kernels: each one's share
            for name, kms in sorted(by_name.items(), key=lambda kv: -kv[1]):
                print(f"#   {kms:.4f} ms device  {name[:90]}")
        if getattr(c, "executed", None):
            print(f"# {c.label}: the kernels execute {c.executed:.6g} "
                  f"operations, {c.executed / c.ops:.4f} of the bound's "
                  f"{c.ops:.6g}")
        lib_txt = "none" if lib_ms is None else \
            f"{lib_ms:.4f} ms (device {lib_dev_ms} ms)"
        print(f"# {c.label}: kernel {ms:.4f} ms (device {dev_ms} ms), plain "
              f"{plain_ms:.4f} ms, library call {lib_txt}, bound "
              f"{bound_ms:.4f} ms by {bound_by} ({c.nbytes} B, {c.ops:.6g} "
              f"operations) on {smi}")
        if c.ops_rate == F32_OPS_PER_S and bound_by == "operations":
            # the f32 products on the CUDA cores: rate and share of the bound
            dms = dev_ms or ms
            print(f"#   {c.ops / dms / 1e9:.2f} TFLOP/s of f32 in "
                  f"{dms:.4f} ms ({'device' if dev_ms else 'events'}), "
                  f"{bound_ms / dms:.4f} of the f32 bound")
        if any(k["name"] == c.kernel for k in kernels):
            continue
        kernels.append(
            {"name": c.kernel, "route": "cuda",
             "source": "src/repro_torch/csrc/kernels/"
                       f"{KERNEL_SOURCE.get(c.kernel, c.kernel)}.cu",
             "replaces": REPLACES[c.kernel],
             "launches": lib_launches[c.kernel], "max_abs_err": c.err,
             "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": bound_by,
             "library_ms": lib_ms, "library_device_ms": lib_dev_ms})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke.py: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
