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
   per optimized program, all running concurrently);
1. all 17 suite and 4 zoo kernels at their canonical launch, at O0 and
   OPT_MAX: bits equal to the plain version on the card and to the NumPy
   interpreter on the CPU (NaN compared as NaN), within 1e-5 of the suite
   oracles and bit-equal to the zoo oracles; ``block_stats`` equal to the
   verdicts pinned below (checked against the JAX reference by the CPU
   tests); then the one-op edge-grid programs of
   ``repro_torch.core.edge_grids`` (DIV/MOD/shifts/casts/MIN/MAX on edge
   values, folds of ``-0.0``, folds and votes under divergence, atomic and
   store order), bits equal to the plain version and the interpreter;
2. full width, scalar path: one ``attn_decode`` step at Llama 3.2 3B's 24
   query heads of width 128 over a 4096-token window (K and V 48 MiB each),
   bits equal to the zoo oracle and to the plain version; then a second
   launch paused after 3 segments, checkpointed, restored in a CPU
   ``vectorized`` session, advanced 2 segments there, migrated back to the
   card and finished — bits unchanged;
3. full width, block path: ``vadd`` over 2^24 elements;
4. times: one launch of 2 and of 3 (median over warm launches, CUDA
   events), the device time of its segment kernels alone, their plain
   versions, one PyTorch call computing the same function as a yardstick,
   and each kernel's bound; then one launch of each under
   ``torch.profiler``, with the device time of every kernel it ran (the
   segment kernels and the engine's copies) and the device's busy share.

In the ``kernels`` line, ``ms`` is the device time of the segment kernels
of one launch, ``launch_ms`` the latency of the whole launch (host work
and the engine's copies included), ``plain_ms`` the same launch through the
plain version on the card.

The launch counts of the kernels are reset before phases 2-3 and read after
them.  Any mismatch or launch error ends the run with a non-zero code.  The
last line is ``{"ok": true, "device": {...}}``.
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
    launch call — and their number.  The rest of a launch's time is host
    work the device waits for."""
    import torch
    events = []
    wrapped = []

    def timing(fn):
        def timed(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            err = fn(*args)
            end.record()
            events.append((start, end))
            return err
        return timed

    for mod in backend._modules.values():
        for key, fn in list(mod.fns.items()):
            wrapped.append((mod, key, fn))
            mod.fns[key] = timing(fn)
    try:
        go()
    finally:
        for mod, key, fn in wrapped:
            mod.fns[key] = fn
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events), len(events)


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


def check_edge_grids(dev) -> int:
    """Every edge-grid program through ``HetSession("cuda")`` on ``dev``,
    bits equal to the plain version on ``dev`` and to the interpreter on
    the CPU (NaN as NaN); returns the number of programs."""
    from repro_torch.core import HetSession, TranslationCache
    from repro_torch.core import edge_grids
    cases = list(edge_grids.all_cases())
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
    from repro_torch.core.backends import get_backend

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
    built = builder.prebuild(optimized)
    print(f"# nvcc: {built['built']} libraries built for "
          f"{len(optimized)} optimized programs in {built['seconds']:.1f} s "
          "(concurrent, one nvcc per program)")

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

    # -- phases 2-3: the main path at full width -------------------------------
    attn_want = attn_oracle(dict(attn_args))["O"]
    vadd_want = vadd_args["A"] + vadd_args["B"]
    gpu = HetSession("cuda", device=dev)
    vgpu = HetSession("cuda", device=dev)
    main_backends = (gpu.backend, vgpu.backend)
    for b in main_backends:
        b.launches.update(scalar=0, block=0)

    rec, out = run_launch(gpu, attn_prog, ATTN_H, ATTN_T, attn_args, ("O",))
    torch.cuda.synchronize()
    check(same_bits(out["O"], attn_want),
          "attn_decode full width: kernel != zoo oracle bits")
    step_launches = dict(gpu.backend.launches)
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
    launches = {k: sum(b.launches[k] for b in main_backends)
                for k in ("scalar", "block")}
    check(launches["scalar"] > 0 and launches["block"] > 0,
          f"main path missed a kernel: launches {launches}")
    print("phase 2: attn_decode H=24 D=128 window 4096: bits equal to the "
          "oracle; cuda -> CPU eager -> cuda migration bit-identical")
    print("phase 3: vadd 2^24: bits equal to the oracle")
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
    attn_dev_ms, attn_nk = kernel_device_ms(gpu.backend, attn_go)
    attn_plain_ms = time_ms(launcher(plain, attn_prog, ATTN_H, ATTN_T,
                                     attn_args), 2)
    vadd_go = launcher(vgpu, vadd_prog, VADD_N // VADD_BLOCK, VADD_BLOCK,
                       vadd_args)
    vadd_ms = time_ms(vadd_go, 20)
    vadd_dev_ms, vadd_nk = kernel_device_ms(vgpu.backend, vadd_go)
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

    attn_bytes = 4 * (attn_args["Q"].size + attn_args["K"].size
                      + attn_args["V"].size + attn_args["O"].size)
    attn_ops = 4 * ATTN_H * S * ATTN_D          # q.k and p.v multiply-adds
    attn_bound_ms = max(attn_bytes / HBM_BYTES_PER_S,
                        attn_ops / F32_OPS_PER_S) * 1e3
    vadd_bytes = 4 * 3 * VADD_N
    vadd_bound_ms = max(vadd_bytes / HBM_BYTES_PER_S,
                        VADD_N / F32_OPS_PER_S) * 1e3
    print(f"# attn_decode step: {attn_ms:.4f} ms (plain {attn_plain_ms:.4f} "
          f"ms, SDPA fp32 {attn_lib_ms:.4f} ms, bound {attn_bound_ms:.4f} ms "
          f"= {attn_bytes} B / 3.35 TB/s) on {smi}")
    print(f"# attn_decode step: {attn_nk} segment kernels take "
          f"{attn_dev_ms:.4f} ms of device time; the rest is host work")
    print(f"# vadd 2^24: {vadd_ms:.4f} ms (plain {vadd_plain_ms:.4f} ms, "
          f"torch.add {vadd_lib_ms:.4f} ms, bound {vadd_bound_ms:.4f} ms "
          f"= {vadd_bytes} B / 3.35 TB/s) on {smi}")
    print(f"# vadd 2^24: {vadd_nk} segment kernel takes {vadd_dev_ms:.4f} ms "
          "of device time")
    print_profile("attn_decode step", profile_launch(attn_go), attn_ms)
    print_profile("vadd 2^24", profile_launch(vadd_go), vadd_ms)
    src = "src/repro_torch/core/backends/cuda_backend.py"
    kernels = [
        {"name": "hetir_segment_scalar", "route": "cuda", "source": src,
         "replaces": "src/repro/core/backends/pallas_backend.py:120",
         "launches": launches["scalar"], "max_abs_err": attn_err,
         "ms": attn_dev_ms, "launch_ms": attn_ms,
         "plain_ms": attn_plain_ms,
         "bound_ms": attn_bound_ms, "bound_by": "bytes",
         "library_ms": attn_lib_ms},
        {"name": "hetir_segment_block", "route": "cuda", "source": src,
         "replaces": "src/repro/core/backends/pallas_backend.py:263",
         "launches": launches["block"], "max_abs_err": vadd_err,
         "ms": vadd_dev_ms, "launch_ms": vadd_ms,
         "plain_ms": vadd_plain_ms,
         "bound_ms": vadd_bound_ms, "bound_by": "bytes",
         "library_ms": vadd_lib_ms},
    ]
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
