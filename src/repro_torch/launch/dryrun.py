"""The production dry run: one rank of each arch x shape x production mesh,
traced without data, with its per-device FLOPs, bytes, collective bytes,
state bytes, peak live bytes and roofline terms.

Port of ``src/repro/launch/dryrun.py``.  Where the reference lowers and
compiles each cell for 256 or 512 host devices, the port traces one rank:
the process is rank 0 of a fake process group of 256 or 512 ranks
(``torch.testing._internal.distributed.fake_pg``: collectives return at
once and move nothing), the mesh is :func:`make_production_mesh` over it
on ``device_type="cpu"``, and every tensor lies on ``meta`` (a shape and
a type; nothing is allocated and nothing computes).  The model's
parameters, and for a train cell AdamW's moments, are ``DTensor``s placed
by :class:`~repro_torch.parallel.MeshRules`; the inputs are the
registry's abstract ones; the step of :mod:`repro_torch.parallel.steps`
runs once under :class:`~repro_torch.launch.hlo_analysis.OpCounter`: the
train step with its ``grad_accum`` microbatches and the optimizer update,
the prefill, or one serve step at the cache's last position.  On ``meta``
the kernels' wrappers take their oracles, the plain math (the reference's
dry run counts its plain ``jnp`` model, not Pallas).

Each cell's JSON is the reference's dict where a key means something
here: ``hlo_flops``, ``hlo_bytes`` and ``collective_bytes`` are the
counter's (per device; eager bytes, an upper bound on XLA's fused
bytes); ``t_trace_s`` stands for ``t_lower_s`` and ``t_compile_s``;
``state_bytes_per_device`` is the reference's analytic formula over the
port's specs and ``state_bytes_local`` the same state read from the
``DTensor``s' local blocks (they are equal); ``peak_bytes_per_device``,
in place of XLA's ``memory_analysis``, is the peak of the live tensor
storages on the rank during the step, the state included.  The roofline
seconds divide those counts by the H100's datasheet rates
(:mod:`repro_torch.launch.mesh`), not by anything measured.

Run ``python -m repro_torch.launch.dryrun`` (all cells, both meshes; one
child process per mesh size, since a process's world size is fixed) or
``--arch/--shape/--mesh`` for fewer; each cell writes
``<out>/<arch>__<shape>__<mesh>__<tag>.json`` (default ``build/dryrun``),
and a cell whose file exists is skipped.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional

import torch
from torch.distributed.tensor import DTensor

from .. import configs
from ..configs.base import SHAPES, default_parallel, shape_applicable
from ..models import Model
from ..models import registry as R
from ..parallel import (MeshExecutor, MeshRules, make_prefill_step,
                        make_serve_step, make_train_step)
from ..parallel.sharding import distribute
from . import hlo_analysis
from .mesh import (HBM_BW, HBM_BYTES, ICI_BW, PEAK_FLOPS_BF16,
                   PRODUCTION_SHAPES, make_production_mesh)

ART_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
MESH_NAMES = {False: "16x16", True: "2x16x16"}
#: where the roofline's rates come from
CONSTANTS = ("NVIDIA H100 SXM5 80 GB datasheet: dense bf16 "
             f"{PEAK_FLOPS_BF16:.4g} FLOP/s, HBM3 {HBM_BW:.4g} B/s, NVLink "
             f"{ICI_BW:.4g} B/s; not measured")


def spec_divisor(spec, axis_size: Dict[str, int]) -> int:
    """The number of blocks a spec cuts a tensor into."""
    n = 1
    for entry in spec:
        for a in (entry,) if isinstance(entry, str) else (entry or ()):
            n *= axis_size[a]
    return n


def analytic_bytes_per_device(tensors, specs, axis_size) -> float:
    """Sum of the tensors' bytes, each divided by its spec's axis product
    (the reference's ``_analytic_bytes_per_device``); ``tensors`` and
    ``specs`` are keyed or listed alike."""
    keys = tensors.keys() if isinstance(tensors, dict) else \
        range(len(tensors))
    return float(sum(tensors[k].numel() * tensors[k].element_size()
                     / spec_divisor(specs[k], axis_size) for k in keys))


def local_bytes(tensors) -> float:
    """Bytes this rank holds of ``tensors`` (a ``DTensor`` by its local
    block)."""
    vals = tensors.values() if isinstance(tensors, dict) else tensors
    return float(sum((t.to_local() if isinstance(t, DTensor) else t)
                     .untyped_storage().nbytes() for t in vals))


def _flat_caches(caches):
    """{(layer, name): tensor} of a list of per-layer cache dicts."""
    return {(i, n): t for i, c in enumerate(caches) for n, t in c.items()}


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               pcfg_override=None, cfg_overrides=None, *, mesh=None,
               smoke: bool = False, split: bool = True):
    """Trace one (arch x shape x mesh) cell on this rank; returns its
    metrics.  ``shape_name``: a name of ``SHAPES`` or a ``ShapeCfg``;
    ``mesh``: a ``DeviceMesh`` or a device (default: the
    production mesh over the default process group, which must have its
    world); ``smoke``: the arch's smoke config; ``split``: whether the
    compute is split over ``model`` (off: PR 22's executor, each rank
    computing whole layers)."""
    cfg = configs.get_smoke_config(arch) if smoke else configs.get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"status": "skipped", "reason": why}
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    pcfg = pcfg_override or default_parallel(cfg, shape)
    rules = MeshRules(cfg, pcfg, mesh)
    sharded = rules.sharded
    n_chips = mesh.size() if sharded else 1

    model = Model(cfg, device="meta")
    ex = MeshExecutor(rules, split=split) if sharded else None
    if ex is not None:
        ex.shard_model(model)
    params = dict(model.named_parameters())
    pspecs = rules.named_param_specs()
    axes = rules.axis_size
    state = {"params": params}
    state_bytes = analytic_bytes_per_device(params, pspecs, axes)
    counter = hlo_analysis.OpCounter(n_chips)

    if shape.kind == "train":
        odt = getattr(torch, cfg.opt_state_dtype)
        moments = {k: {n: ex.zeros_like(p, odt) if ex else
                       torch.zeros(p.shape, dtype=odt, device="meta")
                       for n, p in params.items()} for k in ("m", "v")}
        opt = dict(moments, count=torch.zeros((), dtype=torch.int32,
                                              device="meta"))
        state.update(moments)
        batch = R.train_input_specs(cfg, shape)
        step_fn = make_train_step(cfg, pcfg, rules)
        run = lambda: step_fn(model, opt, batch, 0)  # noqa: E731
        state_bytes += 2 * analytic_bytes_per_device(moments["m"], pspecs,
                                                     axes)
    elif shape.kind == "prefill":
        batch = R.train_input_specs(cfg, shape)
        step_fn = make_prefill_step(cfg, rules)
        run = lambda: step_fn(model, batch)  # noqa: E731
    else:  # decode: one token at the cache's last position
        tokens, caches, _ = R.decode_input_specs(cfg, shape)
        cspecs = _flat_caches(rules.cache_specs(caches))
        flat = _flat_caches(caches)
        state_bytes += analytic_bytes_per_device(flat, cspecs, axes)
        if ex is not None:
            caches = [{n: distribute(t, mesh, cspecs[(i, n)])
                       for n, t in c.items()} for i, c in enumerate(caches)]
        state["caches"] = _flat_caches(caches)
        step_fn = make_serve_step(cfg, rules)
        pos = shape.seq_len - 1
        run = lambda: step_fn(model, tokens, caches, pos)  # noqa: E731
        batch = {"tokens": tokens}
    state_local = sum(local_bytes(v) for v in state.values())

    counter.track((state, batch))
    t0 = time.time()
    with counter:
        run()
    t_trace = time.time() - t0
    res = counter.result()
    flops, nbytes = res["flops"], res["bytes"]
    coll = res["collectives"]

    N = R.active_param_count(cfg)
    if shape.kind == "decode":
        model_flops = 2.0 * N * shape.global_batch
    else:
        tokens_ = shape.seq_len * shape.global_batch
        model_flops = (6.0 if shape.kind == "train" else 2.0) * N * tokens_
    return {
        "status": "ok",
        "arch": arch, "shape": shape.name,
        "mesh": MESH_NAMES[multi_pod] if sharded else "1x1",
        "n_chips": n_chips,
        "split": bool(split and sharded),
        "t_trace_s": round(t_trace, 2),
        "n_ops": counter.n_ops,
        "hlo_flops": flops,                 # per device, every op counted
        "hlo_bytes": nbytes,                # per device, eager (unfused)
        "collective_bytes": coll,           # per device, ring model
        "model_flops": model_flops,         # whole job, 6·N·D or 2·N·D
        "params_total": R.param_count(cfg),
        "params_active": N,
        "state_bytes_per_device": state_bytes,
        "state_bytes_local": state_local,
        "peak_bytes_per_device": counter.peak_bytes,
        "hbm_bytes": HBM_BYTES,
        "roofline": {
            "compute_s": flops / PEAK_FLOPS_BF16 if flops > 0 else None,
            "memory_s": nbytes / HBM_BW if nbytes > 0 else None,
            "collective_s": coll.get("total", 0.0) / ICI_BW,
            "constants": CONSTANTS,
        },
        "parallel": {
            "grad_accum": pcfg.grad_accum, "seq_shard": pcfg.seq_shard,
            "kv_shard": pcfg.kv_shard, "remat": pcfg.remat,
        },
    }


def init_fake_world(multi_pod: bool, rank: int = 0) -> None:
    """Join a fake process group of the production mesh's size (256 or
    512 ranks) as ``rank``; nothing is sent anywhere."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = math.prod(PRODUCTION_SHAPES[multi_pod][0])
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def _parse(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return {"true": True, "false": False}.get(v.lower(), v)


def _sweep(args, multi_pod: bool) -> int:
    """Every requested cell on one mesh size, in this process."""
    init_fake_world(multi_pod)
    cfg_over = {k: _parse(v) for k, v in
                (kv.split("=", 1) for kv in args.set)} or None
    pcfg_over = {k: _parse(v) for k, v in
                 (kv.split("=", 1) for kv in args.pset)}
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = [args.arch] if args.arch else configs.list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    failures = 0
    for arch in archs:
        for shape in shapes:
            cell = f"{arch}__{shape}__{MESH_NAMES[multi_pod]}"
            fpath = out_dir / f"{cell}__{args.tag}.json"
            if fpath.exists():
                print(f"[skip-cached] {cell}")
                continue
            print(f"[trace] {cell} ...", flush=True)
            t0 = time.time()
            try:
                pov = None
                if pcfg_over:
                    base = default_parallel(configs.get_config(arch),
                                            SHAPES[shape])
                    pov = dataclasses.replace(base, **pcfg_over)
                res = lower_cell(arch, shape, multi_pod, pcfg_override=pov,
                                 cfg_overrides=cfg_over,
                                 split=not args.no_split)
            except Exception as e:  # noqa: BLE001 - recorded per cell
                res = {"status": "error", "error": str(e),
                       "trace": traceback.format_exc()}
                failures += 1
                print(f"  ERROR: {e}")
            res["tag"] = args.tag
            fpath.write_text(json.dumps(res, indent=1))
            print(f"  -> {res['status']} in {time.time() - t0:.1f}s",
                  flush=True)
    print(f"done; {failures} failures")
    return 1 if failures else 0


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="single arch (default: all)")
    ap.add_argument("--shape", default=None,
                    help="single shape (default: all)")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default=str(ART_DIR))
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--set", action="append", default=[],
                    help="cfg override key=value")
    ap.add_argument("--pset", action="append", default=[],
                    help="ParallelCfg override key=value")
    ap.add_argument("--no-split", action="store_true",
                    help="each rank computes whole layers (no split over "
                         "model)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process of its own")
    args = ap.parse_args(argv)
    if args.mesh != "both" and args.jobs == 1:
        return _sweep(args, args.mesh == "multi")
    # a process's world size is fixed: a child for each mesh size (or,
    # with --jobs, for each cell)
    argv = _without(list(sys.argv[1:] if argv is None else argv),
                    ("--mesh", "--arch", "--shape", "--jobs"))
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.jobs == 1:
        children = [["--mesh", m] + (["--arch", args.arch] if args.arch
                                     else []) +
                    (["--shape", args.shape] if args.shape else [])
                    for m in meshes]
    else:
        archs = [args.arch] if args.arch else configs.list_archs()
        shapes = [args.shape] if args.shape else list(SHAPES)
        children = [["--mesh", m, "--arch", a, "--shape", s]
                    for m in meshes for a in archs for s in shapes]

    def run(child):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
               *child]
        return subprocess.run(cmd, env=os.environ.copy()).returncode

    with ThreadPoolExecutor(max(args.jobs, 1)) as pool:
        return int(any(list(pool.map(run, children))))


def _without(argv, options):
    """``argv`` without the ``options`` (each with its value)."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        if a in options:
            skip = True
            continue
        if a.split("=", 1)[0] in options:
            continue
        out.append(a)
    return out


if __name__ == "__main__":
    raise SystemExit(main())
