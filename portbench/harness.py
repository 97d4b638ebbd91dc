"""What every cell's run shares: the cell's files, the port's configuration
checked against the configuration file, the kernels' build, the run's
record, the per-layer probes, and the run from set-up to the comparison.

A driver (``drivers/<name>.py``) holds ``Driver(ctx)`` with ``setup()``,
``window(seconds) -> Window``, ``profile()`` (a few more steps or calls,
run under the profiler), ``release()`` (frees the program's state) and
``check() -> {number: value}`` (the comparison with the reference, run
after ``release``).  A metric (``metrics/<name>.py``) holds ``value(run)``,
which returns a number or None where it finds nothing to read; a metric
that times a function of the port names it in ``PROBE``
(``"module:attribute"``) and holds ``summarize(args, kwargs)``, which
keeps what ``value`` needs of each call (never the tensors themselves).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

import torch

PB = Path(__file__).resolve().parent
ROOT = PB.parent
#: top-level module names a run may never hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: dict           # configs/<config>.json
    t: dict             # workloads/<cell>.json
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files, and the
    metrics it reports: an end-to-end metric where it lists the cell or
    lists none; a per-layer metric where it lists the cell, or lists none
    and moves an end-to-end metric the cell reports."""
    bench = bench or json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (name in m["workloads"] if "workloads" in m
               else m["moves"] in names)]
    return Cell(name=name, chips=w["chips"],
                cfg=json.loads((ROOT / conf["file"]).read_text()),
                t=json.loads((PB / "workloads" / f"{name}.json").read_text()),
                end_to_end=e2e, per_layer=per)


def describe(pc) -> dict:
    """A port configuration in the configuration file's keys."""
    from repro_torch.configs.base import ATTN, DENSE_FFN, MOE_FFN, SWA
    kinds = {(b.mixer, b.ffn) for b in pc.blocks()}
    if len(kinds) != 1 or kinds - {(ATTN, DENSE_FFN), (SWA, DENSE_FFN),
                                   (ATTN, MOE_FFN)}:
        raise ValueError(f"{pc.name}: blocks {sorted(kinds)} have no "
                         "reference family here")
    if pc.norm != "rmsnorm" or pc.act != "swiglu" \
            or pc.param_dtype != pc.compute_dtype:
        raise ValueError(f"{pc.name}: {pc.norm}/{pc.act}/{pc.param_dtype}"
                         f"/{pc.compute_dtype} has no reference here")
    d = {"hidden_size": pc.d_model, "num_attention_heads": pc.n_heads,
         "num_key_value_heads": pc.n_kv_heads, "head_dim": pc.hd,
         "num_hidden_layers": pc.n_layers, "vocab_size": pc.vocab_size,
         "rope_theta": pc.rope_theta,
         "tie_word_embeddings": pc.tie_embeddings,
         "torch_dtype": pc.param_dtype, "vocab_pad": pc.vocab_pad,
         "hidden_act": "silu"}
    mixer = next(iter(kinds))[0]
    if mixer == SWA:
        d["sliding_window"] = pc.window
    if pc.moe is not None:
        d.update(intermediate_size=pc.moe.d_ff_expert,
                 num_local_experts=pc.moe.n_experts,
                 num_experts_per_tok=pc.moe.top_k,
                 capacity_factor=pc.moe.capacity_factor)
    else:
        d["intermediate_size"] = pc.d_ff
    return d


def file_attention(c, pc):
    """``pc`` with the attention the configuration file states: a port
    configuration with a sliding window runs as full causal attention
    where the file states no ``sliding_window``."""
    from repro_torch.configs.base import ATTN, SWA
    if c.get("sliding_window") is not None or pc.window is None:
        return pc
    groups = tuple((n, tuple(dataclasses.replace(b, mixer=ATTN)
                             if b.mixer == SWA else b for b in body))
                   for n, body in pc.layer_groups)
    return dataclasses.replace(pc, layer_groups=groups, window=None,
                               subquadratic=False)


def port_config(c):
    """The port's configuration that ``c`` (a configuration file) names,
    in its profile, with the file's attention (:func:`file_attention`);
    refused where a size differs from the file."""
    from repro_torch import configs
    if c["port_profile"] != "optimized":
        raise ValueError(f"profile {c['port_profile']!r}: only 'optimized'")
    pc = file_attention(c, configs.get_optimized_config(c["port_arch"]))
    check_config(c, pc)
    return pc


def check_config(c, pc) -> None:
    got = describe(pc)
    bad = {k: (c.get(k), v) for k, v in got.items() if c.get(k) != v}
    if bad:
        raise ValueError(f"{pc.name}: the port runs other sizes than the "
                         f"configuration file states (file, port): {bad}")


def build_kernels(device) -> None:
    """Build every kernel library of the port that is missing from its
    cache in the checkout (``build/repro_torch/``); a no-op off the card."""
    if torch.device(device).type != "cuda":
        return
    from repro_torch.core.backends import nvcc_build
    from repro_torch.kernels import _cuda
    nvcc_build.build([nvcc_build.kernel_job(n) for n in _cuda.SOURCES])


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Window:
    """The measured window: host-clock start (the first step's or
    request's) and end (the last one's synchronized end), and one item
    per step or request."""
    start: float
    end: float
    items: List[dict]

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Ctx:
    cell: Cell
    seed: int
    device: torch.device
    port_cfg: object

    @property
    def cfg(self) -> dict:
        return self.cell.cfg

    @property
    def t(self) -> dict:
        return self.cell.t


@dataclasses.dataclass
class Run:
    """What a metric reads: the cell, its window, the set-up's seconds, the
    probes' calls (``(seconds, summary)`` by the ``PROBE`` they time) and the profiled
    sub-window (:func:`portbench.trace.profile`), where traced."""
    cell: Cell
    window: Window
    setup_s: float
    probes: Dict[str, list]
    profile: Optional[dict]


def load_module(kind: str, name: str) -> ModuleType:
    """``portbench/<kind>/<name>.py`` (names may hold dots)."""
    path = PB / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Probe:
    """Times each call of the port's ``module:attribute`` with CUDA events
    while installed."""

    def __init__(self, target: str, summarize):
        mod, self.attr = target.split(":")
        self.module = importlib.import_module(mod)
        self.orig = getattr(self.module, self.attr)
        self.calls: list = []

        def timed(*args, **kwargs):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = self.orig(*args, **kwargs)
            e.record()
            self.calls.append((s, e, summarize(args, kwargs)))
            return out
        setattr(self.module, self.attr, timed)

    def close(self) -> list:
        """Uninstall; the calls as ``(seconds, summary)``."""
        setattr(self.module, self.attr, self.orig)
        return [(s.elapsed_time(e) / 1e3, summary)
                for s, e, summary in self.calls]


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device,
            process_start: float, port_cfg=None) -> dict:
    """One run of ``cell``: set-up, the window (with the traced metrics'
    probes where ``trace``), the profiled sub-window where ``trace``, the
    metrics, the peak, and the comparison with the reference.  Returns the
    result's fields."""
    from . import trace as tracing
    device = torch.device(device)
    pc = port_cfg if port_cfg is not None else port_config(cell.cfg)
    ctx = Ctx(cell, seed, device, pc)
    drv = load_module("drivers", cell.t["driver"]).Driver(ctx)
    entries = cell.per_layer if trace else cell.end_to_end
    mods = {m["name"]: load_module("metrics", m["name"]) for m in entries}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    drv.setup()
    print(f"# set-up done {time.perf_counter() - process_start:.3f} s after "
          "the process started", file=sys.stderr)
    probes = {}
    for m in mods.values():
        if trace and hasattr(m, "PROBE") and m.PROBE not in probes:
            probes[m.PROBE] = Probe(m.PROBE, m.summarize)
    win = drv.window(seconds)
    calls = {n: p.close() for n, p in reversed(list(probes.items()))}
    prof = tracing.profile(drv.profile, device) if trace else None
    run = Run(cell, win, win.start - process_start, calls, prof)
    metrics = {}
    for m in entries:
        v = mods[m["name"]].value(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    drv.release()
    t_check = time.perf_counter()
    numbers = drv.check()
    print(f"# check took {time.perf_counter() - t_check:.3f} s; numbers "
          f"{json.dumps(numbers)}", file=sys.stderr)
    limits = cell.t["check"]["limits"]
    checks = {k: {"value": float(numbers[k]), "limit": float(limits[k])}
              for k in limits}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else device.type,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if prof is not None:
        dev.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
    out = {"correct": all(v["value"] <= v["limit"] for v in checks.values()),
           "attempted": len(win.items), "failed": 0, "metrics": metrics,
           "device": dev}
    if prof is not None:
        out["breakdown"] = {"device_ops": prof["device_ops"],
                            "idle_gaps": prof["idle_gaps"]}
    out["checks"] = checks
    return out
