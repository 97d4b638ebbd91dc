"""The ranks of ``tests/test_torch_parallel_mesh.py``: four ``gloo``
processes on the CPU over a ``FileStore``, one process group for every
check.  Each rank runs the port's mesh layer against its one-device path
(computed in every rank from the same seeds) and writes what it found to
``<dir>/rank<r>.json``; the test reads the files.  No JAX here: the spawn
stays cheap.
"""
from __future__ import annotations

import dataclasses
import datetime
import hashlib
import json
import math
import os
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import configs
from repro_torch.checkpoint import restore
from repro_torch.configs.base import ParallelCfg, ShapeCfg, default_parallel
from repro_torch.launch import serve
from repro_torch.launch import train as train_launcher
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import Model, layers
from repro_torch.parallel import (MeshExecutor, MeshRules, make_prefill_step,
                                  make_serve_step, pipeline_apply)
from repro_torch.launch import dryrun
from repro_torch.launch.hlo_analysis import OpCounter
from repro_torch.parallel.sharding import local_chunk, mesh_axes
from repro_torch.parallel.split import ModelSplit
from repro_torch.runtime import Trainer

WORLD = 4
SHAPE = ShapeCfg("tiny", 32, 4, "train")
#: (a): the meshes, and (2, 2) again with the sequence split over model
#: and with two microbatches
MESH_CASES = (((2, 2), {}), ((4, 1), {}), ((1, 4), {}),
              ((2, 2), {"seq_shard": True}), ((2, 2), {"grad_accum": 2}))
STEPS = 2
#: (a)'s planted fault: a gradient reduction that keeps each rank's own
#: rows' partial gradient, on this model and mesh
PLANTED = ("llama3.2-3b", (2, 2))
#: the reference test's GPipe sizes (tests/test_pipeline.py)
PIPE_S, PIPE_M, PIPE_D = 4, 6, 16
#: (g): the split's train steps beyond (a)'s: the RG-LRU's channels and
#: SWA, and whisper's encoder and cross-attention
SPLIT_STEPS = (("recurrentgemma-2b", (2, 2), {}),
               ("recurrentgemma-2b", (1, 4), {}),
               ("recurrentgemma-2b", (2, 2), {"seq_shard": True}),
               ("whisper-large-v3", (2, 2), {}),
               ("whisper-large-v3", (1, 4), {}))
#: (g)'s planted faults on llama3.2-3b, (2, 2): a row-parallel product's
#: partial sums never added, and under SP the reduce-scatter replaced by a
#: slice of this rank's own partial sums
SPLIT_FAULTS = (("no_sum", {}), ("sp_slice", {"seq_shard": True}))
#: (h): greedy decoding on a split mesh (arch, mesh, kv_shard); the
#: caches' lengths, which the split divides (slots split by "seq")
SPLIT_SERVING = (("llama3.2-3b", (1, 4), "heads"),
                 ("llama3.2-3b", (2, 2), "seq"),
                 ("granite-moe-3b-a800m", (1, 4), "seq"),
                 ("recurrentgemma-2b", (2, 2), "seq"),
                 ("whisper-large-v3", (1, 4), "heads"),
                 ("whisper-large-v3", (2, 2), "seq"))
PROMPT, DECODE_STEPS, CACHE_LENS = 16, 3, (20, 40)
#: (i): granite with 5 experts, which a ``model`` of 2 does not divide
#: (expert-TP: the reference splits the capacity over ``data``) and one of
#: 1 does (EP over a ``model`` of one rank: the capacity stays whole)
MOE5 = {"n_experts": 5}
#: (i)'s MoE steps: (moe_impl, mesh, pcfg overrides)
MOE_STEPS = (("global", (2, 2), {}), ("global", (4, 1), {}),
             ("global", (2, 2), {"grad_accum": 2}),
             ("grouped", (2, 2), {}), ("grouped", (4, 1), {}))
#: (i)'s xlstm-125m steps and decoding on (1, 4): its 4 heads (a head a
#: rank), and 2 heads (each on 2 ranks: the mLSTM's value columns halved,
#: the sLSTM repeated); the decode's caches split by heads and by "seq"
XLSTM_CASES = (({}, "heads"), ({"n_heads": 2}, "seq"))


def _pcfg(**kw) -> ParallelCfg:
    return ParallelCfg(**dict(dict(grad_accum=1, remat=True,
                                   seq_shard=False), **kw))


def _local_shape(shape, spec, axes):
    """A tensor's block shape on each rank under ``spec``."""
    out = []
    for d, entry in zip(shape, spec):
        names = (entry,) if isinstance(entry, str) else (entry or ())
        out.append(d // math.prod(axes[a] for a in names))
    return list(out)


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().view(torch.uint8)
                          .numpy().tobytes()).hexdigest()


def _state_report(tr: Trainer) -> dict:
    """Every tensor of the trainer's state: whether its block has the
    shape its spec gives, and whether the ranks holding the same block
    hold the same bits (every replicated leaf)."""
    axes = mesh_axes(tr.mesh)
    coord = tr.mesh.get_coordinate()
    bad_shape, bad_bits, n_rep = [], [], 0
    tensors = dict(tr.model.named_parameters())
    tensors.update({f"m.{n}": t for n, t in tr.opt["m"].items()})
    tensors.update({f"v.{n}": t for n, t in tr.opt["v"].items()})
    for name, t in tensors.items():
        spec = tr.executor.specs[name.split(".", 1)[1]
                                 if name[:2] in ("m.", "v.") else name]
        if list(t.to_local().shape) != _local_shape(t.shape, spec, axes):
            bad_shape.append(name)
        # the block's identity: its coordinates on the sharded mesh dims
        key = tuple(coord[i] for i, p in enumerate(t.placements)
                    if isinstance(p, Shard))
        everyone = [None] * WORLD
        dist.all_gather_object(everyone, (key, _digest(t.to_local())))
        if any(not isinstance(p, Shard) for p in t.placements):
            n_rep += 1
            by_key = {}
            for k, h in everyone:
                by_key.setdefault(k, set()).add(h)
            if any(len(h) > 1 for h in by_key.values()):
                bad_bits.append(name)
    host = tr.host_state()
    host_bytes = sum(t.numel() * t.element_size()
                     for k in ("params", "m", "v") for t in host[k].values())
    shard_bytes = sum(t.to_local().numel() * t.element_size()
                      for t in tensors.values())
    whole_bytes = sum(t.numel() * t.element_size() for t in tensors.values())
    return {"bad_shape": bad_shape, "bad_bits": bad_bits,
            "replicated": n_rep, "tensors": len(tensors),
            "writer": tr.is_writer, "host_bytes": host_bytes,
            "shard_bytes": shard_bytes, "whole_bytes": whole_bytes}


class _Experts:
    """Records the experts every routing picks (``layers.topk``)."""

    def __enter__(self):
        self.picks, self._topk = [], layers.topk

        def topk(logits, K):
            vals, idx = self._topk(logits, K)
            self.picks.append(idx.clone())
            return vals, idx
        layers.topk = topk
        return self

    def __exit__(self, *exc):
        layers.topk = self._topk


def _run(tr: Trainer, steps: int):
    """(losses, gradient norms) of ``steps`` steps of ``tr``."""
    norms, step_fn = [], tr.step_fn

    def recorded(*args):
        out = step_fn(*args)
        norms.append(float(out[2]["grad_norm"]))
        return out
    tr.step_fn = recorded
    try:
        losses = tr.run(steps).losses
    finally:
        tr.step_fn = step_fn
    return losses, norms


def _state_errors(tr: Trainer, got: dict, want: dict) -> dict:
    """For the parameters and each moment (by parameter name; ``got`` is
    ``tr``'s host state: whole on its writing rank, each other rank's
    blocks elsewhere, held against the same blocks of ``want``): the
    largest over the leaves of max|got - want| / max|want|, and its
    leaf."""
    params = dict(tr.model.named_parameters())
    out = {}
    for k in ("params", "m", "v"):
        err, leaf = 0.0, None
        for n, w in want[k].items():
            if not tr.is_writer:
                w = local_chunk(w, tr.mesh, params[n].placements)
            e = float((got[k][n] - w).abs().max()
                      / w.abs().max().clamp(min=1e-30))
            if e > err or leaf is None:
                err, leaf = e, n
        out[k] = [err, leaf]
    return out


def _one_device(cfg, steps, pcfg=None) -> dict:
    """The one-device trainer's ``steps`` steps: losses, gradient norms,
    the experts of every routing, and the state after them."""
    tr = Trainer(cfg, SHAPE, "cpu", pcfg=pcfg or _pcfg(), seed=1)
    tr.init_state()
    with _Experts() as ex:
        losses, norms = _run(tr, steps)
    return dict(losses=losses, norms=norms, picks=ex.picks,
                state=tr.host_state())


def _compared(tr: Trainer, steps: int, want: dict) -> dict:
    """``steps`` steps of the mesh trainer ``tr`` held against the
    one-device run ``want``: losses, gradient norms and the state's
    errors after the steps."""
    with _Experts() as ex:
        losses, norms = _run(tr, steps)
    return dict(losses=losses, want=want["losses"], norms=norms,
                want_norms=want["norms"],
                state_err=_state_errors(tr, tr.host_state(),
                                        want["state"]),
                same_experts=len(ex.picks) == len(want["picks"]) and all(
                    torch.equal(a, b) for a, b in zip(ex.picks,
                                                      want["picks"])),
                n_routings=len(ex.picks))


def _reduce_own_rows(self, g, pl, keep=None):
    """The planted fault: this rank's partial gradient (whole, or its
    block of mesh dim ``keep``'s split) cut to its block, never summed
    over the ranks."""
    return DTensor.from_local(g.contiguous(), self.mesh,
                              [pl[i] if i == keep else Replicate()
                               for i in range(self.mesh.ndim)],
                              run_check=False
                              ).redistribute(self.mesh, list(pl)).to_local()


def check_steps(out: dict) -> None:
    """(a) steps on three mesh shapes (and the sequence split, and two
    microbatches) against the one-device step, for a dense and a MoE
    model; then the planted fault on one of them."""
    one = {}
    for arch in ("llama3.2-3b", "granite-moe-3b-a800m"):
        cfg = configs.get_smoke_config(arch)
        for shape, kw in MESH_CASES:
            key = (arch, tuple(sorted(kw.items())))
            if key not in one:
                one[key] = _one_device(cfg, STEPS, _pcfg(**kw))
            tr = Trainer(cfg, SHAPE, make_test_mesh(shape), pcfg=_pcfg(**kw),
                         seed=1)
            tr.init_state()
            out["steps"].append(dict(arch=arch, mesh=list(shape), kw=kw,
                                     **_compared(tr, STEPS, one[key]),
                                     **_state_report(tr)))
    arch, shape = PLANTED
    tr = Trainer(configs.get_smoke_config(arch), SHAPE, make_test_mesh(shape),
                 pcfg=_pcfg(), seed=1)
    tr.init_state()
    reduce = MeshExecutor.reduce
    MeshExecutor.reduce = _reduce_own_rows
    try:
        out["planted"] = _compared(tr, STEPS, one[(arch, ())])
    finally:
        MeshExecutor.reduce = reduce


def check_split_steps(out: dict) -> None:
    """(g) the split's steps against the one-device step (recurrentgemma
    and whisper), and the planted faults on llama."""
    one = {}
    for arch, shape, kw in SPLIT_STEPS:
        cfg = configs.get_smoke_config(arch)
        if arch not in one:
            one[arch] = _one_device(cfg, STEPS)
        tr = Trainer(cfg, SHAPE, make_test_mesh(shape), pcfg=_pcfg(**kw),
                     seed=1)
        tr.init_state()
        out["split_steps"].append(dict(arch=arch, mesh=list(shape), kw=kw,
                                       **_compared(tr, STEPS, one[arch]),
                                       **_state_report(tr)))
    cfg = configs.get_smoke_config("llama3.2-3b")
    want = _one_device(cfg, STEPS)
    sum_seq = ModelSplit.sum_seq
    planted = {"no_sum": lambda self, t: t,
               "sp_slice": lambda self, t: self.own(t, 1) if self.seq
               else sum_seq(self, t)}
    for name, kw in SPLIT_FAULTS:
        tr = Trainer(cfg, SHAPE, make_test_mesh((2, 2)), pcfg=_pcfg(**kw),
                     seed=1)
        tr.init_state()
        ModelSplit.sum_seq = planted[name]
        try:
            out["split_faults"].append(dict(name=name,
                                            **_compared(tr, STEPS, want)))
        finally:
            ModelSplit.sum_seq = sum_seq


def check_split_serving(out: dict) -> None:
    """(h) prefill and greedy decode steps on a split mesh against one
    device: the greedy tokens (each rank's rows), the f32 logits, each
    rank's cache bytes between steps against its split of the whole, and
    one decode step's collective bytes at two cache lengths."""
    for arch, shape, kv in SPLIT_SERVING:
        out["split_serving"].append(_split_decode(
            configs.get_smoke_config(arch), shape, kv, CACHE_LENS))


def _split_decode(cfg, shape, kv: str, cache_lens) -> dict:
    """(h)'s prefill and decode steps of ``cfg`` on a mesh of ``shape``
    with caches split by ``kv``, at each of ``cache_lens``."""
    rules = MeshRules(cfg, _pcfg(kv_shard=kv), make_test_mesh(shape))
    model = Model(cfg, generator=torch.Generator().manual_seed(3),
                  device="cpu")
    batch = serve.make_batch(cfg, 4, PROMPT, 0, torch.device("cpu"), 20)
    # one device: greedy tokens, each step's logits
    logits, caches = model.prefill(batch, cache_len=cache_lens[0])
    want, toks = [logits], [logits[:, -1].argmax(-1)[:, None]]
    for i in range(DECODE_STEPS):
        logits, caches = model.decode_step(toks[-1], caches, PROMPT + i)
        want.append(logits)
        toks.append(logits[:, -1].argmax(-1)[:, None])
    ex = MeshExecutor(rules)
    ex.shard_model(model)
    case = dict(arch=cfg.name, mesh=list(shape), kv=kv, errs=[], scale=[],
                same_tokens=True, cache_bytes=[], coll=[])
    step = make_serve_step(cfg, rules)
    for n_cache in cache_lens:
        logits, mc = make_prefill_step(cfg, rules, n_cache)(model, batch)
        got = [logits]
        for i in range(DECODE_STEPS):
            specs = rules.cache_specs([{n: torch.empty(
                t.shape, dtype=t.dtype, device="meta")
                for n, t in c.items()} for c in mc])
            flat = {(j, n): t for j, c in enumerate(mc)
                    for n, t in c.items()}
            case["cache_bytes"].append([
                dryrun.local_bytes(flat),
                dryrun.analytic_bytes_per_device(
                    flat, {(j, n): s for j, c in enumerate(specs)
                           for n, s in c.items()},
                    rules.axis_size)])
            counter = OpCounter(WORLD)
            with counter:
                logits, mc = step(model, toks[i], mc, PROMPT + i)
            got.append(logits)
            if i == 0:
                case["coll"].append(counter.coll.get("total", 0.0))
        if n_cache != cache_lens[0]:
            continue
        for g, w, t in zip(got, want, toks):
            case["errs"].append(float((g.full_tensor() - w).abs().max()))
            case["scale"].append(float(w.abs().max()))
            case["same_tokens"] &= torch.equal(
                ex.greedy(g), ex.own_rows(t))
    return case


def _moe_cfg(impl: str):
    cfg = configs.get_smoke_config("granite-moe-3b-a800m")
    return dataclasses.replace(cfg, moe_impl=impl, moe=dataclasses.replace(
        cfg.moe, **MOE5))


class _Recorded:
    """Records what ``layers.<name>`` returns (``take`` of its result) at
    every call, while active."""

    def __init__(self, name: str, take):
        self.name, self.take, self.seen = name, take, []

    def __enter__(self):
        self._real = real = getattr(layers, self.name)

        def spy(*args, **kw):
            out = real(*args, **kw)
            self.seen.append(self.take(args, out))
            return out
        setattr(layers, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(layers, self.name, self._real)


def _moe_collectives(tr: Trainer) -> list:
    """The collective bytes of each MoE layer of one forward pass of
    ``tr``'s model on its first batch, counted by
    ``repro_torch.launch.hlo_analysis``, and the bytes of the MoE's expert
    outputs that this rank hands to its collective."""
    seen, real = [], layers.moe_ffn

    def counted(x, p, cfg, ac=None, rows=None):
        counter = OpCounter(WORLD)
        with counter:
            y = real(x, p, cfg, ac, rows)
        seen.append(dict(counter.coll))
        return y
    ex = tr.executor
    batch = ex.local_batch(tr.rules.constrain_batch(tr.data.batch_at(0)))
    layers.moe_ffn = counted
    try:
        with torch.no_grad():
            tr.model.train_terms(batch, remat=False)
    finally:
        layers.moe_ffn = real
    return seen


def _unoffset_dispatch(x, r, K, e0, El, c0, Cl):
    """The planted fault: a capacity slice's counts (and rows) not offset
    by its first row ``c0``: every slice filled as the first."""
    return _REAL_DISPATCH(x, r, K, e0, El, 0, Cl)


_REAL_DISPATCH = layers._dispatch


def _local_aux(x, p, cfg, rows=None):
    """The planted fault: the load-balancing loss from this rank's rows'
    statistics only."""
    return _REAL_AUX(x, p, cfg)


_REAL_AUX = layers.moe_aux_loss


def check_rest_of_split(out: dict) -> None:
    """(i) the MoE's capacity over the fsdp axes, the grouped MoE with its
    rows kept local, and xlstm-125m's mixers split over ``model``, against
    the one-device runs; then the two planted faults."""
    one = {}
    for impl, shape, kw in MOE_STEPS:
        cfg = _moe_cfg(impl)
        key = (impl, tuple(sorted(kw.items())))
        aux_of = lambda a, y: float(y.detach())  # noqa: E731
        # each grouped matmul's rows and live rows (the sum of its counts)
        gmm_of = lambda a, y: (a[0].shape[-2], int(a[2].sum()))  # noqa
        if key not in one:
            with _Recorded("moe_aux_loss", aux_of) as aux, \
                    _Recorded("moe_gmm", gmm_of) as gmm:
                one[key] = _one_device(cfg, STEPS, _pcfg(**kw))
            one[key].update(aux=aux.seen, live=[n for _, n in gmm.seen])
        tr = Trainer(cfg, SHAPE, make_test_mesh(shape), pcfg=_pcfg(**kw),
                     seed=1)
        tr.init_state()
        with _Recorded("moe_aux_loss", aux_of) as aux, \
                _Recorded("moe_gmm", gmm_of) as gmm:
            case = _compared(tr, STEPS, one[key])
        T = SHAPE.global_batch * SHAPE.seq_len // kw.get("grad_accum", 1)
        # the grouped dispatch's expert outputs on this rank: its rows'
        # buffers [B, E, C, D] in f32
        C4 = math.ceil(SHAPE.seq_len * cfg.moe.top_k / cfg.moe.n_experts
                       * cfg.moe.capacity_factor)
        out["rest_moe"].append(dict(
            impl=impl, mesh=list(shape), kw=kw, **case, **_state_report(tr),
            aux=aux.seen, want_aux=one[key]["aux"],
            buf_rows=sorted({r for r, _ in gmm.seen}),
            live=[n for _, n in gmm.seen], want_live=one[key]["live"],
            capacity=layers.global_capacity(T, cfg),
            grouped_out_bytes=4 * (SHAPE.global_batch // shape[0])
            * cfg.moe.n_experts * C4 * cfg.d_model,
            moe_coll=_moe_collectives(tr)))
    faults = (("unoffset_slice", "global", "_dispatch", _unoffset_dispatch),
              ("local_aux", "grouped", "moe_aux_loss", _local_aux))
    for name, impl, attr, fault in faults:
        cfg = _moe_cfg(impl)
        tr = Trainer(cfg, SHAPE, make_test_mesh((2, 2)), pcfg=_pcfg(), seed=1)
        tr.init_state()
        real = getattr(layers, attr)
        setattr(layers, attr, fault)
        try:
            with _Recorded("moe_aux_loss", aux_of) as aux:
                case = _compared(tr, STEPS, one[(impl, ())])
        finally:
            setattr(layers, attr, real)
        out["rest_faults"].append(dict(name=name, **case, aux=aux.seen,
                                       want_aux=one[(impl, ())]["aux"]))
    for over, kv in XLSTM_CASES:
        cfg = dataclasses.replace(configs.get_smoke_config("xlstm-125m"),
                                  **over)
        want = _one_device(cfg, STEPS)
        tr = Trainer(cfg, SHAPE, make_test_mesh((1, 4)), pcfg=_pcfg(),
                     seed=1)
        tr.init_state()
        # the heads and value columns of each mLSTM call, the columns of
        # each sLSTM loop
        with _Recorded("_mlstm_inputs", lambda a, y: list(y[2].shape[2:])
                       ) as ml, \
                _Recorded("slstm_share", lambda a, y: y[1]["h"].shape[-1]
                          ) as sl:
            case = dict(over=over, **_compared(tr, STEPS, want),
                        **_state_report(tr))
        case.update(mlstm_heads=sorted(set(map(tuple, ml.seen))),
                    slstm_cols=sorted(set(sl.seen)))
        case["serving"] = _split_decode(cfg, (1, 4), kv, CACHE_LENS[:1])
        out["rest_xlstm"].append(case)


def check_elastic(out: dict, ckpt: Path) -> None:
    """(b) 2 steps on (2, 2), a checkpoint, a restore on (4, 1), 2 more
    steps, against 4 steps on (2, 2); then resize onto (1, 4) and one
    more step against the one-device run's 5th."""
    cfg = configs.get_smoke_config("granite-moe-3b-a800m")
    ref = Trainer(cfg, SHAPE, make_test_mesh((2, 2)), seed=1)
    ref.init_state()
    want = ref.run(4).losses
    one = _one_device(cfg, 5)
    ta = Trainer(cfg, SHAPE, make_test_mesh((2, 2)), ckpt_dir=ckpt, seed=1)
    ta.init_state()
    first = ta.run(2).losses
    ta.save_checkpoint()
    saved = {n: _digest(p.full_tensor())
             for n, p in ta.model.named_parameters()}
    tb = Trainer(cfg, SHAPE, make_test_mesh((4, 1)), ckpt_dir=ckpt, seed=1)
    restored = tb.maybe_restore()
    same_state = restored and tb.step == 2 and saved == {
        n: _digest(p.full_tensor()) for n, p in tb.model.named_parameters()}
    placed = all(list(p.placements) == tb.rules.placements(tb.executor.specs[n])
                 for n, p in tb.model.named_parameters())
    then = tb.run(2).losses
    tb.resize(make_test_mesh((1, 4)))
    after, norms = _run(tb, 1)
    out["elastic"] = dict(losses=first + then, want=want, restored=restored,
                          same_state=same_state, placed=placed,
                          resized=after, one_device=one["losses"][4:],
                          norms=norms, want_norms=one["norms"][4:],
                          state_err=_state_errors(tb, tb.host_state(),
                                                  one["state"]),
                          step=tb.step, **_state_report(tb))


def check_serving(out: dict) -> None:
    """(c) prefill logits and one decode step's on (2, 2) against one
    device: granite (MoE routed over the whole batch; k/v split by heads)
    and whisper (encoder, cross caches; k/v split by slots)."""
    mesh = make_test_mesh((2, 2))
    for arch, kv in (("granite-moe-3b-a800m", "heads"),
                     ("whisper-large-v3", "seq")):
        cfg = configs.get_smoke_config(arch)
        pcfg = _pcfg(kv_shard=kv)
        B, S = 4, 16
        model = Model(cfg, generator=torch.Generator().manual_seed(3),
                      device="cpu")
        batch = serve.make_batch(cfg, B, S, 0, torch.device("cpu"), 20)
        want_logits, caches = model.prefill(batch, cache_len=S + 2)
        tok = want_logits[:, -1].argmax(-1)[:, None]
        want_step, _ = model.decode_step(tok, caches, S)
        rules = MeshRules(cfg, pcfg, mesh)
        MeshExecutor(rules).shard_model(model)
        logits, mcaches = make_prefill_step(cfg, rules, S + 2)(model, batch)
        specs = rules.cache_specs(Model(cfg, device="meta").init_caches(
            B, S + 2, 20))
        placed = all(list(t.placements) == rules.placements(s[n])
                     for c, s in zip(mcaches, specs) for n, t in c.items())
        step, mcaches = make_serve_step(cfg, rules)(model, tok, mcaches, S)
        out["serving"].append(dict(
            arch=arch, placed=placed,
            prefill_err=float((logits.full_tensor() - want_logits).abs()
                              .max()),
            prefill_scale=float(want_logits.abs().max()),
            decode_err=float((step.full_tensor() - want_step).abs().max()),
            decode_scale=float(want_step.abs().max())))


def check_pipeline(out: dict) -> None:
    """(d) GPipe over a 4-stage axis against sequential application, the
    reference test's stage function and sizes, and with M < S."""
    mesh = make_test_mesh((WORLD,), ("stage",))
    rng = np.random.default_rng(0)
    S, D = PIPE_S, PIPE_D
    Ws = torch.from_numpy((rng.normal(size=(S, D, D)) * 0.3)
                          .astype(np.float32))
    bs = torch.from_numpy((rng.normal(size=(S, D)) * 0.1).astype(np.float32))
    mbs = torch.from_numpy(rng.normal(size=(PIPE_M, 8, D)).astype(np.float32))

    def stage_fn(params, x):
        W, b = params
        return torch.tanh(x @ W + b)

    for M in (PIPE_M, 2):
        got = pipeline_apply(stage_fn, mesh, "stage", (Ws, bs), mbs[:M])
        ref = mbs[:M]
        for i in range(S):
            ref = torch.tanh(ref @ Ws[i] + bs[i])
        out["pipeline"].append(dict(M=M, shape=list(got.shape),
                                    max_err=float((got - ref).abs().max())))


def check_jax_checkpoint(out: dict, path: Path) -> None:
    """(e) a checkpoint the JAX package wrote with its (2, 2) specs,
    restored on a (2, 2) mesh: each leaf placed by its stored spec, and
    the same values as the plain restore."""
    mesh = make_test_mesh((2, 2))
    manifest = json.loads((path / "step_3" / "manifest.json").read_text())
    plain, _ = restore(path, 3)
    got, extra = restore(path, 3, mesh=mesh)
    from repro_torch.checkpoint.topology import (_flatten_with_paths,
                                                 _spec_from_json)
    flat, want = _flatten_with_paths(got), _flatten_with_paths(plain)
    placed = same = True
    rules = MeshRules(configs.get_smoke_config("llama3.2-3b"), _pcfg(), mesh)
    for key, t in flat.items():
        spec = manifest["leaves"][key]["spec"]
        placed &= list(t.placements) == rules.placements(
            _spec_from_json(spec) if spec else ())
        same &= torch.equal(t.full_tensor(), want[key])
    out["jax_checkpoint"] = dict(placed=placed, same=same, extra=extra,
                                 leaves=len(flat))


def check_launcher(out: dict) -> None:
    """(f) ``launch/train.py --smoke`` under a world of four ranks (as
    torchrun would start them): a ``(4, 1)`` mesh of every rank, one step
    against the one-device trainer's on the same shape and plan."""
    os.environ["WORLD_SIZE"] = str(WORLD)
    rep = train_launcher.main(["--arch", "llama3.2-3b", "--smoke",
                               "--device", "cpu", "--steps", "1"])
    cfg = configs.get_smoke_config("llama3.2-3b")
    shape = ShapeCfg("smoke", 64, 4, "train")
    one = Trainer(cfg, shape, "cpu", pcfg=default_parallel(cfg, shape))
    one.init_state()
    out["launcher"] = dict(losses=rep.losses, want=one.run(1).losses)


def main(rank: int, store_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    out = {"steps": [], "serving": [], "pipeline": [], "split_steps": [],
           "split_faults": [], "split_serving": [], "rest_moe": [],
           "rest_faults": [], "rest_xlstm": []}
    out_dir = Path(out_dir)
    try:
        check_steps(out)
        check_split_steps(out)
        check_split_serving(out)
        check_rest_of_split(out)
        check_elastic(out, out_dir / "ckpt")
        check_serving(out)
        check_pipeline(out)
        check_jax_checkpoint(out, out_dir / "jax_ckpt")
        check_launcher(out)
        (out_dir / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()

