"""Train, serve and prefill steps, on one device or on a mesh: gradient
accumulation over microbatches, remat, the warmup-cosine learning rate,
AdamW, and the batched decode step.

Port of ``src/repro/parallel/steps.py``.  Without rules, or with rules on
one device (the ``(1, 1)`` mesh), the steps are the one-device ones:
``Model.forward_train``'s gradients and AdamW on plain tensors,
``Model.prefill`` and ``Model.decode_step``, bit for bit.  With rules on a
mesh of several ranks the model is bound to a
:class:`~repro_torch.parallel.executor.MeshExecutor` and its state is
``DTensor``s: each (micro)batch is pinned to its specs
(``rules.constrain_batch``) and each rank computes on its rows; the
gradients land in their parameters' placements (``pin_grads``: the
executor's reduce-scatter and all-reduce) after each microbatch, and
accumulate there in ``pcfg.grad_dtype``; AdamW updates each rank's
shards with the global gradient norm; the loss is the whole batch's, on
every rank.  The prefill and serve steps return the logits split by rows
(and by vocab where the compute is split over ``model``) and the caches
placed by ``rules.cache_specs``.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from ..configs.base import ModelConfig, ParallelCfg
from ..optim import adamw_update, warmup_cosine
from .sharding import MeshRules


def _grads(params: Dict[str, torch.Tensor], loss_fn: Callable
           ) -> Tuple[torch.Tensor, Dict]:
    """(loss, gradients by parameter name) of ``loss_fn()``; a parameter
    the loss does not reach gets zeros, as ``jax.grad`` gives."""
    names, ps = zip(*params.items())
    loss = loss_fn()
    grads = torch.autograd.grad(loss, ps, allow_unused=True)
    return loss.detach(), {n: torch.zeros_like(p) if g is None else g
                           for n, p, g in zip(names, ps, grads)}


def _one_device(rules: Optional[MeshRules]) -> bool:
    return rules is None or not rules.sharded


def make_train_step(cfg: ModelConfig, pcfg: ParallelCfg,
                    rules: Optional[MeshRules] = None, *,
                    peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10000):
    """Returns ``train_step(model, opt_state, batch, step) -> (model,
    opt_state, metrics)``: the model's parameters and the AdamW state
    updated in place, ``metrics`` holding ``loss``, ``lr`` and
    ``grad_norm`` (tensors).  With ``pcfg.grad_accum = A > 1`` the batch
    splits into ``A`` microbatches along its first axis, one at a time
    through the model; their gradients add up in ``pcfg.grad_dtype``,
    each divided by ``A``, and the loss is their mean.  On a mesh of
    several ranks (``rules``) the model is bound to a mesh executor, the
    moments are ``DTensor``s placed like the parameters, and the batch's
    leaves are ``DTensor``s or whole tensors."""
    A = pcfg.grad_accum
    gdt = getattr(torch, pcfg.grad_dtype)

    def lr_at(step):
        return warmup_cosine(step, peak_lr=peak_lr, warmup_steps=warmup,
                             total_steps=total_steps)

    def microbatches(batch):
        n = next(iter(batch.values())).shape[0] // A
        return [{k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                for i in range(A)]

    def train_step(model, opt_state: Dict, batch: Mapping[str, torch.Tensor],
                   step):
        params = dict(model.named_parameters())

        def loss_of(mb):
            return lambda: model.forward_train(mb, remat=pcfg.remat)
        if A == 1:
            loss, grads = _grads(params, loss_of(batch))
        else:
            loss = torch.zeros((), dtype=torch.float32,
                               device=model.device)
            grads = {n: torch.zeros(p.shape, dtype=gdt, device=p.device)
                     for n, p in params.items()}
            for mb in microbatches(batch):
                mb_loss, mb_grads = _grads(params, loss_of(mb))
                for n, g in mb_grads.items():
                    grads[n] = grads[n] + g.to(gdt) / A
                loss = loss + mb_loss / A
        lr = lr_at(step)
        _, opt_state, metrics = adamw_update(grads, opt_state, params,
                                             lr=lr.to(model.device))
        metrics["loss"] = loss
        metrics["lr"] = lr
        return model, opt_state, metrics

    def mesh_step(model, opt_state: Dict, batch, step):
        ex = model.executor
        params = dict(model.named_parameters())

        def loss_of(mb):
            local = ex.local_batch(rules.constrain_batch(mb))
            return lambda: ex.loss_share(model, local, pcfg.remat)
        if A == 1:
            share, grads = _grads(params, loss_of(batch))
        else:
            whole = {k: v.full_tensor() if isinstance(v, DTensor) else v
                     for k, v in batch.items()}
            share = torch.zeros((), dtype=torch.float32,
                                device=model.device)
            grads = {n: ex.zeros_like(p, gdt) for n, p in params.items()}
            for mb in microbatches(whole):
                mb_share, mb_grads = _grads(params, loss_of(mb))
                for n, g in mb_grads.items():
                    grads[n] = grads[n] + g.to(gdt) / A
                share = share + mb_share / A
        gnorm = ex.global_norm(grads)
        lr = lr_at(step)
        with torch.no_grad():
            local = {"m": {n: t.to_local() for n, t in opt_state["m"].items()},
                     "v": {n: t.to_local() for n, t in opt_state["v"].items()},
                     "count": opt_state["count"]}
            _, local, metrics = adamw_update(
                {n: g.to_local() for n, g in grads.items()}, local,
                {n: p.to_local() for n, p in params.items()},
                lr=lr.to(model.device), gnorm=gnorm)
        opt_state = dict(opt_state, count=local["count"])
        metrics["loss"] = ex.all_reduce(share)
        metrics["lr"] = lr
        return model, opt_state, metrics

    return train_step if _one_device(rules) else mesh_step


def make_serve_step(cfg: ModelConfig, rules: Optional[MeshRules] = None):
    """One batched decode step: ``(model, tokens, caches, pos) -> (logits,
    caches)``.  On one device ``Model.decode_step`` (the caches updated in
    place); on a mesh of several ranks ``tokens`` is a ``DTensor`` or the
    whole ``[B, 1]`` tensor and the caches are ``DTensor``s placed by
    ``rules.cache_specs``.  Where the compute is split over ``model``,
    each rank decodes its rows on its own blocks of the caches, updated
    in place (no cache moves between ranks), and the logits are split by
    rows and vocab; else each rank gathers its rows' caches whole for the
    step and the step returns new caches placed by the specs."""
    if _one_device(rules):
        def serve_step(model, tokens, caches, pos):
            return model.decode_step(tokens, caches, pos)
        return serve_step

    def mesh_serve_step(model, tokens, caches, pos):
        ex = model.executor
        tok = ex.local_batch({"tokens": tokens})["tokens"]
        if ex.model_split() is None:
            local = [{n: ex.rows_of(t) for n, t in c.items()}
                     for c in caches]
            logits, local = model.decode_step(tok, local, pos)
            return _placed(ex, rules, logits, local)
        dims = [{n: ex.model_dim(t) for n, t in c.items()} for c in caches]
        logits, _ = model.decode_step(
            tok, [{n: t.to_local() for n, t in c.items()} for c in caches],
            pos, dims)
        return ex.place_logits(logits), caches
    return mesh_serve_step


def make_prefill_step(cfg: ModelConfig, rules: Optional[MeshRules] = None,
                      cache_len: Optional[int] = None):
    """The prefill: ``(model, batch) -> (last-position logits, caches)``
    with room for ``cache_len`` tokens.  On one device ``Model.prefill``;
    on a mesh of several ranks each rank prefills its rows, and the step
    returns the logits split by rows and the caches placed by
    ``rules.cache_specs``."""
    if _one_device(rules):
        def prefill_step(model, batch):
            return model.prefill(batch, cache_len=cache_len)
        return prefill_step

    def mesh_prefill_step(model, batch):
        ex = model.executor
        logits, caches = model.prefill(ex.local_batch(batch),
                                       cache_len=cache_len)
        if ex.model_split() is None:
            return _placed(ex, rules, logits, caches)
        return ex.place_logits(logits), ex.place_caches(
            caches, model.cache_dims())
    return mesh_prefill_step


def _placed(ex, rules: MeshRules, logits, caches):
    """(this rank's rows of the logits as a ``DTensor`` split by rows, the
    caches as ``DTensor``s placed by their specs), from rows whole along
    every other dimension."""
    specs = rules.cache_specs(caches)
    rows = DTensor.from_local(logits, ex.mesh, ex.row_placements(),
                              run_check=False)
    return rows, [{n: ex.place_rows(t, s[n]) for n, t in c.items()}
                  for c, s in zip(caches, specs)]
