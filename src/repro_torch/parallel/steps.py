"""The train step on one device: loss and gradients (with gradient
accumulation over microbatches), the warmup-cosine learning rate and
AdamW.

Port of ``make_train_step`` of ``src/repro/parallel/steps.py``.  On one
device the reference's mesh hooks have nothing to do: ``pin_grads`` and
``constrain_batch`` are the identity and ``ac`` is not needed, so the
port has none of them.  ``make_serve_step`` and ``make_prefill_step``
come with the meshes (``Model.decode_step`` and ``Model.prefill`` serve
on one device).
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from ..configs.base import ModelConfig, ParallelCfg
from ..optim import adamw_update, warmup_cosine


def _grads(model, batch, remat: bool) -> Tuple[torch.Tensor, Dict]:
    """(loss, gradients by parameter name) of one (micro)batch; a
    parameter the loss does not reach gets zeros, as ``jax.grad`` gives."""
    names, params = zip(*model.named_parameters())
    loss = model.forward_train(batch, remat=remat)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.detach(), {n: torch.zeros_like(p) if g is None else g
                           for n, p, g in zip(names, params, grads)}


def make_train_step(cfg: ModelConfig, pcfg: ParallelCfg, *,
                    peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10000):
    """Returns ``train_step(model, opt_state, batch, step) -> (model,
    opt_state, metrics)``: the model's parameters and the AdamW state
    updated in place, ``metrics`` holding ``loss``, ``lr`` and
    ``grad_norm`` (tensors).  With ``pcfg.grad_accum = A > 1`` the batch
    splits into ``A`` microbatches along its first axis, one at a time
    through the model; their gradients add up in ``pcfg.grad_dtype``,
    each divided by ``A``, and the loss is their mean."""
    A = pcfg.grad_accum
    gdt = getattr(torch, pcfg.grad_dtype)

    def train_step(model, opt_state: Dict, batch: Mapping[str, torch.Tensor],
                   step):
        if A == 1:
            loss, grads = _grads(model, batch, pcfg.remat)
        else:
            mbs = [{k: v[i * (v.shape[0] // A):(i + 1) * (v.shape[0] // A)]
                    for k, v in batch.items()} for i in range(A)]
            loss = torch.zeros((), dtype=torch.float32,
                               device=model.device)
            grads = {n: torch.zeros(p.shape, dtype=gdt, device=p.device)
                     for n, p in model.named_parameters()}
            for mb in mbs:
                mb_loss, mb_grads = _grads(model, mb, pcfg.remat)
                for n, g in mb_grads.items():
                    grads[n] = grads[n] + g.to(gdt) / A
                loss = loss + mb_loss / A
        lr = warmup_cosine(step, peak_lr=peak_lr, warmup_steps=warmup,
                           total_steps=total_steps)
        _, opt_state, metrics = adamw_update(
            grads, opt_state, dict(model.named_parameters()),
            lr=lr.to(model.device))
        metrics["loss"] = loss
        metrics["lr"] = lr
        return model, opt_state, metrics

    return train_step
