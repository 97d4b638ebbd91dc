"""The port's training path on the card, held against the same step on
the plain versions of the kernels.

One train step (``repro_torch.parallel.make_train_step``, remat, AdamW)
of granite-moe-3b-a800m's smoke config (2 layers of attention and an
8-expert MoE, d_model 48) in f32 runs on the card's f32 kernels, and
again with the layers' flash attention and grouped matmul ops patched to
their plain versions (autograd through the plain ops): the loss, the
gradient norm, every parameter's gradient and update must agree, and the
launch counts show the kernels ran in the forward and in the recompute.
The bf16 model's step on the wgmma/TMA kernels must give a finite loss
and launch them likewise.

Marked ``gpu``: without a CUDA device every test skips.  On a machine with
one (no jax needed), from the checkout root:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_train_cuda.py
"""
import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import ParallelCfg
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_fwd, flash_attention_plain)
from repro_torch.kernels.moe_gmm.kernel import moe_gmm_fwd, moe_gmm_plain
from repro_torch.models import Model, layers
from repro_torch.optim import adamw_init
from repro_torch.parallel import make_train_step
from repro_torch.parallel import steps as step_module

pytestmark = pytest.mark.gpu

ARCH = "granite-moe-3b-a800m"
B, S = 4, 64
#: f32 on both sides, sums in another order: loss (absolute), gradient
#: norm (relative), each gradient (relative L2); AdamW's update moves
#: gradient entries at the rounding noise by up to lr·|g|/eps, so updates
#: are held in relative L2 ten times looser
TOL = {"loss": 1e-5, "grad_norm": 1e-5, "grad": 1e-4, "update": 1e-3}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _step(model, batch, init, patch=None):
    """One train step from ``init``: loss, gradient norm, gradients and
    the update of every parameter."""
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(init[n])
    step = make_train_step(model.cfg, ParallelCfg(remat=True),
                           peak_lr=1e-3, warmup=1, total_steps=10)
    real = step_module.adamw_update
    seen = {}

    def keep(grads, opt, params, **kw):
        seen.update({n: g.detach().clone() for n, g in grads.items()})
        return real(grads, opt, params, **kw)

    old = (layers.flash_attention, layers.moe_gmm)
    step_module.adamw_update = keep
    if patch:
        layers.flash_attention, layers.moe_gmm = patch
    try:
        _, _, m = step(model, adamw_init(dict(model.named_parameters())),
                       batch, 0)
    finally:
        step_module.adamw_update = real
        layers.flash_attention, layers.moe_gmm = old
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "grads": seen, "update": {n: p.detach() - init[n]
                                      for n, p in model.named_parameters()}}


def _batch(cfg, dev):
    g = torch.Generator().manual_seed(3)
    return {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                    generator=g).to(dev)}


def test_train_step_on_the_kernels_matches_plain(dev):
    cfg = configs.get_smoke_config(ARCH)
    model = Model(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                  device=dev)
    init = {n: t.clone() for n, t in model.state_dict().items()}
    batch = _batch(cfg, dev)
    before = (flash_attention_fwd.launches, moe_gmm_fwd.launches)
    kern = _step(model, batch, init)
    launched = (flash_attention_fwd.launches - before[0],
                moe_gmm_fwd.launches - before[1])
    assert launched == (2 * cfg.n_layers, 6 * cfg.n_layers)
    plain = _step(model, batch, init, (
        lambda q, k, v, causal, window: flash_attention_plain(
            q, k, v, causal=causal, window=window), moe_gmm_plain))

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp(min=1e-30))
    assert abs(kern["loss"] - plain["loss"]) <= TOL["loss"]
    assert abs(kern["grad_norm"] / plain["grad_norm"] - 1) \
        <= TOL["grad_norm"]
    for n, g in plain["grads"].items():
        assert rel(kern["grads"][n], g) <= TOL["grad"], n
        assert rel(kern["update"][n], plain["update"][n]) \
            <= TOL["update"], n


def test_bf16_train_step_runs_on_the_wgmma_kernels(dev):
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    model = Model(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                  device=dev)
    before = (flash_attention_fwd.sm90_launches, moe_gmm_fwd.sm90_launches)
    step = make_train_step(cfg, ParallelCfg(remat=True), peak_lr=1e-3,
                           warmup=1, total_steps=10)
    _, opt, m = step(model, adamw_init(dict(model.named_parameters())),
                     _batch(cfg, dev), 0)
    torch.cuda.synchronize()
    assert (flash_attention_fwd.sm90_launches - before[0],
            moe_gmm_fwd.sm90_launches - before[1]) == \
        (2 * cfg.n_layers, 6 * cfg.n_layers)
    assert torch.isfinite(m["loss"]) and int(opt["count"]) == 1
    assert all(p.dtype == torch.bfloat16 and bool(torch.isfinite(p).all())
               for p in model.parameters())
