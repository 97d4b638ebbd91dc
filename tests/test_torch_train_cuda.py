"""The port's training path on the card, held against the same step on
the plain versions of the kernels.

One train step (``repro_torch.parallel.make_train_step``, remat, AdamW)
of granite-moe-3b-a800m's smoke config (2 layers of attention and an
8-expert MoE, d_model 48) in f32 runs on the card's f32 kernels, and
again with the layers' flash attention and grouped matmul ops patched to
their plain versions (autograd through the plain ops): the loss, the
gradient norm, every parameter's gradient and update must agree, and the
launch counts show the kernels ran in the forward and in the recompute.
The same holds for the recurrent and encoder–decoder families' smoke
configs: recurrentgemma-2b (RG-LRU scans, windowed flash attention past
its window), xlstm-125m's production profile (the chunked mLSTM in
chunks of 16, whose backward recomputes through the chunked oracle) and
whisper-large-v3 (bidirectional, causal and cross flash attention).
The bf16 model's step on the wgmma/TMA kernels must give a finite loss
and launch them likewise.  Flash attention's chunked backward
(``attn_vjp="flash"``) agrees with its whole recompute in f32 and bf16.

Marked ``gpu``: without a CUDA device every test skips.  On a machine with
one (no jax needed), from the checkout root:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_train_cuda.py
"""
import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import ATTN, MLSTM, RGLRU, SWA, ParallelCfg
from repro_torch.kernels import flash_attention
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_fwd, flash_attention_plain)
from repro_torch.kernels.mlstm_chunk.kernel import (mlstm_chunk_fwd,
                                                    mlstm_chunk_plain)
from repro_torch.kernels.moe_gmm.kernel import moe_gmm_fwd, moe_gmm_plain
from repro_torch.kernels.rglru_scan.kernel import (rglru_scan_fwd,
                                                   rglru_scan_plain)
from repro_torch.models import Model, layers
from repro_torch.optim import adamw_init
from repro_torch.parallel import make_train_step
from repro_torch.parallel import steps as step_module

pytestmark = pytest.mark.gpu

ARCH = "granite-moe-3b-a800m"
B, S = 4, 64
#: the encoder's frames in an encoder–decoder batch
ENC_LEN = 48
#: the recurrent and encoder–decoder families: (arch, config overrides)
FAMILIES = [("recurrentgemma-2b", {}),
            ("xlstm-125m", {"mlstm_impl": "chunked", "mlstm_chunk": 16}),
            ("whisper-large-v3", {})]
#: the layers' kernel ops as their plain versions
PLAIN = {"flash_attention": lambda q, k, v, causal, window, **kw:
         flash_attention_plain(q, k, v, causal=causal, window=window),
         "moe_gmm": moe_gmm_plain, "rglru_scan": rglru_scan_plain,
         "mlstm_chunk": lambda q, k, v, lf, gi, bt:
         mlstm_chunk_plain(q, k, v, lf, gi, bt=bt)}
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

    patch = patch or {}
    old = {n: getattr(layers, n) for n in patch}
    step_module.adamw_update = keep
    for n, op in patch.items():
        setattr(layers, n, op)
    try:
        _, _, m = step(model, adamw_init(dict(model.named_parameters())),
                       batch, 0)
    finally:
        step_module.adamw_update = real
        for n, op in old.items():
            setattr(layers, n, op)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "grads": seen, "update": {n: p.detach() - init[n]
                                      for n, p in model.named_parameters()}}


def _batch(cfg, dev):
    g = torch.Generator().manual_seed(3)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                   generator=g).to(dev)}
    if cfg.encoder_decoder:
        out["enc_embeds"] = (torch.randn((B, ENC_LEN, cfg.d_model),
                                         generator=g) * 0.02).to(dev)
    return out


def _launches():
    return {"flash_attention": flash_attention_fwd.launches,
            "moe_gmm": moe_gmm_fwd.launches,
            "rglru_scan": rglru_scan_fwd.launches,
            "mlstm_chunk": mlstm_chunk_fwd.launches}


def _kernels_match_plain(cfg, dev, plain_ops) -> dict:
    """One f32 step on the kernels and one on ``plain_ops``, held to
    ``TOL``; returns the kernels' launches in the first."""
    model = Model(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                  device=dev)
    init = {n: t.clone() for n, t in model.state_dict().items()}
    batch = _batch(cfg, dev)
    before = _launches()
    kern = _step(model, batch, init)
    launched = {n: c - before[n] for n, c in _launches().items()}
    plain = _step(model, batch, init, plain_ops)

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp(min=1e-30))
    assert abs(kern["loss"] - plain["loss"]) <= TOL["loss"]
    assert abs(kern["grad_norm"] / plain["grad_norm"] - 1) \
        <= TOL["grad_norm"]
    for n, g in plain["grads"].items():
        assert rel(kern["grads"][n], g) <= TOL["grad"], n
        assert rel(kern["update"][n], plain["update"][n]) \
            <= TOL["update"], n
    return launched


def test_train_step_on_the_kernels_matches_plain(dev):
    cfg = configs.get_smoke_config(ARCH)
    launched = _kernels_match_plain(cfg, dev, {
        n: PLAIN[n] for n in ("flash_attention", "moe_gmm")})
    assert (launched["flash_attention"], launched["moe_gmm"]) == \
        (2 * cfg.n_layers, 6 * cfg.n_layers)


@pytest.mark.parametrize("arch,over", FAMILIES, ids=[a for a, _ in FAMILIES])
def test_family_train_step_on_the_kernels_matches_plain(dev, arch, over):
    """A recurrent or encoder–decoder smoke model's f32 step: each kernel
    launched once in the forward and once in the recompute of each of its
    layers (none in the backward: the oracles recompute)."""
    cfg = dataclasses.replace(configs.get_smoke_config(arch), **over)
    kinds = [s.mixer for s in cfg.blocks()]
    attn = sum(k in (ATTN, SWA) for k in kinds) \
        + sum(s.cross_attn for s in cfg.blocks()) \
        + (cfg.enc_layers if cfg.encoder_decoder else 0)
    want = {"flash_attention": 2 * attn, "moe_gmm": 0,
            "rglru_scan": 2 * kinds.count(RGLRU),
            "mlstm_chunk": 2 * kinds.count(MLSTM)}
    assert sum(want.values()) > 0
    assert _kernels_match_plain(cfg, dev, PLAIN) == want


#: the "flash" backward against the "autodiff" one on the card, each
#: gradient's largest error over its largest entry: f32 sums in another
#: order (1e-5, as the CPU test against the JAX model), bf16 one rounding
#: of the f32 result to bf16 apart
VJP_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_backward_matches_autodiff(dev, dtype):
    """The chunked backward (``attn_vjp="flash"``: chunks of 512 query
    rows, the last of 76) against the whole recompute, causal, windowed
    and bidirectional, the forward on the kernels."""
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v, do = (torch.randn((2, 4, 1100, 64), generator=g, device=dev)
                   .to(dtype) for _ in range(4))
    for causal, window in ((True, None), (True, 300), (False, None)):
        grads = {}
        for vjp in ("autodiff", "flash"):
            ts = [t.clone().requires_grad_() for t in (q, k, v)]
            o = flash_attention(*ts, causal, window, vjp=vjp)
            grads[vjp] = torch.autograd.grad(o, ts, do)
        for a, f in zip(grads["autodiff"], grads["flash"]):
            assert f.dtype == dtype
            err = float((f.float() - a.float()).abs().max()
                        / a.float().abs().max())
            assert err <= VJP_RTOL[dtype], (causal, window, err)


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
