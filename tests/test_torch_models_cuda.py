"""The port's model stack and the deprecated shim on the card, held against
the same code on the CPU.

Smoke-config models (granite-moe-3b-a800m for attention and the MoE,
h2o-danube-3-4b for the windowed ring cache) are built once on the CPU and
copied to the card; prefill and decode run on both and must agree, while
the launch counts show which kernel ran: f32 on the CUDA-core flash
attention and grouped-matmul kernels, bf16 on the wgmma/TMA ones (the
smoke heads of 8 and 16 and the expert widths are multiples of 8, so TMA
can load them).  The recurrent families likewise: recurrentgemma-2b
(RG-LRU on the scan kernel in the prefill and every decode step, local
attention on flash past its window) and xlstm-125m's production profile
(the chunked mLSTM on ``mlstm_chunk`` in the prefill, the per-step decode
and the sLSTM in plain ops).  The encoder–decoder family: whisper-large-v3's
smoke config (heads of 16), flash attention in the bidirectional encoder,
the decoder's causal self-attention and the cross-attention of the prefill
and of every decode step.  The shim's legacy ``launch`` on a ``cuda``
session must give the interpreter's bits.

Marked ``gpu``: without a CUDA device every test skips.  On a machine with
one (no jax needed), from the checkout root:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_models_cuda.py
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import HetSession, TranslationCache
from repro_torch.core import kernels_suite as ks
from repro_torch.configs.base import MLSTM, RGLRU, SWA
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.mlstm_chunk.kernel import mlstm_chunk_fwd
from repro_torch.kernels.moe_gmm.kernel import moe_gmm_fwd
from repro_torch.kernels.rglru_scan.kernel import rglru_scan_fwd
from repro_torch.launch import serve
from repro_torch.models import Model

pytestmark = pytest.mark.gpu

#: f32 on both sides: the card's sums in another order
F32_TOL = 1e-4
#: bf16 on both sides: each side rounds every product to bf16 (2^-8
#: relative), in another order, through two layers
BF16_TOL = 5e-2
COUNTERS = {"flash_f32": (flash_attention_fwd, "launches"),
            "flash_sm90": (flash_attention_fwd, "sm90_launches"),
            "gmm_f32": (moe_gmm_fwd, "launches"),
            "gmm_sm90": (moe_gmm_fwd, "sm90_launches"),
            "rglru": (rglru_scan_fwd, "launches"),
            "mlstm": (mlstm_chunk_fwd, "launches")}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _counts():
    return {k: getattr(fn, attr) for k, (fn, attr) in COUNTERS.items()}


def _cast(model, cfg, dtype, device):
    """The weights of ``model`` in ``dtype`` on ``device``."""
    name = str(dtype).removeprefix("torch.")
    out = Model(dataclasses.replace(cfg, param_dtype=name,
                                    compute_dtype=name), device="meta")
    out.load_state_dict({k: v.to(device, dtype)
                         for k, v in model.state_dict().items()},
                        assign=True)
    return out


def _run(model, batch, steps, tokens=None):
    """Prefill and ``steps - 1`` decode steps; each step takes the token of
    ``tokens`` (the greedy tokens of another run) where given.  Returns
    the logits of every step and the tokens fed."""
    S = batch["tokens"].shape[1]
    logits, caches = model.prefill(batch, cache_len=S + steps)
    out, fed = [logits.float().cpu()], []
    for i in range(steps - 1):
        tok = logits[:, -1].argmax(-1)[:, None] if tokens is None \
            else tokens[i].to(model.device)
        fed.append(tok.cpu())
        logits, caches = model.decode_step(tok, caches, S + i)
        out.append(logits.float().cpu())
    return out, fed


@pytest.mark.parametrize("arch,S", [("granite-moe-3b-a800m", 40),
                                    ("h2o-danube-3-4b", 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_smoke_model_on_the_card_matches_cpu(arch, S, dtype, dev):
    """The same weights in the same type on the CPU (plain versions) and
    the card (kernels), fed the same tokens."""
    cfg = configs.get_smoke_config(arch)
    ref = Model(cfg, generator=torch.Generator().manual_seed(0),
                device="cpu")
    cpu, gpu = _cast(ref, cfg, dtype, "cpu"), _cast(ref, cfg, dtype, dev)
    batch = serve.make_batch(cfg, 2, S, seed=5, device="cpu")
    want, tokens = _run(cpu, batch, 3)
    before = _counts()
    got, _ = _run(gpu, {k: v.to(dev) for k, v in batch.items()}, 3, tokens)
    torch.cuda.synchronize()
    ran = {k: _counts()[k] - before[k] for k in COUNTERS}
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=tol, rtol=tol)
    route = "f32" if dtype == torch.float32 else "sm90"
    other = "sm90" if route == "f32" else "f32"
    # the prefill's attention of every layer on the flash kernel
    assert ran[f"flash_{route}"] == cfg.n_layers and \
        ran[f"flash_{other}"] == 0, ran
    if cfg.moe is not None:
        # three expert products a layer, in the prefill and each decode step
        assert ran[f"gmm_{route}"] == 3 * cfg.n_layers * 3 and \
            ran[f"gmm_{other}"] == 0, ran


@pytest.mark.parametrize("arch,S,dtype", [
    ("recurrentgemma-2b", 40, torch.float32),
    ("recurrentgemma-2b", 40, torch.bfloat16),
    ("xlstm-125m", 48, torch.float32)])
def test_recurrent_smoke_model_on_the_card_matches_cpu(arch, S, dtype, dev):
    """recurrentgemma-2b past its window of 16, and xlstm-125m's production
    profile in chunks of 16: the same weights on the CPU (plain versions)
    and the card (kernels), fed the same tokens."""
    cfg = dataclasses.replace(configs.get_optimized_smoke_config(arch),
                              mlstm_chunk=16)
    ref = Model(cfg, generator=torch.Generator().manual_seed(0),
                device="cpu")
    cpu, gpu = _cast(ref, cfg, dtype, "cpu"), _cast(ref, cfg, dtype, dev)
    batch = serve.make_batch(cfg, 2, S, seed=5, device="cpu")
    steps = 3
    want, tokens = _run(cpu, batch, steps)
    before = _counts()
    got, _ = _run(gpu, {k: v.to(dev) for k, v in batch.items()}, steps,
                  tokens)
    torch.cuda.synchronize()
    ran = {k: _counts()[k] - before[k] for k in COUNTERS}
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=tol, rtol=tol)
    kinds = [s.mixer for s in cfg.blocks()]
    # the scan in the prefill and in every decode step; the chunked mLSTM
    # in the prefill only; flash in the local-attention layers' prefill
    assert ran["rglru"] == kinds.count(RGLRU) * steps, ran
    assert ran["mlstm"] == kinds.count(MLSTM), ran
    route = "flash_f32" if dtype == torch.float32 else "flash_sm90"
    assert ran[route] == kinds.count(SWA), ran


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_whisper_smoke_model_on_the_card_matches_cpu(dtype, dev):
    """whisper-large-v3's smoke config over 40 text tokens and 150 frames:
    the same weights on the CPU (plain versions) and the card (kernels),
    fed the same tokens, a prefill and 3 decode steps."""
    cfg = configs.get_smoke_config("whisper-large-v3")
    ref = Model(cfg, generator=torch.Generator().manual_seed(0),
                device="cpu")
    cpu, gpu = _cast(ref, cfg, dtype, "cpu"), _cast(ref, cfg, dtype, dev)
    batch = serve.make_batch(cfg, 2, 40, seed=5, device="cpu", enc_len=150)
    steps = 4
    want, tokens = _run(cpu, batch, steps)
    before = _counts()
    got, _ = _run(gpu, {k: v.to(dev) for k, v in batch.items()}, steps,
                  tokens)
    torch.cuda.synchronize()
    ran = {k: _counts()[k] - before[k] for k in COUNTERS}
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=tol, rtol=tol)
    route = "flash_f32" if dtype == torch.float32 else "flash_sm90"
    # the prefill: each encoder layer, then each decoder layer's self- and
    # cross-attention; each decode step: each decoder layer's
    # cross-attention (its self-attention against the cache in plain ops)
    runs = cfg.enc_layers + 2 * cfg.n_layers + cfg.n_layers * (steps - 1)
    assert ran[route] == runs and sum(ran.values()) == runs, ran


def test_legacy_shim_launch_on_cuda_is_bit_equal_to_interp(dev):
    prog, _ = ks.saxpy()
    X = np.random.default_rng(2).normal(size=256).astype(np.float32)
    Y = np.random.default_rng(3).normal(size=256).astype(np.float32)
    out = {}
    for backend, device in (("cuda", dev), ("interp", "cpu")):
        s = HetSession(backend, device=device, cache=TranslationCache())
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            s.load_kernel(prog)
            s.gpu_malloc("X", 256)
            s.gpu_malloc("Y", 256)
            s.memcpy_h2d("X", X)
            s.memcpy_h2d("Y", Y)
            s.launch("saxpy", grid=8, block=32, args={"n": 256, "a": 0.7})
            s.device_synchronize()
            out[backend] = s.memcpy_d2h("Y")
        if backend == "cuda":
            assert sum(s.backend.launches.values()) > 0
    assert out["cuda"].view(np.uint32).tolist() == \
        out["interp"].view(np.uint32).tolist()


@pytest.mark.parametrize("impl", ["global", "grouped"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_layer_is_deterministic_on_the_card(impl, dtype, dev):
    """The MoE combine adds each token's contributions in a fixed order
    (no atomics): two runs of one layer on the same input give the same
    bits, at granite's width over 4096 tokens (many tokens to a row of
    the output, so that atomics would reorder)."""
    from repro_torch.models import layers
    cfg = dataclasses.replace(configs.get_config("granite-moe-3b-a800m"),
                              moe_impl=impl)
    g = torch.Generator(device=dev).manual_seed(0)
    p = layers.init_moe(cfg, dtype, dev, g)
    x = torch.randn((4, 1024, cfg.d_model), generator=g, device=dev) \
        .to(dtype)
    before = _counts()
    outs = [layers.moe_ffn(x, p, cfg) for _ in range(2)]
    torch.cuda.synchronize()
    after = _counts()
    kernel = "gmm_sm90" if dtype == torch.bfloat16 else "gmm_f32"
    assert after[kernel] - before[kernel] > 0
    assert torch.equal(outs[0], outs[1])
