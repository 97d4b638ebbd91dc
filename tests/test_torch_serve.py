"""The port's serving launcher (``repro_torch.launch.serve``) on the CPU,
held against a greedy loop over the JAX package's ``prefill`` and
``decode_step`` on the same weights and prompts: granite-moe-3b-a800m's
smoke config (the MoE's global dispatch, serve's default) in f32, with
JAX's ``init_params(jax.random.key(0), cfg)`` carried over by
``params_from_jax``; the generated tokens must be identical.  The command
line runs too, with ``--device cpu`` (whisper-large-v3's encoder–decoder
among the archs), and the prompts, an encoder's frames among them, are
the JAX launcher's draws.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill

from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import Model, params_from_jax

torch.set_num_threads(2)

ARCH = "granite-moe-3b-a800m"
B, S, STEPS = 3, 12, 6


def _jax_greedy(tree, cfg, batch, steps):
    S_total = batch["tokens"].shape[1] + (
        batch["embeds"].shape[1] if "embeds" in batch else 0)
    logits, caches = jax.jit(functools.partial(
        jax_prefill, cfg=cfg, cache_len=S_total + steps))(tree, batch)
    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    out = [tok]
    step = jax.jit(functools.partial(jax_decode_step, cfg=cfg))
    for i in range(steps - 1):
        logits, caches = step(tree, tok, caches,
                              jnp.asarray(S_total + i, jnp.int32))
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        out.append(tok)
    return np.concatenate([np.asarray(t) for t in out], axis=1)


def test_serve_tokens_match_jax_greedy_loop():
    ref_cfg, cfg = ref_configs.get_smoke_config(ARCH), \
        configs.get_smoke_config(ARCH)
    tree = jax.tree.map(np.asarray, jax.jit(functools.partial(
        jax_init_params, cfg=ref_cfg))(jax.random.key(0)))
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg))
    out = serve.serve(cfg, batch=B, prompt_len=S, steps=STEPS, model=model,
                      seed=3)
    jbatch = {"tokens": jnp.asarray(out["batch"]["tokens"].numpy(),
                                    jnp.int32)}
    want = _jax_greedy(tree, ref_cfg, jbatch, STEPS)
    assert out["tokens"].shape == (B, STEPS)
    assert np.array_equal(out["tokens"].numpy(), want), \
        (out["tokens"], want)
    assert out["prefill_ms"] > 0 and out["decode_ms_per_step"] > 0
    caches = out["caches"]
    assert len(caches) == cfg.n_layers
    assert caches[0]["k"].shape == (B, S + STEPS, cfg.n_kv_heads, cfg.hd)


def test_make_batch_is_the_reference_launchers():
    """Prompts come from numpy's default_rng(seed) as in the JAX launcher:
    tokens first, then the patch frontend's embeddings, whose positions
    are cut from the text."""
    cfg = configs.get_smoke_config("internvl2-2b")
    batch = serve.make_batch(cfg, 2, 20, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, 20))
    embeds = rng.normal(size=(2, cfg.frontend_tokens, cfg.d_model)) * 0.02
    assert np.array_equal(batch["tokens"].numpy(),
                          tokens[:, cfg.frontend_tokens:])
    np.testing.assert_allclose(batch["embeds"].numpy(), embeds, rtol=1e-6)


def test_make_batch_draws_the_reference_launchers_frames():
    """An encoder–decoder model's frames come after the tokens, as the JAX
    launcher draws them: ``enc_len`` of them (``prompt_len`` unless
    given), none of them cut from the text."""
    cfg = configs.get_smoke_config("whisper-large-v3")
    for enc_len in (None, 30):
        batch = serve.make_batch(cfg, 2, 12, seed=4, device="cpu",
                                 enc_len=enc_len)
        rng = np.random.default_rng(4)
        tokens = rng.integers(0, cfg.vocab_size, (2, 12))
        frames = rng.normal(size=(2, enc_len or 12, cfg.d_model)) * 0.02
        assert sorted(batch) == ["enc_embeds", "tokens"]
        assert np.array_equal(batch["tokens"].numpy(), tokens)
        assert batch["enc_embeds"].dtype == torch.float32
        np.testing.assert_allclose(batch["enc_embeds"].numpy(), frames,
                                   rtol=1e-6)


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "internvl2-2b",
                                  "whisper-large-v3"])
def test_cli_serves_on_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "20", "--steps", "3",
                      "--seed", "1"])
    assert out["tokens"].shape == (2, 3)
    cfg = configs.get_smoke_config(arch)
    assert int(out["tokens"].max()) < cfg.padded_vocab
    assert "tokens/s" in capsys.readouterr().out
    if cfg.encoder_decoder:   # the encoder's 20 frames in the cross cache
        assert out["caches"][0]["cross_k"].shape == \
            (2, cfg.n_kv_heads, 20, cfg.hd)


def test_serve_defaults_to_the_card():
    cfg = configs.get_smoke_config(ARCH)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve(cfg, batch=1, prompt_len=4, steps=2)
