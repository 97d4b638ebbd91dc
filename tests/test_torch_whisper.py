"""The port's encoder–decoder family (whisper-large-v3's smoke config: 2
encoder and 2 decoder layers, d_model 64, f32) held against the JAX
package on the CPU, part by part: cross-attention against JAX
``attention(kv_override=...)`` with 8 queries (a prompt) and 1 (a decode
step), the encoder stack and its final norm against JAX
``_apply_groups(causal=False)`` and ``apply_norm``, and the cross k/v
that the prefill writes into the cache, which the port keeps head-major
(``[B, Hkv, S_enc, hd]``) and the JAX package as ``[B, S_enc, Hkv, hd]``.
A prefill on a given encoder output equals the prefill from the frame
embeddings, and the encoder run causally misses the reference by far
more than the tolerance.  The whole model (prefill, caches, decode
steps, greedy tokens) is held in ``tests/test_torch_models.py``.

Inputs are numpy draws from a seed; the JAX tree is ``init_params(
jax.random.key(0))`` carried over by ``params_from_jax``; every JAX
reference is computed once for the module.  On CPU tensors the layers'
flash attention op runs its plain version.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.configs.base import ATTN, DENSE_FFN, BlockSpec as RefBlockSpec
from repro.models import init_params as jax_init_params
from repro.models import layers as jax_layers
from repro.models import model as jax_model
from repro.models import prefill as jax_prefill

from repro_torch import configs
from repro_torch.models import Model, layers, params_from_jax

torch.set_num_threads(2)

ARCH = "whisper-large-v3"
#: f32 on both sides: sums in another order stay far inside 1e-4
ATOL = 1e-4
#: batch, text prompt, encoder frames (under JAX's 512-row attention
#: chunk, where it runs in one chunk)
B, S, S_ENC = 2, 12, 40
#: the layer whose cross-attention weights the layer tests use
LAYER = 1


def _np(t):
    return np.asarray(t, np.float32)


@pytest.fixture(scope="module")
def setup():
    """The JAX tree, the port's model on its weights, the inputs and every
    JAX reference of the module."""
    ref_cfg, cfg = ref_configs.get_smoke_config(ARCH), \
        configs.get_smoke_config(ARCH)
    tree = jax.tree.map(np.asarray, jax.jit(functools.partial(
        jax_init_params, cfg=ref_cfg))(jax.random.key(0)))
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg))
    rng = np.random.default_rng(11)
    inp = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
           "enc_embeds": _np(rng.normal(size=(B, S_ENC, cfg.d_model))
                             * 0.02),
           "x8": _np(rng.normal(size=(B, 8, cfg.d_model))),
           "x1": _np(rng.normal(size=(B, 1, cfg.d_model))),
           "enc": _np(rng.normal(size=(B, S_ENC, cfg.d_model)))}

    cross = {k: v[LAYER] for k, v in tree["groups"][0]["slot0"]["cross"]
             .items()}

    @jax.jit
    def cross_ref(x, enc):
        kv = jax_model._cross_kv(enc, cross, ref_cfg)
        return jax_layers.attention(x, cross, ref_cfg, kv_override=kv), kv

    @jax.jit
    def encoder_ref(enc_embeds):
        x = enc_embeds @ tree["frontend"]["proj"]
        pos = jnp.arange(x.shape[1])[None, :]
        groups = ((ref_cfg.enc_layers,
                   (RefBlockSpec(mixer=ATTN, ffn=DENSE_FFN),)),)
        x = jax_model._apply_groups(x, tree["enc"]["groups"], groups,
                                    ref_cfg, pos, causal=False, remat=False)
        return jax_layers.apply_norm(x, tree["enc"]["final_norm"], ref_cfg)

    ref = {f"cross{n}": cross_ref(inp[f"x{n}"], inp["enc"]) for n in (8, 1)}
    ref["encoder"] = _np(encoder_ref(inp["enc_embeds"]))
    jbatch = {"tokens": jnp.asarray(inp["tokens"], jnp.int32),
              "enc_embeds": jnp.asarray(inp["enc_embeds"])}
    _, caches = jax.jit(functools.partial(
        jax_prefill, cfg=ref_cfg, cache_len=S + 2))(tree, jbatch)
    ref["cross_k"] = _np(caches[0]["slot0"]["cross_k"])   # [L, B, S_enc..]
    ref["cross_v"] = _np(caches[0]["slot0"]["cross_v"])
    return {"cfg": cfg, "model": model, "inp": inp, "ref": ref}


def _close(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= ATOL, f"{what}: max abs err {err:.3g} > {ATOL}"


@pytest.mark.parametrize("sq", [8, 1])
def test_cross_attention_matches_jax(setup, sq):
    cfg, model, inp = setup["cfg"], setup["model"], setup["inp"]
    p = model.blocks[LAYER].cross.p
    k, v = layers.cross_kv(torch.from_numpy(inp["enc"]), p, cfg)
    assert k.shape == (B, cfg.n_kv_heads, S_ENC, cfg.hd) \
        and k.is_contiguous() and v.is_contiguous()
    y = layers.cross_attention(torch.from_numpy(inp[f"x{sq}"]), p, cfg, k, v)
    want, (wk, wv) = setup["ref"][f"cross{sq}"]
    _close(y, want, f"cross-attention, {sq} queries")
    _close(k.transpose(1, 2), wk, "cross k")
    _close(v.transpose(1, 2), wv, "cross v")


def test_encoder_matches_jax(setup):
    out = setup["model"].encode(
        torch.from_numpy(setup["inp"]["enc_embeds"]))
    _close(out, setup["ref"]["encoder"], "encoder output")


def _batch(inp):
    return {"tokens": torch.from_numpy(inp["tokens"]),
            "enc_embeds": torch.from_numpy(inp["enc_embeds"])}


def test_prefill_on_enc_out_equals_prefill_from_embeds(setup):
    model, batch = setup["model"], _batch(setup["inp"])
    logits, caches = model.prefill(batch, cache_len=S + 2)
    enc_out = model.encode(batch["enc_embeds"])
    logits2, caches2 = model.prefill({"tokens": batch["tokens"]},
                                     cache_len=S + 2, enc_out=enc_out)
    torch.testing.assert_close(logits2, logits, rtol=0, atol=0)
    for c, c2 in zip(caches, caches2):
        assert sorted(c) == sorted(c2) == ["cross_k", "cross_v", "k", "v"]
        for n in c:
            torch.testing.assert_close(c2[n], c[n], rtol=0, atol=0)


def test_cross_cache_matches_jax(setup):
    cfg, model = setup["cfg"], setup["model"]
    _, caches = model.prefill(_batch(setup["inp"]), cache_len=S + 2)
    for layer, c in enumerate(caches):
        for n in ("cross_k", "cross_v"):
            assert c[n].shape == (B, cfg.n_kv_heads, S_ENC, cfg.hd) \
                and c[n].is_contiguous(), (layer, n, c[n].shape)
            _close(c[n].permute(0, 2, 1, 3), setup["ref"][n][layer],
                   f"layer {layer} {n}")


def test_causal_encoder_misses_the_reference(setup, monkeypatch):
    """The encoder's attention run causally (a mask error) moves its
    output by more than 0.1: the tolerance sees it."""
    flash = layers.flash_attention
    monkeypatch.setattr(layers, "flash_attention",
                        lambda q, k, v, causal, window:
                        flash(q, k, v, True, window))
    out = setup["model"].encode(
        torch.from_numpy(setup["inp"]["enc_embeds"])).numpy()
    err = float(np.max(np.abs(out - setup["ref"]["encoder"])))
    assert err > 0.1, err
