"""The port's model stack (``repro_torch.models``) held against the JAX
package's (``repro.models``) on the CPU.

Each case builds the JAX smoke model with ``init_params(jax.random.key(0),
cfg)`` in f32, carries its weights into the port through
``params_from_jax``, feeds both the same prompt (numpy, from a seed) and
holds the prefill's logits and caches, then three decode steps' logits
(both packages fed the JAX greedy tokens), to 1e-4 absolute; the port's
own greedy tokens must be the JAX ones.  On CPU tensors the layers' flash
attention, grouped-matmul, RG-LRU scan and mLSTM chunk ops run their plain
versions.  The cases cover a dense model (llama3.2-3b), the MoE with both
dispatches (granite-moe-3b-a800m, ``moe_impl`` global and grouped),
sliding-window attention with a prompt past its window, so that the ring
cache rolls (h2o-danube-3-4b, window 16, 24 tokens), the patch frontend
(internvl2-2b), RG-LRU blocks beside local attention past its window
(recurrentgemma-2b, 24 tokens), the mLSTM and sLSTM blocks (xlstm-125m,
the per-step mLSTM and the chunked one in 3 chunks of 8) and the
encoder–decoder family (whisper-large-v3: an encoder over 20 frames,
cross-attention in the prefill and every decode step).  mLSTM states
are compared as ``C·e^{m}`` and ``n·e^{m}``: the chunked form keeps them
in another scaling (``repro_torch.models.layers.mlstm_chunked``); the
port's cross k/v (``[B, Hkv, S_enc, hd]``) as the JAX package's
``[B, S_enc, Hkv, hd]``, through a permute.  The
JAX references are computed once per case (module-scoped fixture), from
one JAX tree per architecture.  The recurrent layers alone, from a
non-zero state, are in ``tests/test_torch_recurrent.py``; the encoder and
cross-attention alone in ``tests/test_torch_whisper.py``.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.configs import base as ref_base
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.models import registry as ref_registry

from repro_torch import configs
from repro_torch.configs import base
from repro_torch.models import (Model, active_param_count, param_count,
                                params_from_jax)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
#: f32 on both sides: sums in another order stay far inside 1e-4
ATOL = 1e-4
B, DECODE_STEPS = 2, 3
#: an encoder–decoder prompt's frames (another length than its text)
ENC_LEN = 20
#: (arch, config overrides, prompt length including frontend tokens)
CASES = [("llama3.2-3b", {}, 16),
         ("granite-moe-3b-a800m", {"moe_impl": "global"}, 16),
         ("granite-moe-3b-a800m", {"moe_impl": "grouped"}, 16),
         ("h2o-danube-3-4b", {}, 24),
         ("internvl2-2b", {}, 16),
         ("recurrentgemma-2b", {}, 24),
         ("xlstm-125m", {"mlstm_impl": "scan"}, 16),
         ("xlstm-125m", {"mlstm_impl": "chunked", "mlstm_chunk": 8}, 24),
         ("whisper-large-v3", {}, 16)]
IDS = ["-".join([a, *map(str, over.values())]) for a, over, _ in CASES]
#: the architectures whose block kinds are all in the slice
IN_SLICE = ("llama3.2-3b", "granite-moe-3b-a800m", "glm4-9b",
            "h2o-danube-3-4b", "internvl2-2b", "mixtral-8x22b",
            "llama3-405b", "recurrentgemma-2b", "xlstm-125m",
            "whisper-large-v3")


def _cfgs(arch, over):
    return (dataclasses.replace(ref_configs.get_smoke_config(arch), **over),
            dataclasses.replace(configs.get_smoke_config(arch), **over))


def _prompt(cfg, S):
    rng = np.random.default_rng(7)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.encoder_decoder:
        out["enc_embeds"] = (rng.normal(size=(B, ENC_LEN, cfg.d_model))
                             * 0.02).astype(np.float32)
    if cfg.frontend == "patch":
        out["embeds"] = (rng.normal(size=(B, cfg.frontend_tokens,
                                          cfg.d_model)) * 0.02
                         ).astype(np.float32)
        out["tokens"] = out["tokens"][:, cfg.frontend_tokens:]
    return out


def _comparable(cache):
    """A layer's cache as compared: mLSTM states as ``C·e^{m}`` and
    ``n·e^{m}`` (the scaling-free state), the others as they are."""
    if "C" not in cache:
        return cache
    w = np.exp(np.asarray(cache["m"], np.float64))
    return {"C": cache["C"] * w[..., None, None],
            "n": cache["n"] * w[..., None]}


def _port_cache(cache):
    """A layer's cache of the port (torch) as compared: numpy copies, the
    cross k/v permuted to the JAX package's ``[B, S_enc, Hkv, hd]``."""
    return _comparable({n: (t.permute(0, 2, 1, 3) if n.startswith("cross_")
                            else t).numpy().copy()
                        for n, t in cache.items()})


def _flat_caches(caches, cfg):
    """The JAX grouped cache tree as one dict per layer (numpy), each
    kind's keys."""
    out = []
    for (repeat, body), group in zip(cfg.layer_groups, caches):
        for r in range(repeat):
            for i in range(len(body)):
                slot = group[f"slot{i}"]
                out.append(_comparable({n: np.asarray(slot[n][r])
                                        for n in slot}))
    return out


@pytest.fixture(scope="module")
def jax_trees():
    """JAX's init_params(key(0)) of each smoke config, as numpy, made once
    per architecture (both MoE dispatches share one tree)."""
    trees = {}

    def get(arch, ref_cfg):
        if arch not in trees:
            init = jax.jit(functools.partial(jax_init_params, cfg=ref_cfg))
            trees[arch] = jax.tree.map(np.asarray, init(jax.random.key(0)))
        return trees[arch]
    return get


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request, jax_trees):
    """The JAX reference of one case, and the port's run on its weights."""
    arch, over, S = request.param
    ref_cfg, cfg = _cfgs(arch, over)
    tree = jax_trees(arch, ref_cfg)
    prompt = _prompt(cfg, S)
    cache_len = S + DECODE_STEPS + 1
    jbatch = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
              for k, v in prompt.items()}
    logits, caches = jax.jit(functools.partial(
        jax_prefill, cfg=ref_cfg, cache_len=cache_len))(tree, jbatch)
    ref = {"prefill": np.asarray(logits),
           "caches": _flat_caches(caches, ref_cfg), "steps": []}
    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
    ref["tokens"] = [np.asarray(tok)]
    step = jax.jit(functools.partial(jax_decode_step, cfg=ref_cfg))
    for i in range(DECODE_STEPS):
        logits, caches = step(tree, tok, caches,
                              jnp.asarray(S + i, jnp.int32))
        ref["steps"].append(np.asarray(logits))
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        ref["tokens"].append(np.asarray(tok))
    ref["decode_caches"] = _flat_caches(caches, ref_cfg)

    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg))
    batch = {k: torch.from_numpy(v) for k, v in prompt.items()}
    logits, tcaches = model.prefill(batch, cache_len=cache_len)
    got = {"prefill": logits.numpy(),
           "caches": [_port_cache(c) for c in tcaches],
           "steps": [], "tokens": [logits[:, -1].argmax(-1)[:, None].numpy()]}
    for i in range(DECODE_STEPS):
        # both packages take the JAX greedy token of the step before
        tok = torch.tensor(ref["tokens"][i], dtype=torch.long)
        logits, tcaches = model.decode_step(tok, tcaches, S + i)
        got["steps"].append(logits.numpy())
        got["tokens"].append(logits[:, -1].argmax(-1)[:, None].numpy())
    got["decode_caches"] = [_port_cache(c) for c in tcaches]
    return {"cfg": cfg, "ref": ref, "got": got, "S": S}


def _close(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= ATOL, f"{what}: max abs err {err:.3g} > {ATOL}"


def test_prefill_logits_match_jax(case):
    assert case["got"]["prefill"].shape == \
        (B, 1, case["cfg"].padded_vocab)
    _close(case["got"]["prefill"], case["ref"]["prefill"], "prefill logits")


def test_prefill_caches_match_jax(case):
    got, want = case["got"]["caches"], case["ref"]["caches"]
    assert len(got) == len(want) == case["cfg"].n_layers
    for layer, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), (layer, sorted(g), sorted(w))
        for n in w:
            _close(g[n], w[n], f"layer {layer} cache {n}")


def test_decode_logits_and_caches_match_jax(case):
    for i, (g, w) in enumerate(zip(case["got"]["steps"],
                                   case["ref"]["steps"])):
        _close(g, w, f"decode step {i} logits")
    for layer, (g, w) in enumerate(zip(case["got"]["decode_caches"],
                                       case["ref"]["decode_caches"])):
        assert sorted(g) == sorted(w), (layer, sorted(g), sorted(w))
        for n in w:
            _close(g[n], w[n], f"layer {layer} cache {n} after decode")


def test_greedy_tokens_match_jax(case):
    for i, (g, w) in enumerate(zip(case["got"]["tokens"],
                                   case["ref"]["tokens"])):
        assert np.array_equal(g, w), f"step {i}: {g} != {w}"


def test_windowed_cache_is_a_ring():
    """h2o-danube's prompt of 24 tokens passes its window of 16: the
    cache keeps 16 slots and position p sits in slot p % 16."""
    cfg = configs.get_smoke_config("h2o-danube-3-4b")
    model = Model(cfg, generator=torch.Generator().manual_seed(0),
                  device="cpu")
    S = 24
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, S)))
    _, caches = model.prefill({"tokens": tokens}, cache_len=S + 4)
    _, full = model.prefill({"tokens": tokens}, cache_len=None)
    # the same model with no window keeps every position in order
    nowin = Model(dataclasses.replace(cfg, window=None), device="cpu")
    nowin.load_state_dict(model.state_dict())
    _, flat = nowin.prefill({"tokens": tokens}, cache_len=S)
    assert caches[0]["k"].shape[1] == cfg.window
    for p in range(S - cfg.window, S):
        torch.testing.assert_close(caches[0]["k"][:, p % cfg.window],
                                   flat[0]["k"][:, p], rtol=0, atol=0)
    assert full[0]["k"].shape[1] == cfg.window


@pytest.mark.parametrize("arch", IN_SLICE)
def test_param_counts_match_reference(arch):
    ref_cfg, cfg = ref_configs.get_config(arch), configs.get_config(arch)
    assert param_count(cfg) == ref_registry.param_count(ref_cfg)
    assert active_param_count(cfg) == ref_registry.active_param_count(
        ref_cfg)


def test_configs_equal_reference():
    assert configs.list_archs() == ref_configs.list_archs()
    for arch in ref_configs.list_archs():
        for get in ("get_config", "get_smoke_config", "get_optimized_config",
                    "get_optimized_smoke_config"):
            ref_cfg = getattr(ref_configs, get)(arch)
            cfg = getattr(configs, get)(arch)
            assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
            assert cfg.param_count() == ref_cfg.param_count()
            assert cfg.active_param_count() == ref_cfg.active_param_count()
            assert cfg.padded_vocab == ref_cfg.padded_vocab
            for shape in ref_base.SHAPES.values():
                assert base.shape_applicable(cfg, base.SHAPES[shape.name]) \
                    == ref_base.shape_applicable(ref_cfg, shape)
                assert base.default_parallel(cfg, base.SHAPES[shape.name]) \
                    .__dict__ == ref_base.default_parallel(
                        ref_cfg, shape).__dict__
    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_base.SHAPES.items()}
    assert configs.OPTIMIZED_PROFILE == ref_configs.OPTIMIZED_PROFILE


def test_model_defaults_to_the_card():
    """With no device the model asks for cuda:0, and raises without one."""
    cfg = configs.get_smoke_config("llama3.2-3b")
    if torch.cuda.is_available():
        assert Model(cfg).device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Model(cfg)


def test_new_packages_import_no_jax():
    """configs, models (the recurrent layers and the kernel ops they
    call among them) and launch import neither jax nor the JAX package."""
    code = ("import sys; import repro_torch.configs, repro_torch.models, "
            "repro_torch.launch.serve; from repro_torch.models.layers "
            "import rglru, mlstm, mlstm_chunked, slstm, rglru_scan, "
            "mlstm_chunk; bad = [m for m in sys.modules if "
            "m.split('.')[0] in ('jax', 'repro')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


#: bf16 router logits that tie across the top-k boundary (granite's smoke
#: MoE: 8 experts, top 4); torch.topk ranks such ties otherwise than
#: lax.top_k, which takes the lower index first
TIED_LOGITS = [[1, 2, 2, 2, 0.5, 0, 0, 0], [2, 2, 2, 2, 2, 2, 1, 0],
               [0, 3, 1, 3, 1, 3, 1, 3], [1, 1, 1, 1, 1, 1, 1, 1]]
#: bf16 MoE outputs near 0.1: the expert products and the combine round
#: within two bf16 steps of the reference's
TIE_ATOL = 4e-3


@pytest.mark.parametrize("impl", ["global", "grouped"])
def test_moe_routing_ranks_tied_logits_as_lax_top_k(impl):
    """Tokens whose bf16 router logits are the rows of ``TIED_LOGITS``
    (one-hot inputs pick a row of the router): the port's experts are
    ``lax.top_k``'s, through ``layers.topk``, the dispatch and
    ``moe_aux_loss``, each held against the JAX layer on the same bf16
    inputs; with ``torch.topk`` in its place both fall outside."""
    from repro.models import layers as ref_layers
    from repro_torch.models import layers
    ref_cfg, cfg = _cfgs("granite-moe-3b-a800m", {"moe_impl": impl})
    E, K, D = cfg.moe.n_experts, cfg.moe.top_k, cfg.d_model
    tied = np.asarray(TIED_LOGITS, np.float32)
    rng = np.random.default_rng(0)
    p = {"router": np.zeros((D, E), np.float32)}
    p["router"][:len(tied)] = tied
    f = cfg.moe.d_ff_expert
    for name, shape in (("wg", (E, D, f)), ("wu", (E, D, f)),
                        ("wd", (E, f, D))):
        p[name] = (rng.normal(size=shape) * 0.3).astype(np.float32)
    x = np.zeros((B, 8, D), np.float32)
    rows = rng.integers(0, len(tied), (B, 8))
    x[np.arange(B)[:, None], np.arange(8)[None], rows] = 1.0
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p.items()}
    tp = {k: torch.from_numpy(v).bfloat16() for k, v in p.items()}
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()

    want_idx = np.asarray(jax.lax.top_k(jnp.asarray(tied), K)[1])
    np.testing.assert_array_equal(
        layers.topk(torch.from_numpy(tied), K)[1].numpy(), want_idx)
    want = np.asarray(ref_layers.moe_ffn(jx, jp, ref_cfg)
                      .astype(jnp.float32))
    want_aux = float(ref_layers.moe_aux_loss(jx, jp, ref_cfg))

    def run():
        return (layers.moe_ffn(tx, tp, cfg).float().numpy(),
                float(layers.moe_aux_loss(tx, tp, cfg)))

    got, got_aux = run()
    assert np.abs(got - want).max() <= TIE_ATOL
    assert got_aux == pytest.approx(want_aux, rel=1e-6)
    real = layers.topk
    layers.topk = lambda logits, k: torch.topk(logits, k, dim=-1)
    try:
        assert not np.array_equal(
            layers.topk(torch.from_numpy(tied), K)[1].numpy(), want_idx)
        bad, bad_aux = run()
    finally:
        layers.topk = real
    assert np.abs(bad - want).max() > TIE_ATOL
    assert bad_aux != pytest.approx(want_aux, rel=1e-6)
