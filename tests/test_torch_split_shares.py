"""The split over a mesh, in one process on the CPU with no process group
(``repro_torch.parallel.shares``: the layers' own mesh code run for every
rank of a simulated mesh, whose collectives exchange tensors in memory),
against the one-device layers, and those against the JAX package.

* The MoE: granite's smoke model with 5 experts (``model`` 2 does not
  divide them: expert-TP, and the reference's ``moe_buf`` rule splits the
  capacity over ``data``) and with its 8 (EP, the capacity whole): the
  global dispatch's shares over ``(data, model)`` meshes, each data rank's
  own tokens combined from the gathered capacity slices, and the grouped
  dispatch's, each data rank's rows on their own; within ``SHARE_ATOL``
  of the one-device layer.
* The mLSTM, per step and chunked, and the sLSTM: xlstm-125m's smoke
  model split by heads (4 heads over 2 and 4 ranks) and, with 2 heads,
  each head over 2 or 4 ranks (the mLSTM's value columns in blocks, the
  sLSTM's head repeated), from a state that a prefix left: the summed
  partial outputs and the states assembled from their layouts within
  ``SHARE_ATOL`` of the one-device layer.
* The head under ``ParallelCfg.shard_logits=False``: the logits gathered
  whole over ``model`` on every rank, equal to the one-device logits,
  with the split run's loss and greedy tokens.
* The one-device layers (``moe_ffn_global``, ``moe_ffn_grouped``,
  ``moe_aux_loss``, ``_mlstm_scan``, ``mlstm_chunked``, ``slstm``) against
  the JAX package's, from the same numpy-seeded weights carried into the
  JAX tree by ``repro_torch.models.convert.params_to_jax``, at
  ``tests/test_torch_models.py``'s 1e-4.

On CPU tensors the kernels run their plain versions; ``chip_smoke.py``
phase 13 runs the same simulated ranks on the card, on the kernels.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import layers as ref_layers

from repro_torch import configs
from repro_torch.configs.base import MLSTM, SLSTM
from repro_torch.models import Model, layers
from repro_torch.models.convert import params_to_jax
from repro_torch.parallel import shares

torch.set_num_threads(2)

#: the JAX comparison's bar (tests/test_torch_models.py)
ATOL = 1e-4
#: the assembled shares against the one-device layer, f32: 10x the largest
#: difference measured (3.6e-7, outputs up to 1.8: partial products summed
#: over model, and products over fewer columns on the CPU)
SHARE_ATOL = 4e-6
B, S = 4, 16


def _cfgs(arch, **over):
    ref = ref_configs.get_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    if "n_experts" in over:
        n = over.pop("n_experts")
        over["moe"] = dataclasses.replace(cfg.moe, n_experts=n)
    return dataclasses.replace(ref, **over), dataclasses.replace(cfg, **over)


def _weights(cfg, seed=0):
    """Every parameter of ``cfg``'s model drawn from a numpy seed (normal,
    scaled by the fan-in); (the port's state_dict, the JAX tree of the same
    values through ``params_to_jax``)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, p in Model(cfg, device="meta").named_parameters():
        fan = p.shape[-2] if p.dim() > 1 else 1
        sd[name] = torch.from_numpy(
            (rng.normal(size=tuple(p.shape)) / np.sqrt(fan))
            .astype(np.float32))
    return sd, params_to_jax(sd, cfg)


def _layer(sd, tree, layer: int, slot: int, part: str):
    """Layer ``layer``'s ``part`` (``mixer``, ``ffn``): the port's tensors
    and the JAX tree's (group 0, ``slot``, repeat 0)."""
    prefix = f"blocks.{layer}.{part}."
    tp = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    jp = {k: jnp.asarray(v[0].numpy())
          for k, v in tree["groups"][0][f"slot{slot}"][part].items()}
    return tp, jp


def _x(D, seed=1, n=S):
    return np.random.default_rng(seed).normal(size=(B, n, D)) \
        .astype(np.float32)


def _err(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))))


@pytest.mark.parametrize("impl", ["global", "grouped"])
def test_moe_one_device_matches_jax(impl):
    ref_cfg, cfg = _cfgs("granite-moe-3b-a800m", moe_impl=impl, n_experts=5)
    sd, tree = _weights(cfg)
    tp, jp = _layer(sd, tree, 0, 0, "ffn")
    x = _x(cfg.d_model)
    ref = ref_layers._moe_ffn_global if impl == "global" else \
        ref_layers.moe_ffn_grouped
    want = ref(jnp.asarray(x), jp, ref_cfg)
    fn = layers.moe_ffn_global if impl == "global" else layers.moe_ffn_grouped
    assert _err(fn(torch.from_numpy(x), tp, cfg), want) <= ATOL
    assert float(layers.moe_aux_loss(torch.from_numpy(x), tp, cfg)) == \
        pytest.approx(float(ref_layers.moe_aux_loss(jnp.asarray(x), jp,
                                                    ref_cfg)), rel=1e-6)


#: (impl, experts, (data, model), the capacity split the rule gives)
MOE_MESHES = (("global", 5, (2, 2), 2), ("global", 5, (4, 2), 4),
              ("global", 5, (2, 4), 2), ("global", 5, (4, 1), 1),
              ("global", 8, (2, 2), 1), ("grouped", 5, (2, 2), 1),
              ("grouped", 8, (2, 4), 1), ("grouped", 5, (4, 1), 1))


@pytest.mark.parametrize("impl,E,mesh,n_c", MOE_MESHES,
                         ids=[f"{i}-E{e}-{m[0]}x{m[1]}"
                              for i, e, m, _ in MOE_MESHES])
def test_moe_shares_assemble_to_one_device(impl, E, mesh, n_c):
    _, cfg = _cfgs("granite-moe-3b-a800m", moe_impl=impl, n_experts=E)
    sd, _ = _weights(cfg)
    tp = {k[len("blocks.0.ffn."):]: v for k, v in sd.items()
          if k.startswith("blocks.0.ffn.")}
    x = torch.from_numpy(_x(cfg.d_model))
    rules = shares.rules_for(cfg, *mesh)
    if impl == "global":
        want = layers.moe_ffn_global(x, tp, cfg)
        got, info = shares.moe_global(x, tp, cfg, rules)
        assert info["n_capacity"] == n_c and info["ep"] == (E % mesh[1] == 0)
    else:
        want = layers.moe_ffn_grouped(x, tp, cfg)
        got = shares.moe_grouped(x, tp, cfg, rules)
    assert got.shape == want.shape
    assert _err(got, want) <= SHARE_ATOL


def test_capacity_slices_take_their_offset():
    """Every capacity slice filled as the first (its rows and counts not
    offset) is caught by the comparison above."""
    _, cfg = _cfgs("granite-moe-3b-a800m", n_experts=5)
    sd, _ = _weights(cfg)
    tp = {k[len("blocks.0.ffn."):]: v for k, v in sd.items()
          if k.startswith("blocks.0.ffn.")}
    x = torch.from_numpy(_x(cfg.d_model))
    want = layers.moe_ffn_global(x, tp, cfg)
    real = layers._dispatch
    layers._dispatch = lambda x, r, K, e0, El, c0, Cl: real(
        x, r, K, e0, El, 0, Cl)
    try:
        got, _ = shares.moe_global(x, tp, cfg, shares.rules_for(cfg, 2, 2))
    finally:
        layers._dispatch = real
    assert _err(got, want) > 100 * SHARE_ATOL


def test_a_failing_rank_reaches_the_caller(monkeypatch):
    """An error on one simulated rank is raised to the caller, and the
    ranks waiting for it in a collective are released, not left hanging."""
    _, cfg = _cfgs("granite-moe-3b-a800m", n_experts=5)
    sd, _ = _weights(cfg)
    tp = {k[len("blocks.0.ffn."):]: v for k, v in sd.items()
          if k.startswith("blocks.0.ffn.")}
    real = layers.moe_capacity_share

    def share(xf, r, p, cfg, C, c=0, n_c=1, e0=0):
        if c == 1:
            raise ZeroDivisionError("planted")
        return real(xf, r, p, cfg, C, c, n_c, e0)
    monkeypatch.setattr(layers, "moe_capacity_share", share)
    with pytest.raises(ZeroDivisionError, match="planted"):
        shares.moe_global(torch.from_numpy(_x(cfg.d_model)), tp, cfg,
                          shares.rules_for(cfg, 2, 2))


#: (mixer, form, heads, ranks)
MIXERS = ((MLSTM, "scan", 4, 2), (MLSTM, "scan", 4, 4),
          (MLSTM, "scan", 2, 4), (MLSTM, "chunked", 4, 4),
          (MLSTM, "chunked", 2, 4), (MLSTM, "chunked", 2, 8),
          (SLSTM, "scan", 4, 2), (SLSTM, "scan", 4, 4),
          (SLSTM, "scan", 2, 4))
CHUNK = 8


def _mixer_fn(kind, form):
    if kind == SLSTM:
        return layers.slstm, ref_layers.slstm
    if form == "chunked":
        return (lambda x, p, cfg, st=None: layers.mlstm_chunked(
                    x, p, cfg, st, chunk=CHUNK),
                lambda x, p, cfg, st=None: ref_layers.mlstm_chunked(
                    x, p, cfg, st, chunk=CHUNK))
    return layers._mlstm_scan, ref_layers._mlstm_scan


def _mixer_case(kind, H):
    ref_cfg, cfg = _cfgs("xlstm-125m", n_heads=H, n_kv_heads=H)
    sd, tree = _weights(cfg)
    return ref_cfg, cfg, *_layer(sd, tree, 0 if kind == MLSTM else 1,
                                 0 if kind == MLSTM else 1, "mixer")


def _scaled(st):
    """An mLSTM state without its scaling (``C·e^{m}``, ``n·e^{m}``)."""
    w = torch.exp(st["m"].double())
    return {"C": st["C"] * w[..., None, None], "n": st["n"] * w[..., None]}


@pytest.mark.parametrize("kind,form", [(MLSTM, "scan"), (MLSTM, "chunked"),
                                       (SLSTM, "scan")])
def test_mixer_one_device_matches_jax(kind, form):
    ref_cfg, cfg, tp, jp = _mixer_case(kind, 4)
    port, ref = _mixer_fn(kind, form)
    x = _x(cfg.d_model)
    y, st = port(torch.from_numpy(x), tp, cfg)
    y_ref, st_ref = jax.jit(lambda x, p: ref(x, p, ref_cfg))(
        jnp.asarray(x), jp)
    assert _err(y, y_ref) <= ATOL
    st_ref = {k: torch.from_numpy(np.array(v)) for k, v in st_ref.items()}
    if kind == MLSTM:
        st, st_ref = _scaled(st), _scaled(st_ref)
    for k, v in st_ref.items():
        assert _err(st[k], v) <= ATOL, k


@pytest.mark.parametrize("kind,form,H,n", MIXERS,
                         ids=[f"{k}-{f}-{h}heads-{n}ranks"
                              for k, f, h, n in MIXERS])
def test_mixer_shares_assemble_to_one_device(kind, form, H, n):
    """From the state a prefix of 8 steps left (the decode's continuation),
    the shares' summed outputs and assembled states equal the one-device
    layer's."""
    _, cfg, tp, _ = _mixer_case(kind, H)
    port, _ = _mixer_fn(kind, form)
    x = torch.from_numpy(_x(cfg.d_model))
    _, state = port(torch.from_numpy(_x(cfg.d_model, seed=2, n=8)), tp, cfg)
    want, want_st = port(x, tp, cfg, state)
    kw = {"chunk": CHUNK} if form == "chunked" else {}
    got, got_st = shares.mixer(kind, x, tp, cfg, n, state, form, **kw)
    assert _err(got, want) <= SHARE_ATOL
    assert sorted(got_st) == sorted(want_st)
    for k, v in want_st.items():
        assert got_st[k].shape == v.shape, k
        assert _err(got_st[k], v) <= SHARE_ATOL * max(1.0, float(
            v.abs().max())), k


@pytest.mark.parametrize("n", [2, 4])
def test_whole_logits_without_shard_logits(n):
    """``ParallelCfg.shard_logits=False`` (the reference's whole-logits
    constraint): the head's vocab columns split over ``n`` ``model``
    ranks, every rank's logits are the one-device logits, whole, and its
    loss and greedy tokens those of the split run (vocab-parallel
    cross-entropy and greedy pick)."""
    _, cfg = _cfgs("llama3.2-3b")
    rng = np.random.default_rng(4)
    V = cfg.padded_vocab
    x = torch.from_numpy(_x(cfg.d_model))
    w = torch.from_numpy((rng.normal(size=(cfg.d_model, V))
                          / np.sqrt(cfg.d_model)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    one = x @ w
    whole = shares.lm_head(x, w, labels, cfg, n, shard_logits=False)
    split = shares.lm_head(x, w, labels, cfg, n, shard_logits=True)
    for (logits, nll, pick), (s_logits, s_nll, s_pick) in zip(whole, split):
        assert logits.shape == (B, S, V) and s_logits.shape == (B, S, V // n)
        assert torch.equal(logits, one)
        assert _err(nll, s_nll) <= SHARE_ATOL
        assert torch.equal(pick, s_pick)
        assert torch.equal(pick, one[:, -1].argmax(-1))
