"""The port's recurrent mixers (``repro_torch.models.layers``: RG-LRU,
mLSTM in both forms, sLSTM) held against the JAX package's
(``repro.models.layers``) on the CPU, from a non-zero state, so that the
decode's continuation is covered.

Weights come from the JAX inits (``init_rglru`` and friends, key 0) of the
smoke configs in f32; inputs from numpy seeds.  The RG-LRU state is drawn
at random (``h`` f32, the conv's carried tail); the mLSTM and sLSTM states
are what the JAX layer leaves after a prefix of 8 steps, so that their
running maxima ``m`` are the layer's own.  Outputs and states must agree
to 1e-4 absolute; mLSTM states are compared as ``C·e^{m}`` and
``n·e^{m}``, since the chunked form returns them in another scaling.  On
CPU tensors the RG-LRU scan and mLSTM chunk ops run their plain versions.
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
from repro_torch.models import layers

torch.set_num_threads(2)

ATOL = 1e-4
B = 2


def _cfgs(arch, **over):
    return (dataclasses.replace(ref_configs.get_smoke_config(arch), **over),
            dataclasses.replace(configs.get_smoke_config(arch), **over))


def _params(init, ref_cfg):
    p = init(jax.random.key(0), ref_cfg, jnp.float32)
    return p, {n: torch.from_numpy(np.array(v)) for n, v in p.items()}


def _ref(fn, ref_cfg):
    """The JAX layer ``fn`` of ``ref_cfg``, jitted: ``(x, p, state)``."""
    return jax.jit(lambda x, p, state=None: fn(x, p, ref_cfg, state))


def _x(S, D, seed):
    return np.random.default_rng(seed).normal(size=(B, S, D)) \
        .astype(np.float32)


def _torch_state(state):
    return {n: torch.from_numpy(np.array(v)) for n, v in state.items()}


def _close(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= ATOL, f"{what}: max abs err {err:.3g} > {ATOL}"


def _scaled(state):
    """An mLSTM state without its scaling: ``C·e^{m}``, ``n·e^{m}``."""
    w = np.exp(np.asarray(state["m"], np.float64))
    return {"C": np.asarray(state["C"]) * w[..., None, None],
            "n": np.asarray(state["n"]) * w[..., None]}


@pytest.mark.parametrize("S,with_state", [(1, True), (2, True), (12, True),
                                          (12, False)])
def test_rglru_matches_jax(S, with_state):
    """S = 1 is the decode step (``h0`` the state's), S = 2 < cw - 1 takes
    part of the carried conv tail into the new one."""
    ref_cfg, cfg = _cfgs("recurrentgemma-2b")
    jp, tp = _params(ref_layers.init_rglru, ref_cfg)
    dr, cw = cfg.d_rnn, cfg.conv_width
    x = _x(S, cfg.d_model, 1)
    rng = np.random.default_rng(2)
    state = {"h": rng.normal(size=(B, dr)).astype(np.float32),
             "conv": rng.normal(size=(B, cw - 1, dr)).astype(np.float32)} \
        if with_state else None
    y_ref, st_ref = _ref(ref_layers.rglru, ref_cfg)(
        jnp.asarray(x), jp,
        None if state is None else {n: jnp.asarray(v)
                                    for n, v in state.items()})
    y, st = layers.rglru(torch.from_numpy(x), tp, cfg,
                         None if state is None else _torch_state(state))
    _close(y, y_ref, "y")
    assert st["h"].dtype == torch.float32
    for n in ("h", "conv"):
        _close(st[n], st_ref[n], n)


def _mlstm_prefix(jp, ref_cfg):
    """The JAX layer's state after 8 steps of its own."""
    _, st = _ref(ref_layers._mlstm_scan, ref_cfg)(
        jnp.asarray(_x(8, ref_cfg.d_model, 3)), jp)
    return st


@pytest.mark.parametrize("impl,S", [("scan", 1), ("scan", 8),
                                    ("chunked", 8), ("chunked", 16)])
def test_mlstm_matches_jax_from_a_state(impl, S):
    """Both forms continue from the JAX layer's state; the chunked one in
    chunks of 4 (the kernel's plain version on CPU tensors)."""
    ref_cfg, cfg = _cfgs("xlstm-125m", mlstm_impl=impl, mlstm_chunk=4)
    jp, tp = _params(ref_layers.init_mlstm, ref_cfg)
    state = _mlstm_prefix(jp, ref_cfg)
    x = _x(S, cfg.d_model, 4)
    y_ref, st_ref = _ref(ref_layers.mlstm, ref_cfg)(jnp.asarray(x), jp,
                                                    state)
    y, st = layers.mlstm(torch.from_numpy(x), tp, cfg,
                         _torch_state(state))
    _close(y, y_ref, "y")
    want, got = _scaled(st_ref), _scaled({n: t.numpy()
                                          for n, t in st.items()})
    for n in ("C", "n"):
        _close(got[n], want[n], f"{n}·e^m")
    if impl == "chunked" and S > 1:
        assert not st["m"].any()      # the unscaled state: m = 0


def test_mlstm_chunked_state_continues_per_step():
    """The chunked prefill's state (m = 0) fed to the per-step decode
    gives the JAX decode's output from the JAX chunked state."""
    ref_cfg, cfg = _cfgs("xlstm-125m", mlstm_impl="chunked", mlstm_chunk=4)
    jp, tp = _params(ref_layers.init_mlstm, ref_cfg)
    x, x1 = _x(12, cfg.d_model, 5), _x(1, cfg.d_model, 6)
    ref = _ref(ref_layers.mlstm, ref_cfg)
    _, st_ref = ref(jnp.asarray(x), jp)
    y_ref, _ = ref(jnp.asarray(x1), jp, st_ref)
    _, st = layers.mlstm(torch.from_numpy(x), tp, cfg)
    y, _ = layers.mlstm(torch.from_numpy(x1), tp, cfg, st)
    _close(y, y_ref, "decode y")


def test_mlstm_chunked_takes_whole_chunks():
    """As the JAX package asserts, the chunked form takes a sequence of
    whole chunks; the ones column widens v to a multiple of 4."""
    _, cfg = _cfgs("xlstm-125m", mlstm_impl="chunked", mlstm_chunk=4)
    p = layers.init_mlstm(cfg, torch.float32, torch.device("cpu"),
                          torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="chunk"):
        layers.mlstm(torch.zeros((1, 6, cfg.d_model)), p, cfg)
    assert [layers._ones_width(hd) for hd in (32, 383, 384)] == \
        [36, 384, 388]


@pytest.mark.parametrize("S", [1, 8])
def test_slstm_matches_jax_from_a_state(S):
    ref_cfg, cfg = _cfgs("xlstm-125m")
    jp, tp = _params(ref_layers.init_slstm, ref_cfg)
    ref = _ref(ref_layers.slstm, ref_cfg)
    _, state = ref(jnp.asarray(_x(8, cfg.d_model, 7)), jp)
    x = _x(S, cfg.d_model, 8)
    y_ref, st_ref = ref(jnp.asarray(x), jp, state)
    y, st = layers.slstm(torch.from_numpy(x), tp, cfg, _torch_state(state))
    _close(y, y_ref, "y")
    for n in ("c", "n", "h", "m"):
        _close(st[n], st_ref[n], n)


def test_mlstm_chunked_normalizer_matches_jax(monkeypatch):
    """With q and k 8 times larger, |q·n| passes 1, so that the
    normalizer's column of ones decides the output (at the init's scale
    the clamp at 1 holds everywhere and hides it)."""
    ref_cfg, cfg = _cfgs("xlstm-125m", mlstm_impl="chunked", mlstm_chunk=4)
    jp, tp = _params(ref_layers.init_mlstm, ref_cfg)
    de = 2 * cfg.d_model
    jp = dict(jp, w_qkv=jp["w_qkv"].at[:, :2 * de].multiply(8.0))
    tp = dict(tp, w_qkv=torch.from_numpy(np.array(jp["w_qkv"])))
    hd = de // cfg.n_heads
    seen, op = [], layers.mlstm_chunk

    def recording(q, k, v, lf, gi, bt):
        y, c = op(q, k, v, lf, gi, bt)
        seen.append(float(y[..., hd].abs().max()))
        return y, c

    monkeypatch.setattr(layers, "mlstm_chunk", recording)
    x = _x(16, cfg.d_model, 9)
    y_ref, st_ref = _ref(ref_layers.mlstm, ref_cfg)(jnp.asarray(x), jp)
    y, st = layers.mlstm(torch.from_numpy(x), tp, cfg)
    assert seen and max(seen) > 1.0, seen
    _close(y, y_ref, "y")
    want, got = _scaled(st_ref), _scaled({n: t.numpy()
                                          for n, t in st.items()})
    for n in ("C", "n"):
        _close(got[n], want[n], f"{n}·e^m")
