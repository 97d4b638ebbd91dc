"""The port's training path (``Model.forward_train`` with the MoE
load-balancing loss, and ``repro_torch.parallel.make_train_step``) held
against the JAX package's on the CPU.

Each case builds the JAX smoke model with ``init_params(jax.random.key(0),
cfg)`` in f32, carries its weights into the port through
``params_from_jax`` and feeds both the same batch (numpy, from a seed).
The loss must agree to ``LOSS_ATOL`` and every parameter's gradient, taken
back to the JAX tree's layout by ``params_to_jax``, to ``GRAD_RTOL`` in
relative L2 against ``jax.value_and_grad(forward_train)``.  The cases
cover the MoE with its aux loss under both dispatches
(granite-moe-3b-a800m), a dense model (llama3.2-3b), the encoder path
(whisper-large-v3), the patch frontend and its loss mask (internvl2-2b),
RG-LRU beside local attention past its window (recurrentgemma-2b) and
the mLSTM and sLSTM (xlstm-125m, the mLSTM per step and in chunks of 8).
On CPU tensors the layers' kernel ops run their plain versions and their
backward passes recompute through the oracles.

The JAX references are jitted once per case, from one JAX tree per
architecture (module-scoped fixtures).  The train step is held against
the JAX package's in ``tests/test_torch_optim_data.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import forward_train as jax_forward_train
from repro.models import init_params as jax_init_params

from repro_torch import configs
from repro_torch.models import Model, layers, params_from_jax, params_to_jax

torch.set_num_threads(2)

B, S = 2, 16
#: an encoder–decoder batch's frames (another length than its text)
ENC_LEN = 12
#: f32 on both sides: losses near 7 agree to about 1e-6
LOSS_ATOL = 1e-5
#: gradients agree to about 2e-6 in relative L2 (sums in another order)
GRAD_RTOL = 1e-4
CASES = [("granite-moe-3b-a800m", {"moe_impl": "global"}),
         ("granite-moe-3b-a800m", {"moe_impl": "grouped"}),
         ("llama3.2-3b", {}),
         ("whisper-large-v3", {}),
         ("internvl2-2b", {}),
         ("recurrentgemma-2b", {}),
         ("xlstm-125m", {"mlstm_impl": "scan"}),
         ("xlstm-125m", {"mlstm_impl": "chunked", "mlstm_chunk": 8})]
IDS = ["-".join([a, *map(str, over.values())]) for a, over in CASES]


def _cfgs(arch, over):
    return (dataclasses.replace(ref_configs.get_smoke_config(arch), **over),
            dataclasses.replace(configs.get_smoke_config(arch), **over))


def _batch(cfg, seed=3):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))
           .astype(np.int32)}
    if cfg.encoder_decoder:
        out["enc_embeds"] = (rng.normal(size=(B, ENC_LEN, cfg.d_model))
                             * 0.02).astype(np.float32)
    if cfg.frontend == "patch":
        out["embeds"] = (rng.normal(size=(B, cfg.frontend_tokens,
                                          cfg.d_model)) * 0.02
                         ).astype(np.float32)
        out["tokens"] = out["tokens"][:, cfg.frontend_tokens:]
    return out


def _tree_leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _port_model(tree, cfg):
    model = Model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(tree, cfg))
    return model


@pytest.fixture(scope="module")
def jax_trees():
    """JAX's init_params(key(0)) of each smoke config, as numpy, made once
    per architecture."""
    trees = {}

    def get(arch, ref_cfg):
        if arch not in trees:
            trees[arch] = jax.tree.map(np.asarray, jax.jit(
                functools.partial(jax_init_params, cfg=ref_cfg))(
                    jax.random.key(0)))
        return trees[arch]
    return get


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request, jax_trees):
    """The JAX loss and gradients of one case, and the port's on its
    weights."""
    arch, over = request.param
    ref_cfg, cfg = _cfgs(arch, over)
    tree = jax_trees(arch, ref_cfg)
    batch = _batch(cfg)
    loss, grads = jax.jit(jax.value_and_grad(functools.partial(
        jax_forward_train, cfg=ref_cfg)))(
            tree, {k: jnp.asarray(v) for k, v in batch.items()})
    model = _port_model(tree, cfg)
    got = model.forward_train({k: torch.from_numpy(v)
                               for k, v in batch.items()})
    got.backward()
    got_grads = params_to_jax({n: p.grad for n, p in
                               model.named_parameters()}, cfg)
    return {"cfg": cfg, "loss": float(loss), "got": float(got.detach()),
            "grads": jax.tree.map(np.asarray, grads),
            "got_grads": jax.tree.map(lambda t: t.numpy(), got_grads),
            "model": model, "batch": batch}


def test_train_loss_matches_jax(case):
    assert abs(case["got"] - case["loss"]) <= LOSS_ATOL, \
        (case["got"], case["loss"])


def test_train_gradients_match_jax(case):
    want = dict(_tree_leaves(case["grads"]))
    got = dict(_tree_leaves(case["got_grads"]))
    assert sorted(map(str, got)) == sorted(map(str, want))
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, (path, g.shape, w.shape)
        err = _rel(g, w)
        assert err <= GRAD_RTOL, f"{jax.tree_util.keystr(path)}: {err:.3g}"


def test_remat_changes_no_bit():
    """Each block recomputed in the backward pass gives the loss and the
    gradients of the run that keeps its activations, bit for bit."""
    _, cfg = _cfgs("granite-moe-3b-a800m", {})
    model = Model(cfg, generator=torch.Generator().manual_seed(0),
                  device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    out = []
    for remat in (True, False):
        loss = model.forward_train(batch, remat=remat)
        out.append((loss.detach(), torch.autograd.grad(
            loss, list(model.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_aux_term_sums_over_the_layers_of_a_group():
    """granite's one group of MoE layers: the loss is the cross-entropy
    plus 0.01 times the *sum* of the layers' aux losses (one group), not
    their mean."""
    _, cfg = _cfgs("granite-moe-3b-a800m", {})
    (repeat, _), = cfg.layer_groups
    assert repeat == cfg.n_layers > 1
    model = Model(cfg, generator=torch.Generator().manual_seed(0),
                  device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    seen = []
    real = layers.moe_aux_loss

    def spy(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]

    with torch.no_grad():
        full = model.forward_train(batch, remat=False)
        layers.moe_aux_loss = lambda *a, **kw: torch.zeros(())
        try:
            ce = model.forward_train(batch, remat=False)
        finally:
            layers.moe_aux_loss = spy
        try:
            model.forward_train(batch, remat=False)
        finally:
            layers.moe_aux_loss = real
    assert len(seen) == cfg.n_layers
    torch.testing.assert_close(full, ce + 0.01 * torch.stack(seen).sum(),
                               rtol=1e-6, atol=1e-6)
