"""The port's optimizer, schedule, gradient compression, data pipeline and
one-device train step (``repro_torch.optim``, ``repro_torch.data``,
``repro_torch.parallel``) held against the JAX package's on the CPU.

AdamW (f32 leaves and a bf16 one, three steps with clipping) must agree
with ``repro.optim.adamw_update`` to one f32 rounding (``ADAMW_ATOL``),
bf16 parameters bit for bit; ``warmup_cosine`` to ``LR_RTOL`` over
warmup, decay and past the end.  The compression (int8 with error
feedback, five rounds) and the data batches (three architectures' batch
kinds, several steps) must be bit-equal.  The train step (``grad_accum``
1 and 2, two steps each of granite-moe's smoke config, with its MoE aux
loss) is held against the JAX ``make_train_step(cfg, pcfg, None)`` jitted
on the CPU.  The reference's own cases (``tests/test_optim_data.py``,
``tests/test_compression.py``) run on the port as well.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.configs.base import ParallelCfg as RefParallelCfg
from repro.configs.base import ShapeCfg as RefShapeCfg
from repro.data import SyntheticLMData as RefData
from repro.models import init_params as jax_init_params
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import compression as ref_compression
from repro.optim import warmup_cosine as jax_warmup_cosine
from repro.parallel.steps import make_train_step as jax_make_train_step

from repro_torch import configs
from repro_torch.configs.base import ParallelCfg, ShapeCfg
from repro_torch.data import SyntheticLMData
from repro_torch.models import Model, params_from_jax, params_to_jax
from repro_torch.optim import adamw_init, adamw_update, warmup_cosine
from repro_torch.optim.compression import (compress, compressed_bytes,
                                           decompress, ef_init)
from repro_torch.parallel import make_train_step

torch.set_num_threads(2)

#: one f32 rounding of parameters near 3 (sums and powers in another
#: order)
ADAMW_ATOL = 1e-6
#: the cosine of XLA and of torch differ in the last bit
LR_RTOL = 1e-6


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _cfgs(arch, over):
    return (dataclasses.replace(ref_configs.get_smoke_config(arch), **over),
            dataclasses.replace(configs.get_smoke_config(arch), **over))


def _batch(cfg, seed):
    """A batch of ``STEP_B`` sequences of ``STEP_S`` tokens."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (STEP_B, STEP_S))
            .astype(np.int32)}


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


def _tree(rng):
    return {"w": (rng.normal(size=(64, 33)) * 3).astype(np.float32),
            "heavy": rng.standard_cauchy(size=(1000,)).astype(np.float32),
            "tiny": (rng.normal(size=(7,)) * 1e-3).astype(np.float32)}


# -- AdamW --------------------------------------------------------------------


def test_adamw_matches_jax():
    rng = np.random.default_rng(0)
    start = dict(_tree(rng), bf=rng.normal(size=(40,)).astype(np.float32))
    jp = {k: jnp.asarray(v) for k, v in start.items()}
    jp["bf"] = jp["bf"].astype(jnp.bfloat16)
    tp = {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    tp["bf"] = tp["bf"].bfloat16()
    jo, to = jax_adamw_init(jp), adamw_init(tp)
    update = jax.jit(lambda g, o, p, lr: jax_adamw_update(g, o, p, lr=lr))
    for step in range(3):
        g = {k: (rng.normal(size=v.shape) * 0.3).astype(np.float32)
             for k, v in start.items()}
        lr = np.float32(1e-2 * (step + 1))
        jp, jo, jm = update({k: jnp.asarray(v) for k, v in g.items()}, jo,
                            jp, jnp.float32(lr))
        tp2, to, tm = adamw_update({k: torch.from_numpy(v)
                                    for k, v in g.items()}, to, tp,
                                   lr=torch.tensor(lr))
        assert tp2 is tp                                 # in place
        assert int(to["count"]) == int(jo["count"]) == step + 1
        assert to["count"].dtype == torch.int32
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        for k in start:
            want = np.asarray(jp[k].astype(jnp.float32))
            got = tp[k].float().numpy()
            if k == "bf":
                assert tp[k].dtype == torch.bfloat16
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=ADAMW_ATOL)
            for mom in ("m", "v"):
                assert to[mom][k].dtype == torch.float32
                np.testing.assert_allclose(to[mom][k].numpy(),
                                           np.asarray(jo[mom][k]),
                                           rtol=1e-6, atol=1e-9)


def test_adamw_first_step_matches_hand_computation():
    p = {"w": torch.tensor([1.0, -2.0])}
    g = {"w": torch.tensor([0.5, 0.25])}
    opt = adamw_init(p)
    lr, b1, b2, eps, wd = 0.1, 0.9, 0.95, 1e-8, 0.1
    new_p, new_opt, metrics = adamw_update(
        g, opt, p, lr=lr, weight_decay=wd, clip_norm=1e9)
    gnp = np.array([0.5, 0.25])
    m = (1 - b1) * gnp
    v = (1 - b2) * gnp ** 2
    mhat = m / (1 - b1)
    vhat = v / (1 - b2)
    want = np.array([1.0, -2.0]) - lr * (
        mhat / (np.sqrt(vhat) + eps) + wd * np.array([1.0, -2.0]))
    np.testing.assert_allclose(new_p["w"].numpy(), want, rtol=1e-6)
    assert int(new_opt["count"]) == 1
    assert float(metrics["grad_norm"]) > 0


def test_adamw_clipping_scales_update():
    p = {"w": torch.ones(4)}
    big = {"w": torch.full((4,), 1e3)}
    _, _, m1 = adamw_update(big, adamw_init(p), p, lr=0.1, clip_norm=1.0,
                            weight_decay=0.0)
    assert float(m1["grad_norm"]) > 1.0
    assert bool(torch.isfinite(p["w"]).all())


def test_adamw_bf16_moments():
    """``state_dtype`` sets the moments' type (405B-class configs)."""
    opt = adamw_init({"w": torch.ones(3)}, "bfloat16")
    assert opt["m"]["w"].dtype == opt["v"]["w"].dtype == torch.bfloat16


# -- schedule -----------------------------------------------------------------


def test_warmup_cosine_matches_jax():
    kw = dict(peak_lr=3e-4, warmup_steps=10, total_steps=100)
    f = jax.jit(lambda s: jax_warmup_cosine(s, **kw))
    for s in range(0, 130, 3):
        got = warmup_cosine(s, **kw)
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(
            float(f(jnp.asarray(s, jnp.int32))), rel=LR_RTOL)


def test_warmup_cosine_shape():
    lrs = [float(warmup_cosine(s, peak_lr=1.0, warmup_steps=10,
                               total_steps=100)) for s in range(0, 100, 5)]
    assert lrs[0] < lrs[1]
    assert max(lrs) <= 1.0 + 1e-6
    assert lrs[-1] < lrs[4]
    assert lrs[-1] >= 0.1 - 1e-6


# -- compression --------------------------------------------------------------


def test_compression_bit_equal_to_jax():
    """Five rounds of compress / decompress with error feedback, each
    from the same carried error: the int8 values, the scales, the new
    error buffers and the decompressed values bit for bit.  The reference
    runs op by op, as its tests call it (under ``jax.jit`` XLA fuses
    ``gf - q·scale`` into a multiply-add, which rounds once)."""
    rng = np.random.default_rng(1)
    base = _tree(rng)
    jef = ref_compression.ef_init({k: jnp.asarray(v)
                                   for k, v in base.items()})
    tef = ef_init({k: torch.from_numpy(v) for k, v in base.items()})
    for r in range(5):
        g = {k: v * (r + 1) + rng.normal(size=v.shape).astype(np.float32)
             for k, v in base.items()}
        jq, jef = ref_compression.compress(
            {k: jnp.asarray(v) for k, v in g.items()}, jef)
        tq, tef = compress({k: torch.from_numpy(v) for k, v in g.items()},
                           tef)
        jd, td = ref_compression.decompress(jq), decompress(tq)
        assert compressed_bytes(tq) == ref_compression.compressed_bytes(jq)
        for k in g:
            assert tq[k][0].dtype == torch.int8
            np.testing.assert_array_equal(tq[k][0].numpy(),
                                          np.asarray(jq[k][0]))
            for got, want in ((tq[k][1], jq[k][1]), (tef[k], jef[k]),
                              (td[k], jd[k])):
                np.testing.assert_array_equal(_bits(got.numpy()),
                                              _bits(want))


def test_compression_roundtrip_error_bounded():
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(
        size=(64, 64)).astype(np.float32))}
    q, _ = compress(g, ef_init(g))
    err = float((decompress(q)["w"] - g["w"]).abs().max())
    assert err <= float(g["w"].abs().max()) / 127 * 0.51 + 1e-6


def test_error_feedback_cancels_bias():
    rng = np.random.default_rng(1)
    true_sum = torch.zeros(32)
    dec_sum = torch.zeros(32)
    ef = ef_init({"w": torch.zeros(32)})
    for _ in range(50):
        g = {"w": torch.from_numpy((rng.normal(size=32) * 0.01)
                                   .astype(np.float32))}
        q, ef = compress(g, ef)
        dec_sum += decompress(q)["w"]
        true_sum += g["w"]
    resid = float(ef["w"].abs().max())
    torch.testing.assert_close(dec_sum, true_sum, rtol=0,
                               atol=2 * resid + 1e-5)


def test_compression_ratio():
    g = {"w": torch.ones((1024, 1024))}
    q, _ = compress(g, ef_init(g))
    assert compressed_bytes(q) < g["w"].numel() * 4 / 3.9


# -- data -----------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama3.2-3b", "internvl2-2b",
                                  "whisper-large-v3"])
def test_data_batches_bit_equal_to_jax(arch):
    """Tokens (and the frontends' embeddings) of several steps: the same
    bits and types as the reference's; with a device, the same values as
    torch tensors there."""
    shape = ShapeCfg("t", 16, 4, "train")
    ref = RefData(ref_configs.get_smoke_config(arch),
                  RefShapeCfg("t", 16, 4, "train"), seed=3)
    host = SyntheticLMData(configs.get_smoke_config(arch), shape, seed=3)
    dev = SyntheticLMData(configs.get_smoke_config(arch), shape, seed=3,
                          device="cpu")
    for step in (0, 1, 7, 1000):
        want, got, on_dev = ref.batch_at(step), host.batch_at(step), \
            dev.batch_at(step)
        assert sorted(got) == sorted(want) == sorted(on_dev)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))
            assert isinstance(on_dev[k], torch.Tensor)
            np.testing.assert_array_equal(_bits(on_dev[k].numpy()),
                                          _bits(want[k]))


def test_data_pipeline_is_seekable_and_deterministic():
    cfg = configs.get_smoke_config("llama3.2-3b")
    shape = ShapeCfg("t", 16, 4, "train")
    d1 = SyntheticLMData(cfg, shape, seed=3)
    d2 = SyntheticLMData(cfg, shape, seed=3)
    b_a = d1.batch_at(7)
    _ = d1.batch_at(3)
    np.testing.assert_array_equal(b_a["tokens"], d2.batch_at(7)["tokens"])
    assert not np.array_equal(d1.batch_at(8)["tokens"], b_a["tokens"])


# -- the train step ----------------------------------------------------------

STEP_ARCH = "granite-moe-3b-a800m"
STEP_KW = dict(peak_lr=1e-3, warmup=1, total_steps=10)
STEPS = 2
STEP_B, STEP_S = 4, 16
#: gradients (so the moments) agree to about 3e-6 in relative L2
GRAD_RTOL = 1e-4
#: f32 losses near 7 agree to about 1e-6
LOSS_ATOL = 1e-5
#: AdamW's update is about lr·sign(g) where |g| passes eps, and a
#: gradient entry at the rounding noise moves by up to lr·|g|/eps: the
#: updates agree in relative L2, not entry by entry
UPDATE_RTOL = 1e-3


@pytest.fixture(scope="module", params=[1, 2], ids=["accum1", "accum2"])
def step_case(request):
    """Two steps of each package's train step from the same weights and
    batches (grad_accum ``A``): metrics, parameters and AdamW state after
    each step."""
    A = request.param
    ref_cfg, cfg = _cfgs(STEP_ARCH, {})
    tree = jax.tree.map(np.asarray, jax.jit(functools.partial(
        jax_init_params, cfg=ref_cfg))(jax.random.key(0)))
    batches = [_batch(cfg, seed=10 + i) for i in range(STEPS)]

    jstep = jax.jit(jax_make_train_step(
        ref_cfg, RefParallelCfg(grad_accum=A, remat=True), None, **STEP_KW))
    params, opt = tree, jax_adamw_init(tree)
    ref = []
    for i, b in enumerate(batches):
        new, opt, metrics = jstep(
            params, opt, {k: jnp.asarray(v) for k, v in b.items()},
            jnp.asarray(i, jnp.int32))
        ref.append(jax.tree.map(np.asarray, {
            "update": jax.tree.map(lambda a, b: a - b, new, params),
            "m": opt["m"], "v": opt["v"], "count": opt["count"],
            "metrics": metrics}))
        params = new

    model = _port_model(tree, cfg)
    popt = adamw_init(dict(model.named_parameters()))
    step = make_train_step(cfg, ParallelCfg(grad_accum=A, remat=True),
                           **STEP_KW)
    got = []
    for i, b in enumerate(batches):
        old = params_to_jax(model.state_dict(), cfg)
        _, popt, metrics = step(model, popt, {k: torch.from_numpy(v)
                                              for k, v in b.items()}, i)
        got.append(jax.tree.map(lambda t: t.numpy(), {
            "update": jax.tree.map(lambda a, b: a - b,
                                   params_to_jax(model.state_dict(), cfg),
                                   old),
            "m": params_to_jax(popt["m"], cfg),
            "v": params_to_jax(popt["v"], cfg),
            "count": popt["count"].clone(),
            "metrics": {k: v.detach().clone() for k, v in metrics.items()}}))
    return ref, got


def test_train_step_metrics_match_jax(step_case):
    ref, got = step_case
    for i, (r, g) in enumerate(zip(ref, got)):
        m, w = g["metrics"], r["metrics"]
        assert abs(float(m["loss"]) - float(w["loss"])) <= LOSS_ATOL, i
        assert float(m["lr"]) == pytest.approx(float(w["lr"]), rel=1e-6)
        assert float(m["grad_norm"]) == pytest.approx(
            float(w["grad_norm"]), rel=GRAD_RTOL)


def test_train_step_state_matches_jax(step_case):
    """Each step's parameter update (new minus old) within ``UPDATE_RTOL``
    of the reference's in relative L2, the moments within ``GRAD_RTOL``
    (``v`` squares the gradient, so twice that), the count exact."""
    ref, got = step_case
    for i, (r, g) in enumerate(zip(ref, got)):
        assert int(g["count"]) == int(r["count"]) == i + 1
        for what, rtol in (("update", UPDATE_RTOL), ("m", GRAD_RTOL),
                           ("v", 2 * GRAD_RTOL)):
            want = dict(_tree_leaves(r[what]))
            have = dict(_tree_leaves(g[what]))
            assert sorted(map(str, have)) == sorted(map(str, want))
            for path, w in want.items():
                err = _rel(have[path], w)
                assert err <= rtol, \
                    f"step {i} {what}{jax.tree_util.keystr(path)}: {err:.3g}"
