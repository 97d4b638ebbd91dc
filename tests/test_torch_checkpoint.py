"""The port's checkpoints, train loop and launcher
(``repro_torch.checkpoint``, ``repro_torch.runtime``,
``repro_torch.launch.train``) on the CPU, held against the JAX package's
checkpoint format.

A checkpoint written by either package must restore in the other bit for
bit (f32 leaves: the reference cannot read bf16 back), and the port's
trainer must resume from the JAX package's checkpoint of its state.  The
port writes bf16 leaves as the reference's ``np.save`` does, header and
bytes alike (type string ``'<V2'``), and reads them back as bf16.
``params_to_jax`` and ``params_from_jax`` are each other's inverse.  The
port's ``Trainer`` restarts bit-exactly after a simulated failure, and a
raised preemption flag checkpoints and stops, as the reference's tests
ask (``tests/test_checkpoint_runtime.py``).
"""
import functools
import io
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.checkpoint import restore as jax_restore
from repro.checkpoint import save as jax_save
from repro.models import init_params as jax_init_params
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.parallel.sharding import MeshRules as RefMeshRules
from jax.sharding import PartitionSpec

from repro_torch import configs
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step, restore,
                                    save)
from repro_torch.configs.base import ShapeCfg
from repro_torch.launch import train as train_launcher
from repro_torch.models import Model, params_from_jax, params_to_jax
from repro_torch.runtime import SimulatedFailure, Trainer

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
SMOKE_SHAPE = ShapeCfg("tiny", 32, 4, "train")


def _np(t) -> np.ndarray:
    """numpy of a leaf; a bf16 tensor as its bits (int16)."""
    if isinstance(t, torch.Tensor):
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t).numpy()
    return np.asarray(t)


def _bits(a) -> np.ndarray:
    a = _np(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _flat(tree, prefix=""):
    """``{path: leaf}`` of a tree of dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}/"))
    return out


def _assert_same_tree(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert _np(got[k]).shape == _np(want[k]).shape, k
        assert _np(got[k]).dtype == _np(want[k]).dtype, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), k)


@pytest.fixture(scope="module")
def jax_state():
    """The JAX package's train state of granite-moe's smoke config after
    one AdamW step (non-zero moments): ``(cfg, state)`` as numpy."""
    arch = "granite-moe-3b-a800m"
    ref_cfg = ref_configs.get_smoke_config(arch)
    params = jax.jit(functools.partial(jax_init_params, cfg=ref_cfg))(
        jax.random.key(0))
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype), params)
    params, opt, _ = jax.jit(lambda g, o, p: jax_adamw_update(
        g, o, p, lr=1e-3))(grads, jax_adamw_init(params), params)
    state = jax.tree.map(np.asarray, {"params": params, "opt": opt})
    return configs.get_smoke_config(arch), state


def test_jax_checkpoint_restores_in_the_port(tmp_path, jax_state):
    cfg, state = jax_state
    jax_save(tmp_path, 5, state, extra={"next_step": 5})
    assert latest_step(tmp_path) == 5
    got, extra = restore(tmp_path, 5)
    assert extra == {"next_step": 5}
    _assert_same_tree(got, state)
    # and the trainer resumes from it: the weights, moments and count
    t = Trainer(cfg, SMOKE_SHAPE, "cpu", ckpt_dir=tmp_path)
    assert t.maybe_restore() and t.step == 5
    _assert_same_tree(t.state_tree(), state)


def test_port_checkpoint_restores_in_jax(tmp_path):
    """The port's trainer checkpoints after a step; the JAX package's
    ``restore(..., mesh=None)`` reads the same bits into the JAX tree, and
    the manifest records each leaf's spec on the trainer's ``(1, 1)``
    mesh as the reference's rules give it."""
    arch = "granite-moe-3b-a800m"
    cfg = configs.get_smoke_config(arch)
    t = Trainer(cfg, SMOKE_SHAPE, "cpu", ckpt_dir=tmp_path, seed=2)
    t.run(1)
    t.save_checkpoint()
    ref_cfg = ref_configs.get_smoke_config(arch)
    abstract = jax.eval_shape(functools.partial(jax_init_params,
                                                cfg=ref_cfg),
                              jax.random.key(0))
    template = {"params": abstract, "opt": jax.eval_shape(jax_adamw_init,
                                                          abstract)}
    state, extra = jax_restore(tmp_path, 1, template, mesh=None)
    assert extra == {"next_step": 1}
    assert jax.tree.structure(state) == jax.tree.structure(template)
    _assert_same_tree(jax.tree.map(np.asarray, state), t.state_tree())
    manifest = json.loads((tmp_path / "step_1" / "manifest.json")
                          .read_text())
    stub = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((1, 1)))
    rules = RefMeshRules(ref_cfg, t.pcfg, stub)
    pspecs = rules.param_specs()
    want = {"params": pspecs, "opt": rules.opt_specs(pspecs)}
    specs = jax.tree.leaves_with_path(
        want, is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert len(specs) == len(manifest["leaves"])
    for path, spec in specs:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        assert manifest["leaves"][key]["spec"] == \
            [list(e) if isinstance(e, tuple) else e for e in spec], key


def test_bf16_leaves_are_the_reference_npy(tmp_path):
    """A bf16 leaf: the file the reference's ``np.save`` writes for the
    same values, byte for byte (``'<V2'``), read back as bf16."""
    vals = np.random.default_rng(0).normal(size=(3, 5)).astype(np.float32)
    t = torch.from_numpy(vals).bfloat16()
    state = {"a": t, "n": [torch.arange(4, dtype=torch.int32),
                           torch.from_numpy(vals)]}
    save(tmp_path, 2, state, extra={"next_step": 2})
    want = io.BytesIO()
    np.save(want, np.asarray(jnp.asarray(vals).astype(jnp.bfloat16)))
    assert (tmp_path / "step_2" / "a.npy").read_bytes() == want.getvalue()
    manifest = json.loads((tmp_path / "step_2" / "manifest.json")
                          .read_text())
    assert manifest["leaves"]["a"]["dtype"] == "<V2"
    got, _ = restore(tmp_path, 2)
    assert got["a"].dtype == torch.bfloat16
    _assert_same_tree(got, state)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "whisper-large-v3",
                                  "internvl2-2b"])
def test_params_to_jax_inverts_params_from_jax(arch):
    """Groups of several slots and repeats (recurrentgemma), an encoder
    (whisper) and a frontend (internvl2): each direction undoes the
    other, bit for bit."""
    ref_cfg = ref_configs.get_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    tree = jax.tree.map(np.asarray, jax.jit(functools.partial(
        jax_init_params, cfg=ref_cfg))(jax.random.key(0)))
    back = params_to_jax(params_from_jax(tree, cfg), cfg)
    _assert_same_tree(back, tree)
    model = Model(cfg, generator=torch.Generator().manual_seed(1),
                  device="cpu")
    sd = model.state_dict()
    again = params_from_jax(params_to_jax(sd, cfg), cfg)
    assert sorted(again) == sorted(sd)
    for k in sd:
        assert torch.equal(again[k], sd[k]), k


def test_checkpoint_roundtrip(tmp_path):
    state = {"a": torch.arange(12.0).reshape(3, 4),
             "b": [torch.ones(5), torch.zeros(2)]}
    save(tmp_path, 7, state, extra={"next_step": 7})
    assert latest_step(tmp_path) == 7
    assert not any(p.name.startswith(".tmp") for p in tmp_path.iterdir())
    got, extra = restore(tmp_path, 7)
    assert extra["next_step"] == 7
    _assert_same_tree(got, state)


def test_async_checkpointer(tmp_path):
    ck = AsyncCheckpointer(tmp_path)
    ck.save(3, {"x": torch.ones((4, 4))}, extra={"next_step": 3})
    ck.wait()
    assert latest_step(tmp_path) == 3 and ck.saved_steps == [3]
    got, _ = restore(tmp_path, 3)
    assert torch.equal(got["x"], torch.ones((4, 4)))


def test_train_restart_after_failure_is_bit_exact(tmp_path):
    """Crash mid-run, restart from the checkpoint: the losses and the
    final weights equal an uninterrupted run's bit for bit."""
    cfg = configs.get_smoke_config("llama3.2-3b")
    ref = Trainer(cfg, SMOKE_SHAPE, "cpu", seed=3)
    ref_rep = ref.run(6)
    t1 = Trainer(cfg, SMOKE_SHAPE, "cpu", ckpt_dir=tmp_path / "ck", seed=3)
    with pytest.raises(SimulatedFailure):
        t1.run(6, checkpoint_every=2, failure_at=4)
    t2 = Trainer(cfg, SMOKE_SHAPE, "cpu", ckpt_dir=tmp_path / "ck", seed=3)
    assert t2.maybe_restore()
    assert t2.step == 4
    rep2 = t2.run(2)
    assert rep2.losses == ref_rep.losses[4:6]
    _assert_same_tree(t2.state_tree(), ref.state_tree())


def test_preempt_flag_checkpoints_and_stops(tmp_path):
    cfg = configs.get_smoke_config("xlstm-125m")
    t = Trainer(cfg, SMOKE_SHAPE, "cpu", ckpt_dir=tmp_path / "ck", seed=1)
    calls = {"n": 0}

    def flag():
        calls["n"] += 1
        return calls["n"] >= 2

    rep = t.run(10, preempt_flag=flag)
    assert rep.preempted
    assert rep.steps_run < 10
    assert latest_step(tmp_path / "ck") == t.step


def test_trainer_defaults_to_the_card():
    cfg = configs.get_smoke_config("llama3.2-3b")
    if torch.cuda.is_available():
        assert Trainer(cfg, SMOKE_SHAPE).device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(cfg, SMOKE_SHAPE)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "recurrentgemma-2b", "xlstm-125m",
                                  "whisper-large-v3"])
def test_launcher_smoke_on_cpu(tmp_path, capsys, arch):
    """``--smoke --device cpu``: the smoke shape, checkpoints, and a second
    launch resumes where the first stopped, for the MoE, recurrent and
    encoder–decoder families."""
    argv = ["--arch", arch, "--smoke", "--device", "cpu",
            "--steps", "2", "--ckpt", str(tmp_path), "--checkpoint-every",
            "1"]
    rep = train_launcher.main(argv)
    assert rep.steps_run == 2 and rep.checkpoints == [1, 2]
    assert all(np.isfinite(rep.losses))
    assert "ran 2 steps" in capsys.readouterr().out
    again = train_launcher.main(argv)
    assert again.checkpoints == [3, 4]
    assert latest_step(tmp_path) == 4


def test_training_packages_import_no_jax():
    """optim, data, parallel, checkpoint, runtime and the launcher import
    neither jax nor the JAX package."""
    code = ("import sys; import repro_torch.optim, repro_torch.data, "
            "repro_torch.parallel, repro_torch.checkpoint, "
            "repro_torch.runtime, repro_torch.launch.train, "
            "repro_torch.optim.compression; bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'repro')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
