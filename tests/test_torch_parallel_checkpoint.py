"""Checkpoints with partition specs across the two packages
(``repro_torch.checkpoint`` against ``repro.checkpoint``).

The manifest the port writes for a state and its specs equals the one the
reference writes for the same values and specs, leaf for leaf (the specs
of a ``(2, 2, 2)`` mesh of the production axes, where a dimension splits
over the tuple ``("pod", "data")``); a
checkpoint the port's trainer writes restores in the reference on a
``(1, 1)`` jax mesh with its stored specs, and one the reference writes
with its specs restores in the port's trainer, bit for bit both ways.
The restore onto a mesh of four ranks is ``tests/test_torch_parallel_
mesh.py``'s.
"""
import json
import types

import jax
import numpy as np
from jax.sharding import PartitionSpec

from repro import configs as ref_configs
from repro.checkpoint import restore as jax_restore
from repro.checkpoint import save as jax_save
from repro.models import init_params as jax_init_params
from repro.optim import adamw_init as jax_adamw_init
from repro.parallel.sharding import MeshRules as RefMeshRules

from repro_torch import configs
from repro_torch.checkpoint import restore, save
from repro_torch.configs.base import ParallelCfg, ShapeCfg
from repro_torch.parallel import MeshRules
from repro_torch.runtime import Trainer

ARCH = "granite-moe-3b-a800m"
SHAPE = ShapeCfg("tiny", 32, 4, "train")


def _jax_state(cfg):
    params = jax_init_params(jax.random.key(1), cfg)
    return {"params": params, "opt": jax_adamw_init(params)}


def _specs(rules):
    p = rules.param_specs()
    return {"params": p, "opt": rules.opt_specs(p)}


def _manifest(path, step):
    return json.loads((path / f"step_{step}" / "manifest.json").read_text())


def test_manifest_equals_the_references(tmp_path):
    rcfg = ref_configs.get_smoke_config(ARCH)
    cfg = configs.get_smoke_config(ARCH)
    shape, axes = (2, 2, 2), ("pod", "data", "model")
    ref = RefMeshRules(rcfg, ParallelCfg(), types.SimpleNamespace(
        axis_names=axes, devices=np.empty(shape)))
    port = MeshRules(cfg, ParallelCfg(), types.SimpleNamespace(
        mesh_dim_names=axes, shape=shape))
    state = jax.tree.map(np.asarray, _jax_state(rcfg))
    jax_save(tmp_path / "ref", 2, state, specs=_specs(ref),
             extra={"next_step": 2})
    save(tmp_path / "port", 2, state, specs=_specs(port),
         extra={"next_step": 2})
    want, got = _manifest(tmp_path / "ref", 2), _manifest(tmp_path / "port", 2)
    assert got == want
    assert any(isinstance(e, list) for leaf in got["leaves"].values()
               for e in leaf["spec"] or ())
    for info in want["leaves"].values():
        assert (tmp_path / "port" / "step_2" / info["file"]).read_bytes() \
            == (tmp_path / "ref" / "step_2" / info["file"]).read_bytes()


def test_port_checkpoint_restores_on_a_jax_mesh(tmp_path):
    cfg = configs.get_smoke_config(ARCH)
    t = Trainer(cfg, SHAPE, "cpu", ckpt_dir=tmp_path, seed=2)
    t.run(1)
    t.save_checkpoint()
    rcfg = ref_configs.get_smoke_config(ARCH)
    template = jax.eval_shape(lambda: _jax_state(rcfg))
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    state, extra = jax_restore(tmp_path, 1, template, mesh=mesh)
    assert extra == {"next_step": 1}
    manifest = _manifest(tmp_path, 1)
    mine = t.state_tree()
    for (path, leaf), (_, want) in zip(
            jax.tree_util.tree_flatten_with_path(state)[0],
            jax.tree_util.tree_flatten_with_path(mine)[0]):
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        spec = manifest["leaves"][key]["spec"]
        assert leaf.sharding.spec == PartitionSpec(
            *[tuple(e) if isinstance(e, list) else e for e in spec]), key
        assert np.array_equal(np.asarray(leaf), want.numpy()), key


def test_jax_checkpoint_restores_in_the_port_with_specs(tmp_path):
    rcfg = ref_configs.get_smoke_config(ARCH)
    cfg = configs.get_smoke_config(ARCH)
    ref = RefMeshRules(rcfg, ParallelCfg(), jax.make_mesh(
        (1, 1), ("data", "model")))
    state = _jax_state(rcfg)
    jax_save(tmp_path, 4, state, specs=_specs(ref), extra={"next_step": 4})
    got, extra = restore(tmp_path, 4, mesh="cpu")
    assert extra == {"next_step": 4}
    want = jax.tree.leaves(state)
    assert len(jax.tree.leaves(got)) == len(want)
    for g, w in zip(jax.tree.leaves(got), want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    t = Trainer(cfg, SHAPE, "cpu", ckpt_dir=tmp_path)
    assert t.maybe_restore() and t.step == 4
    for g, w in zip(jax.tree.leaves(t.state_tree()), want):
        assert np.array_equal(g.numpy(), np.asarray(w))
