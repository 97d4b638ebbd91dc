"""The port's sharding rules, registry and mesh builders against the JAX
package's (``repro_torch.parallel.sharding``, ``repro_torch.models.
registry``, ``repro_torch.launch.mesh``), in this process.

The reference's ``MeshRules`` reads only a mesh's ``axis_names`` and
``devices.shape``, so it gets a stub mesh; the port's rules get the same
names and sizes (a stub with ``mesh_dim_names`` and ``shape``).  For all
ten configurations, the meshes ``(1, 1)``, ``(2, 4)``, ``(16, 16)`` and
``(2, 16, 16)`` and ``default_parallel`` of each of the four shapes, the
parameter, optimizer, batch and cache specs must be equal entry for
entry (the port's caches are one dict per layer, the reference stacks
each group's; whisper's cross cache is head-major in the port).  The
abstract parameters and inputs must have the reference's shapes and
types, and ``make_concrete`` the reference's values, bit for bit.  The
production meshes are built under the fake process-group backend in one
subprocess.  ``repro.launch.dryrun`` is not imported: it sets
``XLA_FLAGS`` to 512 host devices.
"""
import dataclasses
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro import configs as ref_configs
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import ShapeCfg as RefShapeCfg
from repro.configs.base import default_parallel as ref_default_parallel
from repro.models import init_params as jax_init_params
from repro.models import registry as ref_registry
from repro.parallel import sharding as ref_sharding

from repro_torch import configs
from repro_torch.configs.base import SHAPES, ShapeCfg, default_parallel
from repro_torch.launch import train as train_launcher
from repro_torch.models import registry
from repro_torch.parallel import MeshRules

ROOT = Path(__file__).resolve().parent.parent
MESHES = (((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")))


def _is_spec(x):
    return isinstance(x, PartitionSpec)


def _ref_leaves(tree):
    return [tuple(s) for s in jax.tree.leaves(tree, is_leaf=_is_spec)]


def _leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, tuple))


def _layer_slots(cfg):
    """Layer ``l`` of the port -> (group, slot, repeat) of the reference's
    stacked tree."""
    out = []
    for g, (repeat, body) in enumerate(cfg.layer_groups):
        for r in range(repeat):
            for i in range(len(body)):
                out.append((g, f"slot{i}", r))
    return out


@pytest.fixture(scope="module")
def ref_abstract():
    """The reference's abstract parameters and caches, once per config
    (its MeshRules calls ``abstract_params`` for every rule set)."""
    params, caches = {}, {}

    def abstract(cfg):
        if cfg.name not in params:
            params[cfg.name] = jax.eval_shape(
                lambda: jax_init_params(jax.random.key(0), cfg))
        return params[cfg.name]

    def cache(cfg, shape):
        key = (cfg.name, shape.name)
        if key not in caches:
            caches[key] = ref_registry.decode_input_specs(cfg, shape)[1]
        return caches[key]
    return abstract, cache


@pytest.mark.parametrize("arch", configs.list_archs())
def test_specs_equal_the_reference(arch, ref_abstract, monkeypatch):
    abstract, cache = ref_abstract
    monkeypatch.setattr(ref_registry, "abstract_params", abstract)
    rcfg, cfg = ref_configs.get_config(arch), configs.get_config(arch)
    slots = _layer_slots(cfg)
    for shape, axes in MESHES:
        stub = types.SimpleNamespace(axis_names=axes,
                                     devices=np.empty(shape))
        pstub = types.SimpleNamespace(mesh_dim_names=axes, shape=shape)
        for name in SHAPES:
            where = (arch, shape, name)
            ref = ref_sharding.MeshRules(
                rcfg, ref_default_parallel(rcfg, REF_SHAPES[name]), stub)
            port = MeshRules(cfg, default_parallel(cfg, SHAPES[name]), pstub)
            rp, pp = ref.param_specs(), port.param_specs()
            assert jax.tree.structure(rp, is_leaf=_is_spec) == \
                jax.tree.structure(pp, is_leaf=lambda x: isinstance(
                    x, tuple)), where
            assert _ref_leaves(rp) == _leaves(pp), where
            assert _ref_leaves(ref.opt_specs(rp)) == \
                _leaves(port.opt_specs(pp)), where
            batch = registry.train_input_specs(cfg, SHAPES[name])
            assert _ref_leaves(ref.batch_specs(
                ref_registry.train_input_specs(rcfg, REF_SHAPES[name]))) \
                == _leaves(port.batch_specs(batch)), where
            rc = ref.cache_specs(cache(rcfg, REF_SHAPES[name]))
            pc = port.cache_specs(registry.decode_input_specs(
                cfg, SHAPES[name])[1])
            assert len(pc) == len(slots), where
            for (g, slot, _), layer in zip(slots, pc):
                for leaf, spec in layer.items():
                    want = tuple(rc[g][slot][leaf])[1:]
                    if leaf in ("cross_k", "cross_v"):
                        want = (want[0], want[2], want[1], want[3])
                    assert spec == want, where + (leaf,)
    # the port's named specs are the stacked ones without the layer axis
    named = port.named_param_specs()
    assert named["embed"] == pp["embed"]
    g, slot, _ = slots[-1]
    for key, spec in named.items():
        if key.startswith(f"blocks.{len(slots) - 1}."):
            *path, leaf = key.split(".")[2:]
            node = pp["groups"][g][slot]
            for part in path:
                node = node[part]
            assert (None,) + spec == node[leaf], key


#: MoE buffers (kind, shape): granite's 40 experts and mixtral's 8, whose
#: capacities 1024 and 20480 divide every fsdp size here, 1000 and 40 that
#: divide some or none; d_model 1536 and 6144, d_ff 512 and 16384
MOE_BUFFERS = [(k, s) for E, C, D, F in ((40, 1024, 1536, 512),
                                         (40, 1000, 1536, 512),
                                         (8, 20480, 6144, 16384),
                                         (8, 40, 6144, 16384))
               for k, s in (("moe_buf", (E, C, D)), ("moe_hidden", (E, C, F)),
                            ("moe_buf4", (32, E, C, D)),
                            ("moe_hidden4", (24, E, C, F)))]


def test_moe_placement_is_the_references(monkeypatch):
    """``MeshRules.moe_spec`` places each MoE buffer as the reference's
    ``ac`` constraint does (its sharding constraint read back as a spec)
    on every mesh, for experts that divide ``model`` and that do not."""
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: tuple(spec))
    rcfg, cfg = (ref_configs.get_config("granite-moe-3b-a800m"),
                 configs.get_config("granite-moe-3b-a800m"))
    for shape, axes in MESHES:
        ref = ref_sharding.MeshRules(rcfg, ref_sharding.ParallelCfg(),
                                     types.SimpleNamespace(
                                         axis_names=axes,
                                         devices=np.empty(shape)))
        ref.shd = lambda spec: spec
        port = MeshRules(cfg, default_parallel(cfg, SHAPES["train_4k"]),
                         types.SimpleNamespace(mesh_dim_names=axes,
                                               shape=shape))
        for kind, buf in MOE_BUFFERS:
            want = ref.ac(types.SimpleNamespace(ndim=len(buf), shape=buf),
                          kind)
            assert port.moe_spec(kind, buf) == want, (shape, kind, buf)


def _shape_dtype(x):
    return tuple(x.shape), str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", configs.list_archs())
def test_abstract_params_and_inputs_equal_the_reference(arch, ref_abstract):
    abstract, cache = ref_abstract
    rcfg, cfg = ref_configs.get_config(arch), configs.get_config(arch)
    assert jax.tree.map(_shape_dtype, abstract(rcfg)) == \
        jax.tree.map(_shape_dtype, registry.abstract_params(cfg))
    for name in SHAPES:
        assert jax.tree.map(_shape_dtype, ref_registry.train_input_specs(
            rcfg, REF_SHAPES[name])) == jax.tree.map(
                _shape_dtype, registry.train_input_specs(cfg, SHAPES[name]))
        rt, rcache, rpos = ref_registry.decode_input_specs(
            rcfg, REF_SHAPES[name])
        tok, pcache, pos = registry.decode_input_specs(cfg, SHAPES[name])
        assert _shape_dtype(rt) == _shape_dtype(tok)
        assert _shape_dtype(rpos) == _shape_dtype(pos)
        assert len(pcache) == len(_layer_slots(cfg))
        for (g, slot, _), layer in zip(_layer_slots(cfg), pcache):
            for leaf, t in layer.items():
                shape, dt = _shape_dtype(rcache[g][slot][leaf])
                shape = shape[1:]
                if leaf in ("cross_k", "cross_v"):
                    shape = (shape[0], shape[2], shape[1], shape[3])
                assert (shape, dt) == _shape_dtype(t), (name, leaf)


def _bits(x) -> np.ndarray:
    """A leaf's values; bf16 (torch or ml_dtypes) as its bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if str(x.dtype) == "bfloat16" else x


@pytest.mark.parametrize("arch,dtype", [("granite-moe-3b-a800m", "float32"),
                                        ("whisper-large-v3", "bfloat16")])
def test_make_concrete_is_the_references(arch, dtype):
    rcfg = dataclasses.replace(ref_configs.get_smoke_config(arch),
                               param_dtype=dtype, compute_dtype=dtype)
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              param_dtype=dtype, compute_dtype=dtype)
    rshape, shape = RefShapeCfg("t", 16, 2, "train"), ShapeCfg("t", 16, 2,
                                                               "train")
    ref_tree = {"params": jax.eval_shape(
        lambda: jax_init_params(jax.random.key(0), rcfg)),
        "batch": ref_registry.train_input_specs(rcfg, rshape),
        "decode": ref_registry.decode_input_specs(rcfg, rshape)[::2]}
    tree = {"params": registry.abstract_params(cfg),
            "batch": registry.train_input_specs(cfg, shape),
            "decode": registry.decode_input_specs(cfg, shape)[::2]}
    want = jax.tree.leaves(ref_registry.make_concrete(ref_tree, seed=7))
    got = jax.tree.leaves(registry.make_concrete(tree, seed=7))
    assert len(want) == len(got) > 0
    for w, g in zip(want, got):
        assert np.array_equal(_bits(w), _bits(g))


def test_production_meshes_under_the_fake_backend():
    """One subprocess: ``make_production_mesh(multi_pod=True)`` over 512
    fake ranks has the reference's shape and axis names, and the rules on
    it give the specs they give on a stub of its names and sizes (held
    against the reference's above); the single-pod mesh refuses a world
    of 512."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", FAKE_SCRIPT],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "ok", out.stdout


FAKE_SCRIPT = r"""
import types
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch import configs
from repro_torch.configs.base import SHAPES, default_parallel
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.parallel import MeshRules
from torch.distributed.tensor import Replicate, Shard

dist.init_process_group("fake", store=FakeStore(), rank=3, world_size=512)
mesh = make_production_mesh(multi_pod=True, device_type="cpu")
assert tuple(mesh.shape) == (2, 16, 16), mesh.shape
assert mesh.mesh_dim_names == ("pod", "data", "model")
stub = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                             shape=(2, 16, 16))
cfg = configs.get_config("llama3.2-3b")
pcfg = default_parallel(cfg, SHAPES["train_4k"])
real, fake = MeshRules(cfg, pcfg, mesh), MeshRules(cfg, pcfg, stub)
assert real.param_specs() == fake.param_specs()
assert real.named_param_specs() == fake.named_param_specs()
assert real.placements((("pod", "data"), "model")) == \
    [Shard(0), Shard(0), Shard(1)]
assert real.placements((None, "model")) == \
    [Replicate(), Replicate(), Shard(1)]
try:
    make_production_mesh(device_type="cpu")
except RuntimeError as e:
    assert "256 ranks" in str(e), e
else:
    raise AssertionError("a (16, 16) mesh over 512 ranks")
print("ok")
"""


def test_multi_pod_launch_refuses_one_process(capsys):
    with pytest.raises(SystemExit) as exc:
        train_launcher.main(["--arch", "llama3.2-3b", "--smoke",
                             "--multi-pod", "--device", "cpu"])
    assert "512" in str(exc.value)
