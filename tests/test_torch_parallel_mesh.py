"""The port's multi-device layer on a mesh of four ``gloo`` ranks on the
CPU (``tests/torch_mesh_ranks.py``; one spawn, a ``FileStore`` in
``tmp_path``, no network), held against the port's one-device path.

The reference's own mesh runs fail under the installed jax 0.9, and the
port's one-device path is held against ``jax.value_and_grad(
forward_train)`` by ``tests/test_torch_train.py``; so the mesh runs are
held against the one-device port, at the reference's cross-mesh bar
(``rtol=5e-4, atol=5e-5``, ``tests/test_checkpoint_runtime.py``):

(a) llama3.2-3b and granite-moe-3b-a800m smoke models take steps on
    ``(2, 2)``, ``(4, 1)`` and ``(1, 4)``, and on ``(2, 2)`` with the
    sequence split over ``model`` and with two microbatches: losses at the
    bar; each step's gradient norm, and the parameters and AdamW's ``m``
    and ``v`` after the steps (gathered whole), leaf by leaf within
    ``STATE_RTOL`` of the one-device run's; granite's expert choices
    identical to the one-device run's (the MoE routes the whole batch),
    each rank's blocks shaped as the specs give, every replicated leaf
    bit-equal on the ranks that hold it.  A planted fault, a gradient
    reduction that keeps each rank's own rows' partial gradient, must
    fall outside ``STATE_RTOL`` (its losses stay within the loss bar);
(b) elastic restore: 2 steps on ``(2, 2)``, a checkpoint, a restore on
    ``(4, 1)`` (the same state, placed by the new mesh's rules) and 2 more
    steps, against 4 steps on ``(2, 2)``; then ``resize`` onto ``(1, 4)``
    and a step against the one-device run's: its loss and gradient norm,
    and the state after it;
(c) prefill logits and a decode step's on ``(2, 2)``, caches placed by
    ``cache_specs``, against one device (granite; whisper with its cross
    caches and the cache split by slots);
(d) ``pipeline_apply`` over 4 stages against sequential application, the
    reference test's stage function and sizes (``atol=1e-5``), and with
    fewer microbatches than stages;
(e) a checkpoint the JAX package wrote with ``(2, 2)`` specs restores on
    a ``(2, 2)`` mesh placed by them, with the same values;
(f) ``launch/train.py --smoke`` in a world of four ranks trains on their
    ``(4, 1)`` mesh, at the bar of the one-device trainer.
"""
import json
import sys
import time
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch.multiprocessing as mp

from repro import configs as ref_configs
from repro.checkpoint import save as jax_save
from repro.models import init_params as jax_init_params
from repro.optim import adamw_init as jax_adamw_init
from repro.parallel.sharding import MeshRules as RefMeshRules
from repro_torch.configs.base import ParallelCfg

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_mesh_ranks as ranks  # noqa: E402

#: the reference's cross-mesh bar (tests/test_checkpoint_runtime.py:125)
RTOL, ATOL = 5e-4, 5e-5
#: the gradient norms', the parameters' and the moments' bar, relative to
#: each leaf's largest magnitude: 10x the largest f32 rounding measured
#: between the mesh runs and the one-device run (2.1e-6, a norm's scale)
STATE_RTOL = 2e-5
#: seconds the four ranks may take, spawn included
JOIN_TIMEOUT = 240


def _close(got, want) -> bool:
    return bool(np.allclose(got, want, rtol=RTOL, atol=ATOL))


def _state_bad(c) -> list:
    """What of case ``c`` is outside ``STATE_RTOL``: each step's gradient
    norm, and the worst leaf of the parameters, ``m`` and ``v``."""
    bad = [("grad_norm", i, g, w) for i, (g, w) in
           enumerate(zip(c["norms"], c["want_norms"]))
           if abs(g - w) > STATE_RTOL * abs(w)]
    assert len(c["norms"]) == len(c["want_norms"]) > 0
    return bad + [(k, *e) for k, e in c["state_err"].items()
                  if e[0] > STATE_RTOL]


def _write_jax_checkpoint(path: Path) -> None:
    """llama3.2-3b's smoke parameters and AdamW state as the JAX package
    initializes them, saved with its rules' specs on a ``(2, 2)`` mesh."""
    cfg = ref_configs.get_smoke_config("llama3.2-3b")
    params = jax_init_params(jax.random.key(0), cfg)
    state = {"params": params, "opt": jax_adamw_init(params)}
    stub = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((2, 2)))
    rules = RefMeshRules(cfg, ParallelCfg(), stub)
    pspecs = rules.param_specs()
    jax_save(path, 3, state, specs={"params": pspecs,
                                    "opt": rules.opt_specs(pspecs)},
             extra={"next_step": 3})


@pytest.fixture(scope="module")
def mesh_results(tmp_path_factory):
    """Run the four ranks once; their reports, by rank."""
    tmp = tmp_path_factory.mktemp("mesh")
    _write_jax_checkpoint(tmp / "jax_ckpt")
    ctx = mp.start_processes(ranks.main, args=(str(tmp / "store"), str(tmp)),
                             nprocs=ranks.WORLD, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT
    try:
        # join raises a rank's traceback, and stops the other ranks
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                pytest.fail(f"the {ranks.WORLD} ranks did not finish in "
                            f"{JOIN_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(ranks.WORLD)]


STEP_IDS = [f"{a}-{'x'.join(map(str, m))}{''.join(f'-{k}' for k in kw)}"
            for a in ("llama", "granite") for m, kw in ranks.MESH_CASES]


@pytest.mark.parametrize("i", range(len(STEP_IDS)), ids=STEP_IDS)
def test_mesh_steps_match_one_device(mesh_results, i):
    for r, res in enumerate(mesh_results):
        c = res["steps"][i]
        assert _close(c["losses"], c["want"]), (r, c)
        assert not _state_bad(c), (r, _state_bad(c))
        assert not c["bad_shape"], (r, c["bad_shape"])
        assert not c["bad_bits"], (r, c["bad_bits"])
        assert c["replicated"] > 0
        if c["arch"] == "llama3.2-3b":
            assert c["n_routings"] == 0
        else:
            # every routing of the forward and of the recompute
            assert c["n_routings"] > 0 and c["same_experts"], (r, c)


def test_planted_reduction_fault_falls_outside_the_bar(mesh_results):
    for r, res in enumerate(mesh_results):
        c = res["planted"]
        bad = {b[0] for b in _state_bad(c)}
        assert {"grad_norm", "m", "v"} <= bad, (r, c)


def test_elastic_restore_and_resize(mesh_results):
    for r, res in enumerate(mesh_results):
        e = res["elastic"]
        assert e["restored"] and e["same_state"] and e["placed"], (r, e)
        assert _close(e["losses"], e["want"]), (r, e)
        assert e["step"] == 5
        assert _close(e["resized"], e["one_device"]), (r, e)
        assert not _state_bad(e), (r, _state_bad(e))
        assert not e["bad_shape"] and not e["bad_bits"], (r, e)


@pytest.mark.parametrize("i", range(2), ids=["granite", "whisper"])
def test_mesh_prefill_and_decode_match_one_device(mesh_results, i):
    for r, res in enumerate(mesh_results):
        c = res["serving"][i]
        assert c["placed"], (r, c)
        assert c["prefill_err"] <= ATOL + RTOL * c["prefill_scale"], (r, c)
        assert c["decode_err"] <= ATOL + RTOL * c["decode_scale"], (r, c)


@pytest.mark.parametrize("i", range(2), ids=["M6", "M2"])
def test_gpipe_matches_sequential(mesh_results, i):
    for res in mesh_results:
        c = res["pipeline"][i]
        assert c["shape"] == [c["M"], 8, ranks.PIPE_D]
        assert c["max_err"] <= 1e-5, c


def test_jax_checkpoint_restores_on_mesh(mesh_results):
    for res in mesh_results:
        c = res["jax_checkpoint"]
        assert c["placed"] and c["same"] and c["leaves"] > 0, c
        assert c["extra"] == {"next_step": 3}


def test_smoke_launch_over_every_rank(mesh_results):
    for res in mesh_results:
        c = res["launcher"]
        assert len(c["losses"]) == 1 and _close(c["losses"], c["want"]), c
