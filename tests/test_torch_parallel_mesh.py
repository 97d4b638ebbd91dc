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
    ``(4, 1)`` mesh, at the bar of the one-device trainer;
(g) the compute split over ``model`` (heads, FFN, experts, RG-LRU
    channels, vocab, and the sequence under ``seq_shard``): (a)'s meshes
    with ``model`` > 1 already run it for llama (``(1, 4)`` takes the
    heads' ``_fit`` fallback) and granite (experts over ``model``: EP);
    recurrentgemma (RG-LRU channels, SWA, kv heads gathered) and whisper
    (encoder, cross-attention) take steps on ``(2, 2)`` and ``(1, 4)``
    (recurrentgemma also under SP) held to the one-device steps at
    ``SPLIT_RTOL``; two planted faults, a row-parallel product whose
    partial sums are never added and an SP reduce-scatter replaced by a
    slice, fall outside it;
(h) greedy decoding on split meshes (llama, granite, recurrentgemma,
    whisper; caches split by heads, by slots and whole): each rank's
    greedy tokens equal the one-device ones, the f32 logits are within
    ``SPLIT_LOGIT_ATOL``, each rank's cache bytes between steps equal its
    split of the whole, and one decode step's collective bytes (counted by
    ``repro_torch.launch.hlo_analysis``) are the same at two cache
    lengths: no cache moves per token.
(i) the rest of the split: granite with 5 experts (``model`` 2 does not
    divide them: expert-TP, and the reference's ``moe_buf`` rule splits
    the capacity over ``data``) takes steps on ``(2, 2)`` (and with two
    microbatches), each rank's grouped matmuls on half the capacity rows,
    the live rows of the two data ranks' slices adding up to the
    one-device run's call by call, and on ``(4, 1)`` (EP over a ``model``
    of one rank: the capacity whole), its expert choices identical; the
    grouped dispatch on ``(2, 2)`` and ``(4, 1)`` with no row gathered at
    the MoE (the counter sees only ``model``'s sum of the expert outputs),
    its load-balancing loss within ``AUX_RTOL`` of one device's; xlstm-125m
    on ``(1, 4)`` with its 4 heads (a head a rank) and with 2 (each
    mLSTM head's value columns halved over 2 ranks, the sLSTM's head
    repeated on them) takes steps and decodes greedily, tokens equal,
    each rank's state bytes its spec's split.  All at ``SPLIT_RTOL``; a
    capacity slice filled without its offset and a grouped aux loss of
    local statistics only fall outside the bars.
The host copies, checkpoints and resizes of (a) and (b) have one writer:
rank 0 holds the whole state on the host, every other rank only its own
blocks; the checkpoint written on ``(2, 2)`` reads back bit-equal in both
packages.
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
from repro_torch.launch.hlo_analysis import ring_bytes

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_mesh_ranks as ranks  # noqa: E402

#: the reference's cross-mesh bar (tests/test_checkpoint_runtime.py:125)
RTOL, ATOL = 5e-4, 5e-5
#: the gradient norms', the parameters' and the moments' bar, relative to
#: each leaf's largest magnitude: 10x the largest f32 rounding measured
#: between the mesh runs and the one-device run (2.1e-6, a norm's scale)
STATE_RTOL = 2e-5
#: (g)'s bars on the split's train steps, relative as ``STATE_RTOL``: 10x
#: the largest difference measured from the one-device run (gradient
#: norms 1.0e-7; m 3.0e-6 and v 2.7e-6; the parameters 2.9e-4, on an
#: RMSNorm scale that starts at zero, whose AdamW steps divide tiny
#: gradients by their own size)
SPLIT_RTOL = {"grad_norm": 1e-6, "params": 3e-3, "m": 3e-5, "v": 3e-5}
#: (h)'s bar on the f32 logits: 10x the largest difference measured
#: (3.0e-6, on logits of magnitude 3-5)
SPLIT_LOGIT_ATOL = 3e-5
#: (i)'s bar on the MoE load-balancing loss, relative: 10x the largest
#: difference measured from the one-device run (1.2e-7: the grouped
#: dispatch's probability sums added over the ranks)
AUX_RTOL = 1e-6
#: seconds the four ranks may take, spawn included
JOIN_TIMEOUT = 300


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


def _assert_one_writer(r: int, c) -> None:
    """Rank 0 writes: its host copy is the whole state; every other
    rank's host copy is its own blocks' bytes."""
    assert c["writer"] == (r == 0), (r, c["writer"])
    want = c["whole_bytes"] if r == 0 else c["shard_bytes"]
    assert c["host_bytes"] == want, (r, c)
    if r:
        assert c["shard_bytes"] < c["whole_bytes"]


def _split_bad(c) -> list:
    """What of split case ``c`` is outside ``SPLIT_RTOL``."""
    bad = [("grad_norm", i, g, w) for i, (g, w) in
           enumerate(zip(c["norms"], c["want_norms"]))
           if abs(g - w) > SPLIT_RTOL["grad_norm"] * abs(w)]
    assert len(c["norms"]) == len(c["want_norms"]) > 0
    return bad + [(k, *e) for k, e in c["state_err"].items()
                  if e[0] > SPLIT_RTOL[k]]


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
def mesh_dir(tmp_path_factory):
    """Run the four ranks once; their directory."""
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
    return tmp


@pytest.fixture(scope="module")
def mesh_results(mesh_dir):
    """The four ranks' reports, by rank."""
    return [json.loads((mesh_dir / f"rank{r}.json").read_text())
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
        _assert_one_writer(r, c)
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
        _assert_one_writer(r, e)


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


SPLIT_STEP_IDS = [f"{a.split('-')[0]}-{'x'.join(map(str, m))}"
                  f"{''.join(f'-{k}' for k in kw)}"
                  for a, m, kw in ranks.SPLIT_STEPS]


@pytest.mark.parametrize("i", range(len(SPLIT_STEP_IDS)), ids=SPLIT_STEP_IDS)
def test_split_steps_match_one_device(mesh_results, i):
    for r, res in enumerate(mesh_results):
        c = res["split_steps"][i]
        assert _close(c["losses"], c["want"]), (r, c)
        assert not _split_bad(c), (r, _split_bad(c))
        assert not c["bad_shape"] and not c["bad_bits"], (r, c)
        _assert_one_writer(r, c)


@pytest.mark.parametrize("i", range(len(ranks.SPLIT_FAULTS)),
                         ids=[f[0] for f in ranks.SPLIT_FAULTS])
def test_split_planted_faults_fall_outside_the_bars(mesh_results, i):
    for r, res in enumerate(mesh_results):
        c = res["split_faults"][i]
        assert not _close(c["losses"], c["want"]), (r, c)
        assert {"params", "m", "v"} <= {b[0] for b in _split_bad(c)}, (r, c)


SPLIT_SERVE_IDS = [f"{a.split('-')[0]}-{'x'.join(map(str, m))}-{kv}"
                   for a, m, kv in ranks.SPLIT_SERVING]


@pytest.mark.parametrize("i", range(len(SPLIT_SERVE_IDS)),
                         ids=SPLIT_SERVE_IDS)
def test_split_decode_matches_one_device_and_moves_no_cache(mesh_results, i):
    for r, res in enumerate(mesh_results):
        c = res["split_serving"][i]
        assert c["same_tokens"], (r, c)
        assert len(c["errs"]) == ranks.DECODE_STEPS + 1
        assert max(c["errs"]) <= SPLIT_LOGIT_ATOL, (r, c)
        assert all(local == split for local, split in c["cache_bytes"]), \
            (r, c["cache_bytes"])
        n = len(ranks.CACHE_LENS)
        assert len(c["coll"]) == n and len(set(c["coll"])) == 1, (r, c)


def test_mesh_checkpoint_reads_back_in_both_packages(mesh_dir):
    """(b)'s checkpoint, written on ``(2, 2)`` by one rank from the
    blocks of all four: the JAX package's restore and the port's read the
    same bits (and the ranks restored it into the state they saved)."""
    from repro.checkpoint import restore as jax_restore
    from repro_torch.checkpoint import restore as port_restore
    from repro_torch.checkpoint.topology import _flatten_with_paths
    step = 2
    mine, extra2 = port_restore(mesh_dir / "ckpt", step)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    got, extra = jax_restore(mesh_dir / "ckpt", step, mine, mesh=mesh)
    assert extra == extra2 == {"next_step": step}
    flat, want = _flatten_with_paths(got), _flatten_with_paths(mine)
    assert sorted(flat) == sorted(want) and len(flat) > 0
    for key, leaf in flat.items():
        assert np.array_equal(np.asarray(leaf), want[key].numpy()), key


MOE_IDS = [f"{impl}-{'x'.join(map(str, m))}{''.join(f'-{k}' for k in kw)}"
           for impl, m, kw in ranks.MOE_STEPS]


def _aux_close(c) -> bool:
    return len(c["aux"]) == len(c["want_aux"]) > 0 and all(
        abs(g - w) <= AUX_RTOL * abs(w)
        for g, w in zip(c["aux"], c["want_aux"]))


@pytest.mark.parametrize("i", range(len(MOE_IDS)), ids=MOE_IDS)
def test_moe_capacity_and_rows_split_as_the_reference(mesh_results, i):
    """(i): the global MoE on its capacity slice where the reference's rule
    splits it (whole where it does not), the grouped MoE on its own rows,
    each held to the one-device steps."""
    impl, shape, _ = ranks.MOE_STEPS[i]
    split = impl == "global" and shape[1] > 1   # expert-TP: C over data
    for r, res in enumerate(mesh_results):
        c = res["rest_moe"][i]
        assert _close(c["losses"], c["want"]), (r, c)
        assert not _split_bad(c), (r, _split_bad(c))
        assert not c["bad_shape"] and not c["bad_bits"], (r, c)
        _assert_one_writer(r, c)
        assert _aux_close(c), (r, c["aux"], c["want_aux"])
        coll = c["moe_coll"]
        assert len(coll) > 0
        if impl == "global":
            assert c["n_routings"] > 0 and c["same_experts"], (r, c)
            rows = c["capacity"] // (shape[0] if split else 1)
            assert c["buf_rows"] == [rows], (r, c["buf_rows"], rows)
            # the router logits and the rows gathered; the output slices
            # too where the capacity splits
            assert all(k["count_all-gather"] == 2 + split for k in coll), \
                (r, coll)
        else:
            # no row leaves its rank: the only collective is model's sum
            # of the expert outputs (expert-TP), none on a model of one
            want = {} if shape[1] == 1 else {
                "all-reduce": ring_bytes("all-reduce",
                                         c["grouped_out_bytes"], shape[1])}
            assert all({k: v for k, v in k_.items() if k in
                        ("all-reduce", "all-gather", "reduce-scatter",
                         "all-to-all")} == want for k_ in coll), (r, coll)
    # no live row dropped and no dead row computed: the live rows of the
    # ranks that hold one model index's slices add up to one device's
    held = [r for r in range(ranks.WORLD) if r % shape[1] == 0]
    got = [mesh_results[r]["rest_moe"][i]["live"] for r in held]
    want = mesh_results[0]["rest_moe"][i]["want_live"]
    if impl == "global":
        parts = got if split else got[:1]
        assert [sum(x) for x in zip(*parts)] == want
    else:
        assert sum(map(sum, got)) == sum(want)


@pytest.mark.parametrize("i", range(2), ids=["unoffset_slice", "local_aux"])
def test_planted_moe_faults_fall_outside_the_bars(mesh_results, i):
    """(i)'s planted faults: every capacity slice filled as the first (its
    counts and rows not offset) moves the losses; a grouped aux loss from
    each rank's own statistics moves the aux loss (its 0.01 weight keeps
    the loss itself within the loss bar); both move the state."""
    for r, res in enumerate(mesh_results):
        c = res["rest_faults"][i]
        assert c["name"] == ("unoffset_slice", "local_aux")[i]
        if i == 0:
            assert not _close(c["losses"], c["want"]), (r, c)
        else:
            assert not _aux_close(c), (r, c["aux"], c["want_aux"])
        assert {"params", "m", "v"} <= {b[0] for b in _split_bad(c)}, (r, c)


@pytest.mark.parametrize("i", range(len(ranks.XLSTM_CASES)),
                         ids=["4heads", "2heads"])
def test_xlstm_splits_over_model(mesh_results, i):
    """(i): xlstm-125m's mixers split over a model of 4: each mLSTM call on
    one head's value columns (all 32 of a head of 32, or 32 of 64), each
    sLSTM loop on one head; steps and greedy decoding as one device."""
    for r, res in enumerate(mesh_results):
        c = res["rest_xlstm"][i]
        assert c["mlstm_heads"] == [[1, 32]], (r, c["mlstm_heads"])
        assert c["slstm_cols"] == [(16, 32)[i]], (r, c["slstm_cols"])
        assert _close(c["losses"], c["want"]), (r, c)
        assert not _split_bad(c), (r, _split_bad(c))
        assert not c["bad_shape"] and not c["bad_bits"], (r, c)
        _assert_one_writer(r, c)
        s = c["serving"]
        assert s["same_tokens"], (r, s)
        assert len(s["errs"]) == ranks.DECODE_STEPS + 1
        assert max(s["errs"]) <= SPLIT_LOGIT_ATOL, (r, s)
        assert all(local == split for local, split in s["cache_bytes"]), \
            (r, s["cache_bytes"])
