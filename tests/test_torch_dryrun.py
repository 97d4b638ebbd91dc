"""The port's op-level counter (``repro_torch.launch.hlo_analysis``) and
its production dry run (``repro_torch.launch.dryrun``), on the CPU.

The counter mirrors ``tests/test_hlo_analysis.py``: a matmul's FLOPs are
exactly ``2·M·K·N``, repeated and nested loops count their trip counts,
a tuple output's bytes are its parts'; and on a fake process group of 8
ranks (in a subprocess) each collective kind on a group of 4 counts the
reference's ring bytes, equal to what the reference's ``analyze_hlo``
gives for the same collectives written as HLO.

The dry run runs in subprocesses (a process's world is fixed) on fake
``(2, 4)`` and ``(16, 16)`` meshes with smoke configs, every tensor on
``meta``: each rank's state bytes equal the reference's analytic formula
and its ``DTensor`` blocks' bytes; where every split divides (whisper,
recurrentgemma, granite with 6 experts, whose capacity splits over
``data``, and xlstm-125m's heads on ``(2, 4)``, a 16-head llama on
``(16, 16)``), the per-device FLOPs times the ranks are within 5% of the
one-device count of the same step, and with the split off they are not.  ``repro.launch.
dryrun`` is never imported here: its first lines set ``XLA_FLAGS``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.launch.hlo_analysis import analyze_hlo
from repro_torch.kernels.rglru_scan.ref import (rglru_scan_assoc,
                                                rglru_scan_ref)
from repro_torch.launch.hlo_analysis import OpCounter, analyze, ring_bytes

ROOT = Path(__file__).resolve().parents[1]
#: per-device FLOPs x ranks against the one-device count, where every
#: split divides: only the norms, the residual adds and the RoPE of a
#: gathered projection are repeated on every rank
SPLIT_FLOPS_TOL = 0.05


def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_matmul_flops_exact():
    M, K, N = 64, 128, 32
    res = analyze(lambda a, b: a @ b, _meta(M, K), _meta(K, N))
    assert res["flops"] == 2 * M * K * N
    assert res["bytes"] == 4 * (M * K + K * N + M * N)
    assert res["collectives"] == {}


def test_repeated_products_count_every_trip():
    M, K, L = 32, 32, 17

    def f(x, ws):
        for i in range(L):
            x = torch.tanh(x @ ws[i])
        return x

    res = analyze(f, _meta(M, K), _meta(L, K, K))
    # the selects are views; each trip a product and a tanh
    assert res["flops"] == L * (2 * M * K * K + M * K)


def test_nested_loops_count_their_product():
    M, L1, L2 = 16, 5, 7

    def f(x, ws):
        for i in range(L1):
            for j in range(L2):
                x = x @ ws[i, j]
        return x

    res = analyze(f, _meta(M, M), _meta(L1, L2, M, M))
    assert res["flops"] == L1 * L2 * 2 * M * M * M


def test_tuple_output_bytes():
    x = torch.empty(8, 6, dtype=torch.bfloat16, device="meta")
    res = analyze(lambda t: torch.sort(t, dim=-1), x)
    # the input, the values (bf16) and the indices (int64)
    assert res["bytes"] == 8 * 6 * (2 + 2 + 8)
    assert res["flops"] == 2 * 8 * 6


def test_views_and_empties_are_free():
    x = _meta(4, 6)
    res = analyze(lambda t: (t.T, t.reshape(6, 4), t[1:], t.detach(),
                             torch.empty_like(t)), x)
    assert res == {"flops": 0.0, "bytes": 0.0, "collectives": {}}


def test_counter_keeps_the_peak_of_live_storages():
    counter = OpCounter()
    state = _meta(256, 256)
    counter.track(state)

    def f():
        a = state * 2          # 256 KiB
        b = a + 1              # another
        del a
        return b.sum()

    with counter:
        f()
    assert counter.peak_bytes == 3 * 256 * 256 * 4
    assert counter.live_bytes == 256 * 256 * 4


def test_associative_scan_is_the_recurrence():
    g = torch.Generator().manual_seed(0)
    for S in (1, 2, 5, 16, 37):
        a = torch.rand(2, S, 3, generator=g)
        x = torch.randn(2, S, 3, generator=g)
        h0 = torch.randn(2, 3, generator=g)
        for got, want in zip(rglru_scan_assoc(a, x, h0),
                             rglru_scan_ref(a, x, h0)):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


COLLECTIVES_SCRIPT = r"""
import json
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as fc
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.hlo_analysis import OpCounter

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
g = dist.new_group([0, 1, 2, 3])
t = torch.empty(16, 16)
calls = {
    "all-reduce": lambda: dist.all_reduce(t, group=g),
    "all-gather": lambda: dist.all_gather_into_tensor(
        torch.empty(64, 16), t, group=g),
    "reduce-scatter": lambda: dist.reduce_scatter_tensor(
        torch.empty(4, 16), t, group=g),
    "all-to-all": lambda: dist.all_to_all_single(torch.empty(16, 16), t,
                                                 group=g),
    "collective-permute": lambda: (dist.send(t, 1), dist.recv(
        torch.empty(16, 16), 7)),
    "functional": lambda: (fc.all_reduce(t, "sum", g),
                           fc.all_gather_tensor(t, 0, g),
                           fc.reduce_scatter_tensor(t, "sum", 0, g)),
    "list all-gather": lambda: dist.all_gather(
        [torch.empty(16, 16) for _ in range(4)], t, group=g),
}
out = {}
for name, call in calls.items():
    c = OpCounter(8)
    with c:
        call()
    out[name] = c.result()["collectives"]
print(json.dumps(out))
"""

#: the same collectives as HLO: (kind, output type) on a group of 4
_HLO = {"all-reduce": "f32[16,16]", "all-gather": "f32[64,16]",
        "reduce-scatter": "f32[4,16]", "all-to-all": "f32[16,16]",
        "collective-permute": "f32[16,16]"}


def _reference(kind: str, out_type: str) -> dict:
    groups = "source_target_pairs={{0,1}}" if kind == "collective-permute" \
        else "replica_groups={{0,1,2,3}}"
    hlo = f"""
HloModule test

ENTRY %main (p0: f32[16,16]) -> {out_type} {{
  %p0 = f32[16,16]{{1,0}} parameter(0)
  ROOT %c.1 = {out_type}{{1,0}} {kind}(%p0), {groups}
}}
"""
    return analyze_hlo(hlo, 8)["collectives"]


@pytest.fixture(scope="module")
def counted_collectives():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", COLLECTIVES_SCRIPT],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kind", sorted(_HLO))
def test_collective_ring_bytes_equal_the_references(counted_collectives,
                                                    kind):
    got = counted_collectives[kind]
    want = _reference(kind, _HLO[kind])
    assert got[kind] == pytest.approx(want[kind]) and want[kind] > 0
    assert got["total"] == pytest.approx(want["total"])
    assert got[f"count_{kind}"] == want[f"count_{kind}"] == 1


def test_functional_and_list_collectives_count_alike(counted_collectives):
    f = counted_collectives["functional"]
    nbytes = 16 * 16 * 4
    assert f["all-reduce"] == ring_bytes("all-reduce", nbytes, 4)
    assert f["all-gather"] == ring_bytes("all-gather", 4 * nbytes, 4)
    assert f["reduce-scatter"] == ring_bytes("reduce-scatter", nbytes / 4, 4)
    assert counted_collectives["list all-gather"] == \
        counted_collectives["all-gather"]


def test_the_reference_analyzer_imports_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", "import sys, repro.launch.hlo_analysis; "
         "print('jax' in sys.modules)"], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=120)
    assert out.stdout.strip() == "False", out.stderr


DRYRUN_SCRIPT = r"""
import json, sys
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs.base import MoECfg, ShapeCfg
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_test_mesh

shape = tuple(json.loads(sys.argv[1]))
cases = json.loads(sys.argv[2])
dist.init_process_group("fake", store=FakeStore(), rank=0,
                        world_size=shape[0] * shape[1])
mesh = make_test_mesh(shape)
out = []
for arch, cell, over, ratio in cases:
    # a shape of its own: [name, seq_len, global_batch, kind]
    cell = cell if isinstance(cell, str) else ShapeCfg(*cell)
    if over and "moe" in over:
        over = dict(over, moe=MoECfg(**over["moe"]))
    r = dryrun.lower_cell(arch, cell, False, mesh=mesh, smoke=True,
                          cfg_overrides=over)
    row = {k: r[k] for k in ("status", "n_chips", "hlo_flops",
                             "state_bytes_per_device", "state_bytes_local",
                             "peak_bytes_per_device", "collective_bytes")}
    if ratio:
        one = dryrun.lower_cell(arch, cell, False, mesh=torch.device("meta"),
                                smoke=True, cfg_overrides=over)
        off = dryrun.lower_cell(arch, cell, False, mesh=mesh, smoke=True,
                                cfg_overrides=over, split=False)
        row["one_device_flops"] = one["hlo_flops"]
        row["no_split_flops"] = off["hlo_flops"]
    out.append(row)
print(json.dumps(out))
"""

#: a llama whose heads, kv heads, FFN and vocab divide 16
LLAMA16 = {"d_model": 128, "n_heads": 16, "n_kv_heads": 16, "d_ff": 256}
#: granite with 6 experts, which a model of 4 does not divide (expert-TP,
#: the capacity split over data), and heads that it divides
GRANITE6 = {"moe": {"n_experts": 6, "top_k": 4, "d_ff_expert": 32},
            "n_heads": 8, "n_kv_heads": 4}
#: xlstm-125m's smoke model trained on 4 rows of 64 steps: its per-step
#: mLSTM and sLSTM loops traced on meta in a few seconds
XLSTM_TRAIN = ["xlstm_train", 64, 4, "train"]
#: (mesh, [(arch, shape, cfg overrides, FLOP-ratio check)])
DRYRUN_CASES = (
    ((2, 4), [("whisper-large-v3", "train_4k", None, True),
              ("recurrentgemma-2b", "train_4k", None, True),
              ("llama3.2-3b", "decode_32k", None, False),
              ("granite-moe-3b-a800m", "train_4k", None, False),
              ("granite-moe-3b-a800m", "train_4k", GRANITE6, True),
              ("xlstm-125m", XLSTM_TRAIN, None, True)]),
    ((16, 16), [("llama3.2-3b", "train_4k", LLAMA16, True),
                ("granite-moe-3b-a800m", "decode_32k", None, False),
                ("recurrentgemma-2b", "prefill_32k", None, False),
                ("whisper-large-v3", "decode_32k", None, False)]),
)


@pytest.fixture(scope="module", params=DRYRUN_CASES,
                ids=lambda c: "x".join(map(str, c[0])))
def dryrun_cells(request):
    shape, cases = request.param
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", DRYRUN_SCRIPT,
                          json.dumps(shape), json.dumps(cases)],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return shape, cases, json.loads(out.stdout.strip().splitlines()[-1])


def test_dryrun_state_bytes_equal_the_formula_and_the_blocks(dryrun_cells):
    shape, cases, rows = dryrun_cells
    for (arch, cell, _, _), r in zip(cases, rows):
        assert r["status"] == "ok" and r["n_chips"] == shape[0] * shape[1]
        assert r["state_bytes_per_device"] == r["state_bytes_local"] > 0, \
            (arch, cell, r)
        assert r["peak_bytes_per_device"] >= r["state_bytes_local"]
        assert r["collective_bytes"]["total"] > 0


def test_split_flops_add_up_to_the_one_device_step(dryrun_cells):
    shape, cases, rows = dryrun_cells
    n = shape[0] * shape[1]
    checked = 0
    for (arch, cell, _, ratio), r in zip(cases, rows):
        if not ratio:
            continue
        split = r["hlo_flops"] * n / r["one_device_flops"]
        whole = r["no_split_flops"] * n / r["one_device_flops"]
        assert abs(split - 1) <= SPLIT_FLOPS_TOL, (arch, cell, split)
        # each model rank computing whole layers repeats the work
        assert whole > 1 + 10 * SPLIT_FLOPS_TOL, (arch, cell, whole)
        checked += 1
    assert checked > 0
