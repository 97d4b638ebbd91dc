"""The benchmark's yardstick on the CPU: work counted from sizes, the
roofline bounds, the trace reduction, the traffic, the file contract, and
that a run imports nothing of JAX or the JAX package."""
import json
import math
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import counts, harness, peaks, trace, traffic

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread while a test runs: the suite runs its files in
    parallel processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfg(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("S,window", [(1, None), (7, None), (7, 3),
                                      (12, 12), (12, 20), (30, 5)])
def test_attn_pairs_counts_every_visible_key(S, window):
    brute = sum(1 for q in range(S) for k in range(S)
                if k <= q and (window is None or k > q - window))
    assert counts.attn_pairs(S, window) == brute


def test_attn_pairs_at_the_published_context():
    # 4096 queries see 1..4096 keys, the other 4096 see 4096 each
    assert counts.attn_pairs(8192, 4096) == 4096 * 4097 // 2 + 4096 * 4096
    assert counts.attn_pairs(8192) == 8192 * 8193 // 2


def test_active_weights_by_hand():
    g = cfg("granite-moe-3b-a800m")
    attn = 1536 * 1536 * 2 + 2 * 1536 * 512          # q, o; k, v (8 x 64)
    moe = 1536 * 40 + 8 * 3 * 1536 * 512             # router, 8 of 40
    assert counts.block_weights_active(g) == 32 * (attn + moe) == 807272448
    assert counts.head_weights(g) == 1536 * 49155
    d = cfg("h2o-danube-3-4b")
    attn = 3840 * 3840 * 2 + 2 * 3840 * 960
    assert counts.block_weights_active(d) == \
        24 * (attn + 3 * 3840 * 10240) == 3715891200


def _run(cell_name, items, seconds=2.0, probes=None, profile=None):
    cell = harness.load_cell(cell_name, BENCH)
    return harness.Run(cell, harness.Window(0.0, seconds, items), 1.0,
                       probes or {}, profile)


def test_mfu_train_by_hand():
    mod = harness.load_module("metrics", "mfu.train")
    run = _run("h2o-danube-3-4b.train.1x8192", [{"tokens": 8192}] * 3, 6.0)
    n = 3715891200 + 3840 * 32000
    attn = 12 * counts.attn_pairs(8192) * 120 * 32 * 24
    want = 100 * 3 * (6 * n * 8192 + attn) / (6.0 * peaks.BF16_FLOPS)
    assert mod.value(run) == pytest.approx(want, rel=1e-12)
    assert mod.value(_run("h2o-danube-3-4b.train.1x8192", [])) is None


def test_mfu_prefill_by_hand():
    mod = harness.load_module("metrics", "mfu.prefill")
    items = [{"length": 100}, {"length": 300}]
    run = _run("granite-moe-3b-a800m.prefill.b4", items, 0.5)
    ops = sum(2 * 807272448 * L + 4 * (L * (L + 1) // 2) * 64 * 24 * 32
              + 2 * 1536 * 49155 for L in (100, 300))
    assert mod.value(run) == pytest.approx(
        100 * ops / (0.5 * peaks.BF16_FLOPS), rel=1e-12)


def test_moe_gmm_bound_counts_live_rows_and_experts():
    mod = harness.load_module("metrics", "roofline.moe_gmm.serve")
    x, w = torch.zeros(3, 8, 16, dtype=torch.bfloat16), \
        torch.zeros(3, 16, 32, dtype=torch.bfloat16)
    summary = mod.summarize((x, w, torch.tensor([3, 0, 5])), {})
    # 8 live rows, 2 experts with a live row, the whole [3, 8, 32] output
    ops, nbytes = 2 * 8 * 16 * 32, 2 * (8 * 16 + 2 * 16 * 32 + 3 * 8 * 32) + 12
    bound = max(ops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)
    run = _run("granite-moe-3b-a800m.prefill.b4", [{"length": 1}],
               probes={mod.PROBE: [(2 * bound, summary)]})
    assert mod.value(run) == pytest.approx(50.0)


def test_flash_bound_counts_windowed_pairs():
    mod = harness.load_module("metrics", "roofline.flash_attention.serve")
    q = torch.zeros(1, 4, 4000, 128, dtype=torch.bfloat16)
    s = mod.summarize((q, q, q, True, 1024), {})
    ops = 4.0 * 4 * counts.attn_pairs(4000, 1024) * 128
    assert mod.bound_s(s) == pytest.approx(max(
        ops / peaks.BF16_FLOPS,
        2 * 4 * 4 * 4000 * 128 / peaks.HBM_BYTES_PER_S))
    assert mod.value(_run("h2o-danube-3-4b.prefill.b1",
                          [{"length": 1}])) is None


def test_trace_reduce_busy_and_gaps():
    dev = [(0.0, 1.0, "k1"), (0.5, 2.0, "k2"), (3.0, 4.0, "k1"),
           (9.0, 11.0, "k3")]
    host = [(0.0, 10.0, "step"), (2.1, 2.9, "aten::mm"),
            (4.0, 9.0, "cudaStreamSynchronize")]
    r = trace.reduce(dev, host, 0.0, 10.0)
    assert r["busy_s"] == pytest.approx(4.0)
    assert r["window_s"] == 10.0
    assert dict(map(tuple, r["device_ops"])) == pytest.approx(
        {"k1": 2.0, "k2": 1.5, "k3": 1.0})
    assert dict(map(tuple, r["idle_gaps"])) == pytest.approx(
        {"aten::mm": 1.0, "cudaStreamSynchronize": 5.0})


def test_deck_is_one_set_of_sizes_in_seeded_orders():
    t = json.loads((ROOT / "portbench" / "workloads" /
                    "h2o-danube-3-4b.prefill.b1.json").read_text())
    lengths = traffic.deck_lengths(t["lengths"])
    assert lengths == sorted(lengths) and lengths[-1] == 8192
    p = t["lengths"]
    q = (7 + 0.5) / p["deck"]
    x = p["median"] * math.exp(p["sigma"] * __import__(
        "statistics").NormalDist().inv_cdf(q))
    assert lengths[7] == round(x)
    a = traffic.prefill_deck(t, 5, 100)
    b = traffic.prefill_deck(t, 6, 100)
    assert sorted(x.shape[1] for x in a) == sorted(x.shape[1] for x in b) \
        == lengths
    assert [x.shape[1] for x in a] != [x.shape[1] for x in b]
    # each round of 12 calls spans the distribution: one of each quarter
    first = sorted(lengths.index(x.shape[1]) // 4 for x in a[:12])
    assert first == list(range(12))
    assert np.array_equal(a[0], traffic.prefill_deck(t, 5, 100)[0])
    # a round's calls: the same twelve lengths in every seed's deck
    for seed in (5, 6):
        deck = traffic.prefill_deck(t, seed, 100)
        pos = traffic.prefill_round(t, seed, 0)
        assert pos == list(range(pos[0], pos[0] + 12))
        assert sorted(deck[i].shape[1] for i in pos) == lengths[::4]


def test_danube_runs_the_published_full_attention():
    from repro_torch.configs.base import ATTN
    pc = harness.port_config(cfg("h2o-danube-3-4b"))
    assert pc.window is None and {b.mixer for b in pc.blocks()} == {ATTN}
    assert harness.port_config(cfg("granite-moe-3b-a800m")).window is None


def test_benchmark_file_is_whole():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for name in cells:
        cell = harness.load_cell(name, BENCH)
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        assert all(m["moves"] in reported for m in cell.per_layer)
        assert (ROOT / "portbench" / "drivers" /
                f"{cell.t['driver']}.py").exists()
        assert (ROOT / "portbench" / "reference" /
                f"{cell.cfg['reference']}.py").exists()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()


def test_a_run_imports_no_jax():
    code = (
        "import json, sys\n"
        "sys.argv = ['x']\n"
        "from portbench import run, harness\n"
        "import portbench.controls\n"
        "bench = json.load(open('BENCHMARK.json'))\n"
        "for w in bench['workloads']:\n"
        "    c = harness.load_cell(w['name'], bench)\n"
        "    harness.port_config(c.cfg)\n"
        "    d = harness.load_module('drivers', c.t['driver'])\n"
        "    for m in c.end_to_end + c.per_layer:\n"
        "        harness.load_module('metrics', m['name'])\n"
        "    __import__('portbench.reference.' + c.cfg['reference'])\n"
        "import repro_torch.runtime.train_loop, repro_torch.launch.serve\n"
        "print(json.dumps(run.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": f"{ROOT}:{ROOT / 'src'}",
                              "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_compared_whole(monkeypatch):
    from portbench import run
    monkeypatch.setitem(sys.modules, "repro_torchish", SimpleNamespace())
    monkeypatch.setitem(sys.modules, "jaxlib.xla", SimpleNamespace())
    found = run.forbidden_modules()
    assert "jaxlib.xla" in found and "repro_torchish" not in found
    assert not any(m.split(".")[0] == "repro_torch" for m in found)
