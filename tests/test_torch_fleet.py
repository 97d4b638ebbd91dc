"""The port's self-healing fleet held against the JAX package's.

``repro_torch.core.fleet`` ports ``RetryQueue``, the bit-exact value
codec, ``FaultInjector`` and ``FleetCoordinator`` with its spawned
workers.  Here:

* the retry queue's model-based interleaving corpus of
  ``tests/test_retry_queue.py``, run on the port's queue, with every
  final queue directory recovered by *both* packages' queues; a queue
  directory written by either package is recovered by the other, args
  bit-exact;
* the fault injector's plan parsing and seed resolution, equal to the
  reference's;
* marked ``fleet`` (deselected from tier-1 by ``pytest.ini``; run with
  ``-m fleet``): the chaos scenarios of ``tests/test_chaos_fleet.py`` on
  CPU workers (``device="cpu"``) — every fault point, seed-resolved and
  multi-kill schedules, evacuation and drain across backends (``interp``
  and the ``cuda`` backend's plain version), rebalance, coordinator
  restart, respawn, the serving front end over a fleet — each finishing
  bit-equal to the reference interpreter with zero lost and zero
  double-acked launches, and the fabric prewarm;
* marked ``slow``: the multi-process cases of
  ``tests/test_multiprocess_cache.py`` on the port's stores.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import repro.core as ref
from repro.core import fleet as ref_fleet
from repro.core import kernels_suite as ref_ks

import repro_torch.core as port
from repro_torch.core import fleet as port_fleet
from repro_torch.core import hetir as ir
from repro_torch.core.fleet import (FAULT_POINTS, MID_KERNEL,
                                    POST_CHECKPOINT_PRE_ACK, PRE_LAUNCH,
                                    FaultInjector, FleetCoordinator,
                                    RetryQueue)

SRC = str(Path(__file__).resolve().parents[1] / "src")
QUEUES = {"reference": ref_fleet.RetryQueue, "port": RetryQueue}


# ---------------------------------------------------------------------------
# retry queue: model-based interleavings, recovered by both packages
# ---------------------------------------------------------------------------

def run_simulation(events, qdir, queue_cls):
    """Apply ``events`` to a durable queue; return it, the reference
    model ``{launch_id: acked?}`` and the ack log."""
    q = queue_cls(qdir)
    model, deliveries, n = {}, [], 0
    for op, tgt in events:
        if op == "enqueue":
            lid = f"L{n:04d}"
            n += 1
            q.enqueue(lid, "dyn_matmul", 4, 16,
                      {"A": np.arange(4, dtype=np.float32), "K": 32},
                      ("A",))
            model[lid] = False
        elif op == "dispatch":
            pending = q.pending()
            if pending:
                q.mark_inflight(pending[tgt % len(pending)], worker=tgt % 3)
        elif op == "crash_worker":
            for lid in q.inflight(worker=tgt % 3):
                q.requeue(lid)
        elif op == "reassign":
            inflight = q.inflight()
            if inflight:
                q.reassign(inflight[tgt % len(inflight)],
                           worker=(tgt + 1) % 3)
        elif op == "ack":
            inflight = q.inflight()
            if inflight:
                lid = inflight[tgt % len(inflight)]
                if q.ack(lid):
                    deliveries.append(lid)
                model[lid] = True
        elif op == "duplicate_ack":
            acked = [lid for lid, done in model.items() if done]
            if acked:
                lid = acked[tgt % len(acked)]
                assert q.ack(lid) is False and q.is_acked(lid)
        elif op == "restart":
            q = queue_cls(qdir)
            q.recover()
    return q, model, deliveries


def check_invariants(q, model, deliveries, qdir, queue_cls):
    assert len(q) == len(model)
    for lid, acked in model.items():
        if not acked:
            assert q.get(lid)["state"] in ("pending", "inflight")
    assert sorted(q.unacked()) == sorted(
        lid for lid, acked in model.items() if not acked)
    assert sorted(deliveries) == sorted(
        lid for lid, acked in model.items() if acked)
    assert len(set(deliveries)) == len(deliveries)
    q2 = queue_cls(qdir)
    demoted = q2.recover()
    assert len(q2) == len(model)
    for lid, acked in model.items():
        assert q2.is_acked(lid) == acked
        assert q2.get(lid)["state"] == ("acked" if acked else "pending")
    assert all(not model[lid] for lid in demoted)
    for lid in model:
        args = q2.decode_args(lid)
        assert args["A"].dtype == np.float32
        assert args["A"].tobytes() == np.arange(4, dtype=np.float32).tobytes()
        assert args["K"] == 32
    order = [q2.get(lid)["seq"] for lid in sorted(model)]
    assert order == sorted(order)


def _random_events(rng, length):
    weights = {"enqueue": 4, "dispatch": 4, "crash_worker": 2,
               "reassign": 1, "ack": 3, "restart": 1, "duplicate_ack": 1}
    ops = [op for op, w in weights.items() for _ in range(w)]
    return [(ops[rng.integers(len(ops))], int(rng.integers(64)))
            for _ in range(length)]


@pytest.mark.parametrize("seed", range(20))
def test_retry_queue_interleavings_corpus(tmp_path, seed):
    rng = np.random.default_rng(1000 + seed)
    events = _random_events(rng, int(rng.integers(10, 60)))
    qdir = tmp_path / "q"
    q, model, deliveries = run_simulation(events, qdir, RetryQueue)
    # the port's directory, recovered by either package's queue
    for queue_cls in QUEUES.values():
        check_invariants(q, model, deliveries, qdir, queue_cls)


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
def test_queue_dir_recovers_in_the_other_package(tmp_path, writer, reader):
    """A coordinator of one package dies; one of the other recovers its
    queue directory: same states, same order, args bit-exact."""
    args = {"A": np.linspace(-1, 1, 12, dtype=np.float32),
            "I": np.arange(5, dtype=np.int32), "n": 12,
            "s": np.float32(0.25), "u": np.uint32(7)}
    q = QUEUES[writer](tmp_path)
    for i in range(4):
        q.enqueue(f"L{i}", "vadd", 2, 32, args, ("A",))
    q.mark_inflight("L0", worker=0)
    q.ack("L0")
    q.mark_inflight("L1", worker=1)
    q.mark_inflight("L2", worker=0)
    q.requeue("L2")
    q2 = QUEUES[reader](tmp_path)
    assert q2.recover() == ["L1"]
    assert q2.is_acked("L0") and q2.pending() == ["L1", "L2", "L3"]
    assert q2.get("L2")["attempts"] == 1 and q2.get("L1")["attempts"] == 1
    for lid in ("L1", "L2", "L3"):
        got = q2.decode_args(lid)
        for k, v in args.items():
            assert type(got[k]) is type(v)
            assert np.asarray(got[k]).tobytes() == np.asarray(v).tobytes()
            assert np.asarray(got[k]).dtype == np.asarray(v).dtype


def test_retry_queue_directed_edges(tmp_path):
    q = RetryQueue(tmp_path / "q")
    q.enqueue("L1", "k", 1, 1, {}, ())
    assert q.mark_inflight("L1", worker=0) == 1
    assert q.requeue("L1") is True
    assert q.mark_inflight("L1", worker=1) == 2
    with pytest.raises(ValueError):
        q.enqueue("L1", "k", 1, 1, {}, ())    # duplicate accept refused
    assert q.ack("L1") is True and q.ack("L1") is False
    assert q.requeue("L1") is False           # a late death cannot resurrect
    with pytest.raises(ValueError):
        q.mark_inflight("L1", worker=0)       # acked is terminal
    (tmp_path / "q" / "garbage.json").write_text("{not json")
    (tmp_path / "q" / "foreign.json").write_text('{"launch_id": "X"}')
    q.enqueue("L2", "k", 1, 1, {}, ())
    assert RetryQueue(tmp_path / "q").unacked() == ["L2"]
    mem = RetryQueue(None)
    mem.enqueue("L1", "k", 1, 1, {"x": np.float32(2.5)}, ())
    assert mem.mark_inflight("L1", 0) == 1
    assert mem.requeue("L1") and mem.pending() == ["L1"]
    assert mem.stats()["durable"] is False


def test_value_codec_is_the_reference_codec():
    values = (np.arange(7, dtype=np.float32),
              np.linspace(-1, 1, 12, dtype=np.float64).reshape(3, 4),
              np.array([], dtype=np.int32),
              np.array([[1, 2], [3, 4]], dtype=np.uint8),
              np.float32(1.5), np.uint32(3), 2, 0.5, True, "s", None)
    for v in values:
        enc = port_fleet._encode_value(v)
        assert json.dumps(enc) == json.dumps(ref_fleet._encode_value(v))
        for dec in (port_fleet._decode_value, ref_fleet._decode_value):
            back = dec(json.loads(json.dumps(enc)))
            assert np.asarray(back).tobytes() == np.asarray(v).tobytes()
            assert np.asarray(back).dtype == np.asarray(v).dtype
    with pytest.raises(TypeError):
        port_fleet._encode_value(object())


# ---------------------------------------------------------------------------
# fault injector (in-process: the kill is recorded, not delivered)
# ---------------------------------------------------------------------------

class _Fired(Exception):
    pass


def _recording(cls, *a, **kw):
    inj = cls(*a, **kw)

    def kill():
        raise _Fired()

    inj._kill = kill
    return inj


def test_fault_injector_resolves_and_fires_as_the_reference(monkeypatch):
    plan = [{"point": MID_KERNEL, "worker": 1, "kernel": "k"},
            {"point": MID_KERNEL, "worker": 0, "kernel": "k", "nth": 2},
            {"point": PRE_LAUNCH, "worker": None, "kernel": "other"}]
    for wid in (0, 1, 2):
        for seed in (0, 7, 42):
            mine = FaultInjector(plan, wid, seed)._specs
            theirs = ref_fleet.FaultInjector(plan, wid, seed)._specs
            assert mine == theirs
    inj = _recording(FaultInjector, plan, 0, 42)
    inj.begin_launch("k", "L1")
    inj.on_segment("k", 10, "L1")             # armed on the 2nd match only
    inj.begin_launch("k", "L2")
    with pytest.raises(_Fired):
        inj.on_segment("k", inj._specs[0]["after_segments"], "L2")
    inj = _recording(FaultInjector, plan, 2, 0)
    inj.at_point(PRE_LAUNCH, "k")
    with pytest.raises(_Fired):
        inj.at_point(PRE_LAUNCH, "other")
    with pytest.raises(ValueError, match="unknown point"):
        FaultInjector([{"point": "nowhere"}])
    monkeypatch.setenv("HETGPU_FAULT_PLAN", json.dumps(plan))
    assert port_fleet.load_fault_plan() == plan
    monkeypatch.setenv("HETGPU_FAULT_PLAN", "[]")
    assert FaultInjector.from_env(0)._specs == []


# ---------------------------------------------------------------------------
# chaos: spawned CPU workers, kill -9 at every fault point (marker: fleet)
# ---------------------------------------------------------------------------

KERNELS = ("dyn_matmul", "decode_gemv")
_WAIT = 180.0
_oracle_cache = {}


def _example(kernel):
    prog, _oracle, grid, block, args, outs = ref_ks.example_launch(kernel)
    return ir.from_foreign(prog), grid, block, args, outs


def oracle_outputs(kernel):
    """The reference interpreter's run of the canonical example launch:
    the bits every fleet result is held to."""
    if kernel not in _oracle_cache:
        prog, _, grid, block, args, outs = ref_ks.example_launch(kernel)
        sess = ref.HetSession("interp", cache=ref.TranslationCache())
        fn = sess.load(prog).function()
        bound = {}
        for p in fn.params:
            v = args[p.name]
            if p.kind == "buffer":
                arr = np.asarray(v)
                bound[p.name] = sess.alloc(arr.size, arr.dtype) \
                    .copy_from_host(arr)
            else:
                bound[p.name] = v
        rec = fn.launch_async(grid, block, bound)
        assert sess.synchronize()
        _oracle_cache[kernel] = {n: rec.buffer(n).copy_to_host()
                                 for n in outs}
    return _oracle_cache[kernel]


def assert_bit_identical(ticket, kernel):
    for name, expect in oracle_outputs(kernel).items():
        got = ticket.result(name)
        assert got.dtype == expect.dtype
        assert np.array_equal(got, expect), \
            f"{kernel}.{name} diverged from the reference interpreter"


def _fleet(tmp_path, backends=("interp", "interp"), **kw):
    kw.setdefault("fault_plan", [])
    return FleetCoordinator(backends=backends, queue_dir=tmp_path / "q",
                            device="cpu", **kw)


def _plan_for(point, kernel):
    spec = {"point": point, "worker": 0, "kernel": kernel, "nth": 1}
    if point == MID_KERNEL:
        spec["after_segments"] = 2
    return [spec]


@pytest.mark.fleet
@pytest.mark.parametrize("kernel", KERNELS)
def test_happy_path_bit_identical(tmp_path, kernel):
    prog, grid, block, args, _ = _example(kernel)
    with _fleet(tmp_path, ("interp", "cuda")) as fleet:
        fleet.register(prog)
        tickets = [fleet.submit(kernel, grid, block, args)
                   for _ in range(3)]
        fleet.wait_all(timeout=_WAIT)
        for t in tickets:
            assert_bit_identical(t, kernel)
        st = fleet.fleet_stats()
        assert st["completed"] == 3 and st["duplicate_acks"] == 0
        assert st["retried"] == st["evacuated"] == st["workers_lost"] == 0
        assert st["queue"]["acked"] == 3 and not fleet.queue.unacked()


@pytest.mark.fleet
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("point", FAULT_POINTS)
def test_kill_point_replays_bit_identical(tmp_path, point, kernel):
    prog, grid, block, args, _ = _example(kernel)
    with _fleet(tmp_path, ("cuda", "interp"),
                fault_plan=_plan_for(point, kernel), fault_seed=42) as fleet:
        fleet.register(prog)
        ticket = fleet.submit(kernel, grid, block, args)
        fleet.wait_all(timeout=_WAIT)
        assert ticket.finished
        assert_bit_identical(ticket, kernel)
        st = fleet.fleet_stats()
        assert (st["workers_lost"], st["evacuated"], st["retried"],
                st["duplicate_acks"], st["completed"]) == (1, 1, 1, 0, 1)
        assert ticket.attempts == 2 and ticket.worker == 1
        assert st["queue"] == {"pending": 0, "inflight": 0, "acked": 1,
                               "total": 1, "durable": True}
        assert fleet.failures[0]["recovered"][ticket.launch_id] > 0


@pytest.mark.fleet
def test_mid_kernel_seed_resolved(tmp_path):
    kernel = "dyn_matmul"
    prog, grid, block, args, _ = _example(kernel)
    plan = [{"point": MID_KERNEL, "worker": 0, "kernel": kernel}]
    with _fleet(tmp_path, fault_plan=plan, fault_seed=7) as fleet:
        fleet.register(prog)
        ticket = fleet.submit(kernel, grid, block, args)
        fleet.wait_all(timeout=_WAIT)
        assert_bit_identical(ticket, kernel)
        assert fleet.fleet_stats()["workers_lost"] == 1


@pytest.mark.fleet
def test_multi_kill_schedule(tmp_path):
    kernel = "dyn_matmul"
    prog, grid, block, args, _ = _example(kernel)
    plan = [
        {"point": PRE_LAUNCH, "worker": 0, "kernel": kernel, "nth": 1},
        {"point": MID_KERNEL, "worker": 1, "kernel": kernel, "nth": 1,
         "after_segments": 1},
        {"point": POST_CHECKPOINT_PRE_ACK, "worker": 2, "kernel": kernel,
         "nth": 1},
    ]
    with _fleet(tmp_path, ("interp", "cuda", "interp", "cuda"),
                fault_plan=plan, fault_seed=42) as fleet:
        fleet.register(prog)
        tickets = [fleet.submit(kernel, grid, block, args)
                   for _ in range(6)]
        fleet.wait_all(timeout=_WAIT)
        for t in tickets:
            assert_bit_identical(t, kernel)
        st = fleet.fleet_stats()
        assert st["workers_lost"] == 3 and st["completed"] == 6
        assert st["duplicate_acks"] == 0
        assert st["evacuated"] >= 3 and st["retried"] >= 3
        assert st["queue"]["acked"] == 6 and not fleet.queue.unacked()


@pytest.mark.fleet
@pytest.mark.parametrize("kernel", KERNELS)
def test_evacuation_lands_on_other_backend(tmp_path, kernel):
    prog, grid, block, args, _ = _example(kernel)
    with _fleet(tmp_path, ("interp", "cuda"),
                fault_plan=_plan_for(MID_KERNEL, kernel),
                fault_seed=42) as fleet:
        fleet.register(prog)
        ticket = fleet.submit(kernel, grid, block, args)
        fleet.wait_all(timeout=_WAIT)
        assert ticket.worker == 1
        assert_bit_identical(ticket, kernel)


@pytest.mark.fleet
def test_graceful_drain_migrates_live_state(tmp_path):
    """drain() moves in-flight launches by checkpoint/restore from a
    ``cuda`` worker to an ``interp`` one — a migration, not a replay —
    and times each move."""
    kernel = "dyn_matmul"
    prog, grid, block, args, _ = _example(kernel)
    with _fleet(tmp_path, ("cuda", "interp"), slice_segments=1) as fleet:
        fleet.register(prog)
        tickets = [fleet.submit(kernel, grid, block, args)
                   for _ in range(4)]
        fleet.pump()
        victim_launches = len(fleet.workers[0].launches)
        assert victim_launches > 0
        moved = fleet.drain(0)
        assert moved == victim_launches
        fleet.wait_all(timeout=_WAIT)
        for t in tickets:
            assert_bit_identical(t, kernel)
            assert t.attempts == 1
        st = fleet.fleet_stats()
        assert st["migrated"] == moved
        assert st["retried"] == st["evacuated"] == 0
        assert len(fleet.migrations) == moved
        for m in fleet.migrations:
            assert (m["src"], m["dst"]) == (0, 1)
            assert m["checkpoint_ms"] > 0 and m["restore_ms"] > 0
            assert m["transfer_ms"] >= 0 and m["payload_bytes"] > 0


@pytest.mark.fleet
def test_rebalance_moves_load(tmp_path):
    kernel = "dyn_matmul"
    prog, grid, block, args, _ = _example(kernel)
    with _fleet(tmp_path, slice_segments=1) as fleet:
        fleet.register(prog)
        tickets = [fleet.submit(kernel, grid, block, args)
                   for _ in range(4)]
        fleet.pump()
        fleet.drain(0, shutdown=False)
        fleet.workers[0].draining = False
        assert len(fleet.workers[1].launches) >= 2
        assert fleet.rebalance() >= 1
        loads = [len(w.launches) for w in fleet.workers.values()]
        assert max(loads) - min(loads) <= 1
        fleet.wait_all(timeout=_WAIT)
        for t in tickets:
            assert_bit_identical(t, kernel)


@pytest.mark.fleet
def test_coordinator_restart_replays_unacked(tmp_path):
    kernel = "decode_gemv"
    prog, grid, block, args, _ = _example(kernel)
    fleet = _fleet(tmp_path, ("interp",), slice_segments=1)
    try:
        fleet.register(prog)
        lid = fleet.submit(kernel, grid, block, args).launch_id
        fleet.pump()
        assert fleet.queue.get(lid)["state"] == "inflight"
    finally:
        fleet.shutdown()
    with _fleet(tmp_path, ("cuda",)) as fleet2:
        recovered = fleet2.recover()
        assert [t.launch_id for t in recovered] == [lid]
        fleet2.register(prog)
        fleet2.wait_all(timeout=_WAIT)
        assert recovered[0].finished and recovered[0].attempts == 2
        assert_bit_identical(recovered[0], kernel)


@pytest.mark.fleet
def test_respawn_replaces_dead_worker(tmp_path):
    kernel = "dyn_matmul"
    prog, grid, block, args, _ = _example(kernel)
    with _fleet(tmp_path, fault_plan=_plan_for(PRE_LAUNCH, kernel),
                fault_seed=42, respawn=True) as fleet:
        fleet.register(prog)
        ticket = fleet.submit(kernel, grid, block, args)
        fleet.wait_all(timeout=_WAIT)
        assert_bit_identical(ticket, kernel)
        st = fleet.fleet_stats()
        assert (st["workers_lost"], st["workers_spawned"],
                st["alive_workers"]) == (1, 3, 2)


@pytest.mark.fleet
def test_evacuate_on_failure_policy(tmp_path):
    kernel = "dyn_matmul"
    prog, grid, block, args, _ = _example(kernel)
    with _fleet(tmp_path, slice_segments=1) as fleet:
        fleet.register(prog)
        tickets = [fleet.submit(kernel, grid, block, args)
                   for _ in range(2)]
        fleet.pump()
        victim = fleet.workers[0]
        owned = list(victim.launches)
        assert owned
        assert sorted(fleet.evacuate_on_failure(0, kill=True)) == \
            sorted(owned)
        assert not victim.alive
        fleet.wait_all(timeout=_WAIT)
        for t in tickets:
            assert_bit_identical(t, kernel)
        assert fleet.fleet_stats()["evacuated"] == len(owned)


@pytest.mark.fleet
def test_serving_front_end_over_fleet(tmp_path):
    kernel = "dyn_matmul"
    prog, grid, block, args, _ = _example(kernel)
    with _fleet(tmp_path, fault_plan=_plan_for(MID_KERNEL, kernel),
                fault_seed=42) as fleet:
        fleet.register(prog)
        front = port.ServingFrontEnd(fleet, default_quota=8)
        front.tenant("alpha", weight=2.0)
        front.tenant("beta")
        tickets = [front.submit("alpha", kernel, grid, block, args)
                   for _ in range(3)]
        tickets += [front.submit("beta", kernel, grid, block, args)
                    for _ in range(2)]
        assert front.drain(timeout=_WAIT)
        st = front.stats()
        assert st["admitted"] == st["completed"] == 5
        assert st["fleet"]["workers_lost"] == 1
        assert st["fleet"]["duplicate_acks"] == 0
        for t in tickets:
            assert t.done() and t.latency_ms is not None
            assert_bit_identical(t.record, kernel)


@pytest.mark.fleet
def test_fleet_prewarm_publishes_to_fabric(tmp_path):
    prog = ir.from_foreign(ref_ks.vadd()[0])
    shared = tmp_path / "fabric"
    with _fleet(tmp_path, ("interp",), shared_dir=shared) as fleet:
        fleet.register(prog)
        assert fleet.prewarm()["interp"]["translated"] > 0
    node = port.HetSession("interp", device="cpu", shared=str(shared))
    rep = node.warmup([prog], grids=((2, 32),))
    assert rep["translated"] == 0 and rep["restored"] > 0
    assert rep["fetched"] == rep["restored"]


# ---------------------------------------------------------------------------
# multi-process stores (marker: slow)
# ---------------------------------------------------------------------------

_WORKER = r"""
import json, os, sys, time
sys.path.insert(0, {src!r})
import numpy as np
from repro_torch.core.cache import DiskStore, TranslationCache, \
    register_reviver

root, out_path, nkeys, seed = sys.argv[1:5]
nkeys, seed = int(nkeys), int(seed)
register_reviver("mpstress", lambda p: p)
store = DiskStore(root, tag="stress")
cache = TranslationCache(store=store)

def make_translate(i):
    def translate():
        time.sleep(0.02)
        payload = {{"key": i, "data": [i * 3, i * 3 + 1]}}
        return payload, ("mpstress", payload)
    return translate

values = {{}}
for i in np.random.default_rng(seed).permutation(nkeys):
    i = int(i)
    values[i] = cache.get_or_translate(("mpstress", i), make_translate(i))
ok = all(values[i] == {{"key": i, "data": [i * 3, i * 3 + 1]}}
         for i in range(nkeys))
json.dump({{"ok": ok, "translated": cache.translated,
           "restored": cache.restored, "corrupt": store.corrupt}},
          open(out_path, "w"))
"""


@pytest.mark.slow
def test_nproc_get_or_translate_single_flight(tmp_path):
    nproc, nkeys = 6, 8
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(src=SRC))
    procs, outs = [], []
    for i in range(nproc):
        out = tmp_path / f"out{i}.json"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(tmp_path / "store"), str(out),
             str(nkeys), str(100 + i)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err.decode()
    results = [json.loads(o.read_text()) for o in outs]
    assert all(r["ok"] and r["corrupt"] == 0 for r in results)
    assert sum(r["translated"] for r in results) == nkeys
    assert all(r["translated"] + r["restored"] == nkeys for r in results)
    assert port.DiskStore(tmp_path / "store", tag="stress") \
        .entry_count() == nkeys


_REPUBLISHER = r"""
import sys
sys.path.insert(0, {src!r})
from repro_torch.core.cache import DiskStore

root, rounds = sys.argv[1], int(sys.argv[2])
store = DiskStore(root, tag="stress")
for n in range(rounds):
    store.save(("hot",), "kind", {{"round": n, "blob": "x" * (n % 7) * 512}})
"""


@pytest.mark.slow
def test_nproc_republish_never_tears(tmp_path):
    script = tmp_path / "writer.py"
    script.write_text(_REPUBLISHER.format(src=SRC))
    store = port.DiskStore(tmp_path / "store", tag="stress")
    store.save(("hot",), "kind", {"round": -1, "blob": ""})
    writers = [subprocess.Popen(
        [sys.executable, str(script), str(tmp_path / "store"), "200"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for _ in range(3)]
    reads = 0
    try:
        while any(p.poll() is None for p in writers):
            env = store.load(("hot",))
            assert env is not None, "torn or quarantined read"
            assert set(env["payload"]) == {"round", "blob"}
            reads += 1
    finally:
        for p in writers:
            _, err = p.communicate(timeout=60)
            assert p.returncode == 0, err.decode()
    assert store.corrupt == 0 and reads > 10


_TORN_PUBLISHER = r"""
import os, sys, time
from pathlib import Path
sys.path.insert(0, {src!r})
from repro_torch.core.cache import DiskStore, SharedStore, \
    TranslationCache, register_reviver

shared_dir, node_dir, marker = sys.argv[1:4]
register_reviver("mpstress", lambda p: p)
cache = TranslationCache(store=DiskStore(node_dir, tag="stress"),
                         shared=SharedStore(shared_dir, tag="stress"))
real_replace = os.replace
def torn_replace(srcp, dstp):
    if str(dstp).startswith(shared_dir):
        Path(marker).write_text("mid-publish")
        time.sleep(120)
    real_replace(srcp, dstp)
os.replace = torn_replace
cache.get_or_translate(("mpstress", "torn"),
                       lambda: ({{"v": 1}}, ("mpstress", {{"v": 1}})))
"""


@pytest.mark.slow
def test_sigkill_mid_publish_is_a_clean_miss(tmp_path):
    script = tmp_path / "torn.py"
    script.write_text(_TORN_PUBLISHER.format(src=SRC))
    shared_dir, marker = tmp_path / "fabric", tmp_path / "marker"
    proc = subprocess.Popen(
        [sys.executable, str(script), str(shared_dir), str(tmp_path / "n1"),
         str(marker)], stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    deadline = time.monotonic() + 60
    while not marker.exists():
        assert proc.poll() is None, proc.communicate()[1].decode()
        assert time.monotonic() < deadline, "publisher never reached rename"
        time.sleep(0.01)
    proc.kill()
    proc.wait(timeout=30)
    fab = next(p for p in shared_dir.iterdir() if p.is_dir())
    assert not list(fab.glob("*.tce"))
    torn = list(fab.glob("*.tmp"))
    assert torn
    shared = port.SharedStore(shared_dir, tag="stress")
    assert list(shared.dir.glob("*.tmp"))       # too fresh to sweep
    assert shared.fetch(("mpstress", "torn")) is None and shared.corrupt == 0
    old = time.time() - 7200
    os.utime(torn[0], (old, old))
    port.SharedStore(shared_dir, tag="stress")
    assert not list(shared.dir.glob("*.tmp"))
    port.register_reviver("mpstress", lambda p: p)
    c2 = port.TranslationCache(
        store=port.DiskStore(tmp_path / "n2", tag="stress"), shared=shared)
    assert c2.get_or_translate(
        ("mpstress", "torn"),
        lambda: ({"v": 2}, ("mpstress", {"v": 2}))) == {"v": 2}
    assert c2.translated == 1 and shared.publishes == 1


_CLUSTER_NODE = r"""
import json, sys
sys.path.insert(0, {src!r})
import numpy as np
from repro_torch.core import HetSession, kernels_suite as ks

shared, out = sys.argv[1:3]
s = HetSession("interp", device="cpu", shared=shared)
total = {{"translated": 0, "restored": 0, "fetched": 0, "errors": 0}}
for name in ("vadd", "dyn_matmul", "decode_gemv"):
    prog, _, grid, block, args, _ = ks.example_launch(name)
    rep = s.warmup([(prog, args)], grids=((grid, block),))
    for k in total:
        total[k] += rep[k]
json.dump(total, open(out, "w"))
"""


@pytest.mark.slow
def test_cluster_fabric_translate_once_fleet_wide(tmp_path):
    """Four fresh processes over one fabric translate each key exactly
    once between them; a late joiner translates nothing."""
    script = tmp_path / "node.py"
    script.write_text(_CLUSTER_NODE.format(src=SRC))
    fabric = tmp_path / "fabric"

    def run(n, tag):
        outs = [tmp_path / f"{tag}{i}.json" for i in range(n)]
        procs = [subprocess.Popen([sys.executable, str(script), str(fabric),
                                   str(o)], stderr=subprocess.PIPE)
                 for o in outs]
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err.decode()
        return [json.loads(o.read_text()) for o in outs]

    fleet = run(4, "node")
    keys = port.SharedStore(fabric).entry_count()
    assert all(r["errors"] == 0 for r in fleet)
    assert sum(r["translated"] for r in fleet) == keys > 0
    assert all(r["translated"] + r["restored"] == keys for r in fleet)
    (late,) = run(1, "late")
    assert late["translated"] == 0 and late["fetched"] == keys
