"""The port's serving tier held against the JAX package's.

``repro_torch.core.serving`` ports ``ServingFrontEnd``, ``TenantState``,
``ServeTicket`` and ``QuotaExceeded``.  Each scenario of the front end in
``tests/test_serving.py`` runs through the reference (``interp``) and the
port (``interp``, and ``cuda`` on CPU tensors — the plain version of its
segment kernels) and must make the same admission and shedding decisions,
give the same per-tenant segment counts and scheduler trace, and the same
output bits.  On the card a ticket completes when the event its launch
recorded after its last segment completes; that rule is held here with a
stand-in event.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.core as ref
from repro.core import kernels_suite as ref_ks

import repro_torch.core as port
from repro_torch.core import hetir as ir

RUNS = [("reference", "interp"), ("port", "interp"), ("port", "cuda")]


def _counter_session(pkg, backend, **kw):
    prog = ref_ks.persistent_counter()[0]
    if pkg == "reference":
        s = ref.HetSession(backend, cache=ref.TranslationCache(), **kw)
        return s, s.load(prog).function(), ref
    s = port.HetSession(backend, device="cpu", cache=port.TranslationCache(),
                        **kw)
    return s, s.load(ir.from_foreign(prog)).function(), port


def _state(s, value=0.0):
    return s.alloc(64).copy_from_host(np.full(64, value, np.float32))


def _segments(s, front):
    """Segments executed per tenant, from the scheduler trace."""
    by_sid = {t.stream.sid: name for name, t in front.tenants.items()}
    counts = {name: 0 for name in front.tenants}
    for e in s.sched_trace:
        if e["stream"] in by_sid:
            counts[by_sid[e["stream"]]] += 1
    return counts


def _decisions(front):
    st = front.stats()
    return {"admitted": st["admitted"], "rejected": st["rejected"],
            "completed": st["completed"], "inflight": st["inflight"],
            "tenants": [(t["tenant"], t["admitted"], t["rejected"],
                         t["completed"]) for t in st["tenants"]]}


def _quota(pkg, backend):
    s, fn, m = _counter_session(pkg, backend)
    front = m.ServingFrontEnd(s, default_quota=2)
    front.tenant("a")
    bufs = [_state(s) for _ in range(4)]
    front.submit("a", fn, 2, 32, {"State": bufs[0], "iters": 2})
    front.submit("a", fn, 2, 32, {"State": bufs[1], "iters": 2})
    with pytest.raises(m.QuotaExceeded) as ei:
        front.submit("a", fn, 2, 32, {"State": bufs[2], "iters": 2})
    assert ei.value.tenant == "a"
    t = front.tenants["a"]
    assert t.rejected == 1 and t.admitted == 2
    assert len(t.stream._q) == 2      # nothing extra was enqueued
    before = _decisions(front)
    assert front.drain()
    assert t.completed == 2           # shedding never cancels in-flight
    front.submit("a", fn, 2, 32, {"State": bufs[3], "iters": 2})
    assert front.drain()
    return (before, _decisions(front), _segments(s, front),
            [b.copy_to_host() for b in bufs])


def _global_cap(pkg, backend):
    s, fn, m = _counter_session(pkg, backend)
    front = m.ServingFrontEnd(s, max_inflight=3, default_quota=10)
    front.tenant("a")
    front.tenant("b")
    bufs = [_state(s) for _ in range(4)]
    for name, b in zip(("a", "b", "a"), bufs):
        front.submit(name, fn, 2, 32, {"State": b, "iters": 2})
    with pytest.raises(m.QuotaExceeded):
        front.submit("b", fn, 2, 32, {"State": bufs[3], "iters": 2})
    assert front.drain()
    st = front.stats()
    assert st["completed"] == 3 and st["rejected"] == 1
    return (_decisions(front), _segments(s, front),
            [b.copy_to_host() for b in bufs])


def _weighted(pkg, backend):
    """Two tenants with 1:3 weights: the share window, then run dry."""
    s, fn, m = _counter_session(pkg, backend, starvation_guard=0)
    front = m.ServingFrontEnd(s, slo_ms=60_000)
    front.tenant("small", weight=1.0)
    front.tenant("big", weight=3.0)
    assert front.tenant("big") is front.tenants["big"]   # idempotent
    tickets, bufs = [], []
    for _ in range(4):
        for name in ("small", "big"):
            bufs.append(_state(s, 1.0))
            tickets.append(front.submit(name, fn, 2, 32,
                                        {"State": bufs[-1], "iters": 6}))
    s.sched_trace.clear()
    front.pump(24)
    window = _segments(s, front)
    assert 0.60 <= window["big"] / sum(window.values()) <= 0.90, window
    while front.pump(16):
        pass
    assert all(t.done() for t in tickets)
    agg = front.stats()
    assert agg["completed"] == 8 and agg["inflight"] == 0
    assert agg["slo_violations"] == 0
    assert agg["p99_ms"] >= agg["p50_ms"] >= 0
    trace = [(e["stream"], e["kernel"], e["node_idx"])
             for e in s.sched_trace]
    return (window, _decisions(front), trace,
            [b.copy_to_host() for b in bufs])


@pytest.mark.parametrize("scenario", [_quota, _global_cap, _weighted],
                         ids=lambda f: f.__name__.strip("_"))
def test_front_end_decisions_equal_the_reference(scenario):
    results = {run: scenario(*run) for run in RUNS}
    want = results[RUNS[0]]
    for run in RUNS[1:]:
        got = results[run]
        assert got[:-1] == want[:-1], run
        for a, b in zip(got[-1], want[-1]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("backend", ["interp", "cuda"])
def test_retire_tenant_and_unknown_tenant(backend):
    s, fn, m = _counter_session("port", backend)
    front = m.ServingFrontEnd(s)
    with pytest.raises(KeyError):
        front.submit("ghost", fn, 2, 32, {})
    front.tenant("x")
    tk = front.submit("x", fn, 2, 32, {"State": _state(s), "iters": 2})
    with pytest.raises(RuntimeError, match="in-flight"):
        front.retire_tenant("x")
    front.drain()
    assert tk.done()
    n = len(s.streams)
    front.retire_tenant("x")
    assert len(s.streams) == n - 1 and "x" not in front.tenants
    front.retire_tenant("x")          # unknown tenant is a no-op


class _DeviceEvent:
    """Stands in for the CUDA event a launch records after its last
    segment: not complete until ``fire`` is called, then ``ms`` after the
    front end's epoch."""

    def __init__(self):
        self.complete, self.ms = False, None

    def query(self):
        return self.complete

    def fire(self, ms):
        self.complete, self.ms = True, ms


class _Epoch:
    def elapsed_time(self, end):
        return end.ms


def test_ticket_completes_when_its_device_event_does():
    """A launch the host has finished stays in flight — holding its quota
    slot, keeping ``pump`` busy — until its device event completes, and
    its latency ends at the event's time, not at the host's."""
    s, fn, m = _counter_session("port", "cuda")
    front = m.ServingFrontEnd(s, default_quota=1)
    front._epoch, front._epoch_host = _Epoch(), 1000.0
    front.tenant("a")
    tk = front.submit("a", fn, 2, 32, {"State": _state(s), "iters": 2})
    tk.submitted_at = 1000.5
    ev = _DeviceEvent()
    while not tk.record.finished:
        s.step(1)
    tk.record.done_event = ev
    assert front.pump(1) and not tk.done()
    with pytest.raises(m.QuotaExceeded):
        front.submit("a", fn, 2, 32, {"State": _state(s), "iters": 2})
    ev.fire(750.0)                    # the device finished at epoch + 0.75 s
    assert not front.pump(1) and tk.done()
    assert tk.latency_ms == pytest.approx(250.0)
    assert front.stats()["completed"] == 1


def test_chip_smoke_serving_scenario_on_the_cpu():
    """``chip_smoke.py`` phase 6 (c) at a small size on the ``cuda``
    backend's plain version: the fair-share window, steady-state pool
    reuse, every request's bits, and shedding that loses nothing."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    expected = chip_smoke.serving_expected(8)
    s, fn, _ = _counter_session("port", "cuda")
    load = chip_smoke.serve_scenario(s, fn, expected, 8, 160, 16)
    assert load["launches"] == load["completed"] == load["checked"] == 160
    assert load["lost"] == 0 and not load["wrong"]
    assert load["share_err"] <= chip_smoke.SERVE_SHARE_ERR
    assert load["steady_reuse"] >= chip_smoke.SERVE_REUSE
    shed = chip_smoke.shed_scenario(s, fn, expected, 8)
    assert shed["rejected"] == shed["counted"] > 0
    assert shed["lost"] == 0 and not shed["wrong"]
