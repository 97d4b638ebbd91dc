"""The port's stream scheduler held against the reference's, entry for entry.

The segment scheduler (priorities, weighted fair share, quanta, events,
pause, checkpoint/restore) is deterministic and backend-independent, so
each scenario below — the shapes of ``tests/test_streams.py`` and
``tests/test_driver_api.py`` — is driven identically through both
packages (reference ``interp``; port ``cuda`` on CPU tensors) and must
produce the same ``sched_trace`` (stream, kernel, seq, node_idx) and the
same output bits.
"""
import numpy as np
import pytest

import repro.core as ref
from repro.core import kernels_suite as ref_ks

import repro_torch.core as port
from repro_torch.core import hetir as ir


def _session(pkg):
    if pkg is ref:
        return ref.HetSession("interp", cache=ref.TranslationCache())
    return port.HetSession("cuda", device="cpu", cache=port.TranslationCache())


def _prog(pkg, name):
    prog = ref_ks.lookup(name)()[0]
    return prog if pkg is ref else ir.from_foreign(prog)


def _state(s, seed):
    init = np.random.default_rng(seed).normal(size=64).astype(np.float32)
    return s.alloc(64).copy_from_host(init)


def _interleave(pkg):
    s = _session(pkg)
    fn = s.load(_prog(pkg, "persistent_counter")).function()
    st1, st2 = s.stream(), s.stream(weight=2.0)
    b1, b2 = _state(s, 1), _state(s, 2)
    fn.launch_async(2, 32, {"State": b1, "iters": 6}, stream=st1)
    fn.launch_async(2, 32, {"State": b2, "iters": 6}, stream=st2)
    assert s.synchronize()
    return s, [b1, b2]


def _priorities(pkg):
    s = _session(pkg)
    s.starvation_guard = 4
    fn = s.load(_prog(pkg, "persistent_counter")).function()
    lo, hi = s.stream(priority=0), s.stream(priority=1, quantum=2)
    zero = s.stream(weight=0.0)
    bufs = [_state(s, i) for i in range(3)]
    for st, b in zip((lo, hi, zero), bufs):
        fn.launch_async(2, 32, {"State": b, "iters": 5}, stream=st)
    assert s.synchronize()
    return s, bufs


def _events(pkg):
    s = _session(pkg)
    pc = s.load(_prog(pkg, "persistent_counter")).function()
    va = s.load(_prog(pkg, "vadd")).function()
    st1, st2 = s.stream(), s.stream()
    state, c = _state(s, 3), s.alloc(64)
    pc.launch_async(2, 32, {"State": state, "iters": 5}, stream=st1)
    ev = st1.record_event()
    st2.wait_event(ev)
    va.launch_async(2, 32, {"A": state, "B": state, "C": c, "n": 64},
                    stream=st2)
    assert s.synchronize() and ev.query()
    return s, [state, c]


def _pause_checkpoint(pkg):
    s = _session(pkg)
    fn = s.load(_prog(pkg, "persistent_counter")).function()
    st1, st2 = s.stream(), s.stream()
    b1, b2 = _state(s, 4), _state(s, 5)
    r1 = fn.launch_async(2, 32, {"State": b1, "iters": 8}, stream=st1)
    fn.launch_async(2, 32, {"State": b2, "iters": 8}, stream=st2)
    s.step(2)
    st1.pause()
    assert s.synchronize() is False
    blob = s.checkpoint(r1)
    r1.cancel()
    st1.resume()
    s.restore("persistent_counter", blob, stream=st1)
    assert s.synchronize()
    return s, [b1, b2]


def _async_copies(pkg):
    s = _session(pkg)
    fn = s.load(_prog(pkg, "decode_gemv")).function()
    st = s.stream(quantum=3)
    rng = np.random.default_rng(6)
    w = s.alloc(64 * 32)
    w.copy_from_host_async(rng.normal(size=64 * 32).astype(np.float32),
                           stream=st)
    x, r, out = s.alloc(32), s.alloc(64), s.alloc(64)
    x.copy_from_host(rng.normal(size=32).astype(np.float32))
    r.copy_from_host(rng.normal(size=64).astype(np.float32))
    fn.launch_async(4, 16, {"W": w, "X": x, "R": r, "Out": out, "K": 32,
                            "ktiles": 4}, stream=st)
    d2h = out.copy_to_host_async(stream=st)
    assert s.synchronize()
    return s, [out, d2h.result()]


SCENARIOS = {"interleave": _interleave, "priorities": _priorities,
             "events": _events, "pause_checkpoint": _pause_checkpoint,
             "async_copies": _async_copies}


def _trace(s):
    return [(t["stream"], t["kernel"], t["seq"], t["node_idx"])
            for t in s.sched_trace]


def _bits(x):
    arr = x if isinstance(x, np.ndarray) else x.copy_to_host()
    return np.asarray(arr, np.float32).view(np.uint32)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_sched_trace_matches_reference(scenario):
    ref_s, ref_out = SCENARIOS[scenario](ref)
    port_s, port_out = SCENARIOS[scenario](port)
    assert _trace(port_s) == _trace(ref_s)
    assert len(ref_s.sched_trace) > 0
    for a, b in zip(port_out, ref_out):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    for key in ("segments_executed", "launches", "async_copies"):
        assert port_s.stats[key] == ref_s.stats[key], key
