"""The port's deprecated string-keyed shim held against the reference's.

Each scenario of ``tests/test_deprecated_shim.py`` is driven identically
through the reference (``vectorized``, as that file runs it) and the port
(``interp``, and ``cuda`` on CPU tensors): every old-surface call must
raise the same ``DeprecationWarning`` text, and the buffers, shapes,
dtypes, launch history and errors must match, bits included.
"""
import warnings

import numpy as np
import pytest
import torch

import repro.core as ref
from repro.core import kernels_suite as ref_ks

import repro_torch.core as port
from repro_torch.core import kernels_suite as port_ks

torch.set_num_threads(1)

PORT_BACKENDS = ("interp", "cuda")


def _session(pkg, backend):
    if pkg is ref:
        return ref.HetSession("vectorized", cache=ref.TranslationCache())
    return port.HetSession(backend, device="cpu",
                           cache=port.TranslationCache())


def _suite(pkg):
    return ref_ks if pkg is ref else port_ks


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class _Log:
    """Every warning raised while the scenario runs, as (category,
    message), in order."""

    def __enter__(self):
        self._cm = warnings.catch_warnings(record=True)
        self.records = self._cm.__enter__()
        warnings.simplefilter("always")
        return self

    def __exit__(self, *exc):
        return self._cm.__exit__(*exc)

    def seen(self):
        return [(w.category.__name__, str(w.message)) for w in self.records]


def _every_legacy_method_warns(pkg, backend):
    prog, _ = _suite(pkg).vadd()
    s = _session(pkg, backend)
    calls = [lambda: s.load_kernel(prog),
             lambda: s.gpu_malloc("A", 64),
             lambda: s.memcpy_h2d("A", np.ones(64, np.float32)),
             lambda: s.memcpy_d2h("A"),
             lambda: (s.gpu_malloc("B", 64), s.gpu_malloc("C", 64),
                      s.launch("vadd", grid=2, block=32, args={"n": 64})),
             lambda: s.device_synchronize()]
    seen = []
    for call in calls:
        with _Log() as log:
            call()
        seen.append(log.seen())
    with _Log():
        out = s.memcpy_d2h("C")
    return {"warnings": seen, "C": out}


def _new_surface_does_not_warn(pkg, backend):
    s = _session(pkg, backend)
    with _Log() as log:
        fn = s.load(_suite(pkg).vadd()[0]).function()
        a = s.alloc(64).copy_from_host(np.ones(64, np.float32))
        b = s.alloc(64).copy_from_host(np.ones(64, np.float32))
        c = s.alloc(64)
        rec = fn.launch_async(2, 32, {"A": a, "B": b, "C": c, "n": 64},
                              stream=s.stream())
        s.synchronize()
        s.restore(fn, s.checkpoint(rec))
        s.synchronize()
    return {"warnings": [w for w in log.seen()
                         if w[0] == "DeprecationWarning"],
            "C": c.copy_to_host()}


def _legacy_end_to_end(pkg, backend):
    rng = np.random.default_rng(3)
    X = rng.normal(size=128).astype(np.float32)
    Y = rng.normal(size=128).astype(np.float32)
    old = _session(pkg, backend)
    with _Log() as log:
        old.load_kernel(_suite(pkg).saxpy()[0])
        old.gpu_malloc("X", 128)
        old.gpu_malloc("Y", 128)
        old.memcpy_h2d("X", X)
        old.memcpy_h2d("Y", Y)
        old.launch("saxpy", grid=4, block=32, args={"n": 128, "a": 0.7})
        got_old = old.memcpy_d2h("Y")
    new = _session(pkg, backend)
    fn = new.load(_suite(pkg).saxpy()[0]).function()
    x = new.alloc(128).copy_from_host(X)
    y = new.alloc(128).copy_from_host(Y)
    fn.launch(4, 32, {"X": x, "Y": y, "n": 128, "a": 0.7})
    assert np.array_equal(got_old, y.copy_to_host())
    return {"warnings": log.seen(), "Y": got_old,
            "launches": (old.stats["launches"], new.stats["launches"])}


def _stream_history_view(pkg, backend):
    s = _session(pkg, backend)
    A = np.random.default_rng(4).normal(size=64).astype(np.float32)
    with _Log() as log:
        s.load_kernel(_suite(pkg).vadd()[0])
        for name in "ABC":
            s.gpu_malloc(name, 64)
        s.memcpy_h2d("A", A)
        s.launch("vadd", grid=2, block=32, args={"n": 64})
    rec = s._streams[0][-1]
    return {"warnings": log.seen(), "history": len(s._streams[0]),
            "finished": rec.finished,
            "C": np.asarray(rec.engine.result("C"))}


def _nonblocking_engine_is_eager(pkg, backend):
    s = _session(pkg, backend)
    state = np.random.default_rng(5).normal(size=64).astype(np.float32)
    with _Log() as log:
        s.load_kernel(_suite(pkg).persistent_counter()[0])
        rec = s.launch("persistent_counter", grid=2, block=32,
                       args={"State": state.copy(), "iters": 6},
                       blocking=False)
        started = rec.started
        paused = rec.engine.run(max_segments=3)
        s.device_synchronize()
    return {"warnings": log.seen(), "started": started, "paused": paused,
            "finished": rec.finished,
            "State": np.asarray(rec.engine.result("State"))}


def _any_dtype_and_shape(pkg, backend):
    s = _session(pkg, backend)
    with _Log() as log:
        buf = s.gpu_malloc("A", (8, 16), dtype=np.float64)
        shape, dtype = tuple(buf.shape), _host(buf).dtype
        buf[2, 3] = 7.5                   # shape-intact view, writable
        a = s.memcpy_d2h("A")
        s.memcpy_h2d("B", np.ones((4, 4), np.float32))
        b = s.memcpy_d2h("B")
    return {"warnings": log.seen(), "shape": shape, "dtype": dtype, "A": a,
            "B": b, "B.shape": b.shape}


def _dtype_mismatch_writeback_rebinds(pkg, backend):
    s = _session(pkg, backend)
    A = np.random.default_rng(6).normal(size=64).astype(np.float32)
    with _Log() as log:
        s.load_kernel(_suite(pkg).vadd()[0])
        s.gpu_malloc("A", 64)
        s.gpu_malloc("B", 64)
        s.gpu_malloc("C", 64, dtype=np.int32)   # mismatched vs f32 param
        s.memcpy_h2d("A", A)
        s.launch("vadd", grid=2, block=32, args={"n": 64})
        out = s.memcpy_d2h("C")
    return {"warnings": log.seen(), "C": out, "C.dtype": out.dtype}


def _unknown_kernel_and_missing_arg(pkg, backend):
    s = _session(pkg, backend)
    errors = []
    with _Log() as log:
        for call in (lambda: s.launch("nope", grid=1, block=1, args={}),
                     lambda: s.load_kernel(_suite(pkg).vadd()[0]),
                     lambda: s.launch("vadd", grid=2, block=32,
                                      args={"n": 64})):
            try:
                call()
                errors.append(None)
            except (KeyError, ValueError) as exc:
                errors.append((type(exc).__name__, str(exc)))
    return {"warnings": log.seen(), "errors": errors}


SCENARIOS = {
    "every_legacy_method_warns": _every_legacy_method_warns,
    "new_surface_does_not_warn": _new_surface_does_not_warn,
    "legacy_end_to_end_matches_new_api": _legacy_end_to_end,
    "legacy_stream_history_view_preserved": _stream_history_view,
    "legacy_nonblocking_launch_engine_is_eager":
        _nonblocking_engine_is_eager,
    "legacy_any_dtype_and_shape_preserved": _any_dtype_and_shape,
    "legacy_dtype_mismatch_writeback_rebinds":
        _dtype_mismatch_writeback_rebinds,
    "legacy_unknown_kernel_and_missing_arg_errors":
        _unknown_kernel_and_missing_arg,
}


def _same(a, b):
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype \
            and a.shape == b.shape and a.tobytes() == b.tobytes()
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) \
            and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_shim_scenario_matches_reference(scenario, backend):
    want = SCENARIOS[scenario](ref, None)
    got = SCENARIOS[scenario](port, backend)
    assert sorted(got) == sorted(want)
    for key in want:
        assert _same(got[key], want[key]), (key, got[key], want[key])


def test_shim_warnings_name_each_old_call():
    seen = _every_legacy_method_warns(port, "interp")["warnings"]
    for call, msgs in zip(("load_kernel", "gpu_malloc", "memcpy_h2d",
                           "memcpy_d2h", r"launch(kernel",
                           "device_synchronize"), seen):
        dep = [m for c, m in msgs if c == "DeprecationWarning"]
        assert dep and all("deprecated" in m for m in dep), (call, msgs)
        assert any(m.startswith(f"HetSession.{call}") for m in dep), \
            (call, msgs)
