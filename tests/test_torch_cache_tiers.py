"""The port's persistent translation tiers held against the JAX package's.

``repro_torch.core.cache`` ports ``DiskStore``, ``SharedStore`` and the
tiered ``TranslationCache`` of ``repro.core.cache``.  The scenarios of
``tests/test_persistent_cache.py`` and the directed (tier-1) cases of
``tests/test_multiprocess_cache.py`` run here through both packages —
reference ``interp`` against the port's ``interp`` — and must give the same
hits, misses, translations, restores, store misses and corrupt-entry
misses; the port's ``cuda`` backend (its plain version on CPU tensors) runs
the launches bit-equal beside them.  The ``"cuda-module"`` payload — an
``nvcc``-built segment library with its launch metadata — is written, read
back and revived from a store with ``nvcc`` replaced by a stub that writes
the library file.
"""
import ctypes.util
import json
import pickle
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import repro.core as ref
from repro.core import kernels_suite as ref_ks

import repro_torch.core as port
from repro_torch.core import cache as port_cache
from repro_torch.core import hetir as ir
from repro_torch.core import passes as port_passes
from repro_torch.core.backends import cuda_backend, nvcc_build

PKGS = {"reference": ref, "port": port}
COUNTERS = ("hits", "misses", "translated", "restored", "disk_misses")
STORE_COUNTERS = ("saves", "loads", "load_misses", "corrupt")


def _session(pkg, store=None, backend="interp", cache=None, **kw):
    cache = cache if cache is not None else pkg.TranslationCache(store=store)
    if pkg is ref:
        return ref.HetSession(backend, cache=cache, **kw)
    return port.HetSession(backend, device="cpu", cache=cache, **kw)


def _prog(pkg, name="vadd"):
    prog = ref_ks.lookup(name)()[0]
    return prog if pkg is ref else ir.from_foreign(prog)


def _vadd_args(n=128, seed=7):
    rng = np.random.default_rng(seed)
    return {"A": rng.normal(size=n).astype(np.float32),
            "B": rng.normal(size=n).astype(np.float32),
            "C": np.zeros(n, np.float32), "n": n}


def _launch(s, prog, grid, block, args, out="C"):
    fn = s.load(prog).function()
    bound = {}
    for p in fn.params:
        v = args[p.name]
        if p.kind == "buffer":
            arr = np.asarray(v)
            bound[p.name] = s.alloc(arr.size, arr.dtype).copy_from_host(arr)
        else:
            bound[p.name] = v
    rec = fn.launch_async(grid, block, bound)
    assert s.synchronize()
    return rec.buffer(out).copy_to_host()


def _counts(st):
    out = {k: st[k] for k in COUNTERS}
    if "store" in st:
        out.update({f"store.{k}": st["store"][k] for k in STORE_COUNTERS})
    return out


# ---------------------------------------------------------------------------
# key anatomy
# ---------------------------------------------------------------------------

def test_key_anatomy_matches_the_reference(tmp_path):
    """The same launch leaves the same keys, and so the same entry file
    names, in both packages' stores; only the runtime-tag directory
    differs (a store written by either package is a miss to the other)."""
    keys, names, tags = {}, {}, {}
    for label, pkg in PKGS.items():
        store = pkg.DiskStore(tmp_path)
        s = _session(pkg, store)
        _launch(s, _prog(pkg), 4, 32, _vadd_args())
        keys[label] = sorted(k for k, _ in store.iter_entries())
        names[label] = sorted(p.name for p in store.dir.glob("*.tce"))
        tags[label] = store.tag
    assert keys["port"] == keys["reference"] and keys["port"]
    fp = ir.program_fingerprint(_prog(port))
    assert all(k[:2] == ("interp", fp) for k in keys["port"])
    assert names["port"] == names["reference"]
    assert tags["port"] != tags["reference"]
    assert f"-p{port_passes.pipeline_fingerprint()}-" in tags["port"]
    assert port.DiskStore(tmp_path).load(keys["port"][0]) is not None
    assert port.DiskStore(tmp_path, tag=tags["reference"]).load(
        keys["port"][0]) is None     # a reference envelope: corrupt, a miss
    # the CUDA module key names the backend, the program and the lanes
    be = port.get_backend("cuda", device="cpu")
    assert be._module_key(_prog(port), 2) == (
        "cuda", fp, "module", 2, nvcc_build.codegen_tag())


# ---------------------------------------------------------------------------
# cross-instance restore: counter parity with the reference
# ---------------------------------------------------------------------------

def test_restore_counts_equal_the_reference(tmp_path):
    """Translate, drop the memory tier (a new cache on the same store),
    relaunch: both packages count the same hits, misses, translations,
    restores and store loads at every step, and the bits agree."""
    seen = {}
    for label, pkg in PKGS.items():
        root = tmp_path / label
        steps, outs = [], []
        for run in range(2):
            s = _session(pkg, pkg.DiskStore(root))
            prog = _prog(pkg)
            outs.append(_launch(s, prog, 4, 32, _vadd_args()))
            outs.append(_launch(s, prog, 2, 32, _vadd_args(64)))
            steps.append(_counts(s.cache_stats()))
        assert steps[1]["translated"] == 0
        assert steps[1]["restored"] == steps[0]["translated"]
        seen[label] = (steps, outs)
    assert seen["port"][0] == seen["reference"][0]
    for a, b in zip(seen["port"][1], seen["reference"][1]):
        np.testing.assert_array_equal(a, b)


def test_cuda_plain_version_runs_on_the_tiers(tmp_path):
    """The port's ``cuda`` backend on CPU tensors runs its plain version:
    with a store attached it gives interp's bits, builds no library, and
    its block-path verdicts stay in memory (nothing is persisted)."""
    store = port.DiskStore(tmp_path)
    want = _launch(_session(ref), _prog(ref), 4, 32, _vadd_args())
    for _ in range(2):
        s = _session(port, store, backend="cuda")
        got = _launch(s, _prog(port), 4, 32, _vadd_args())
        np.testing.assert_array_equal(got, want)
        st = s.cache_stats()
        assert st["translated"] > 0 and st["restored"] == 0
        assert s.backend.nvcc["built"] == 0
    assert store.entry_count() == 0


def test_restore_across_cache_instances_direct(tmp_path):
    for pkg in PKGS.values():
        store = pkg.DiskStore(tmp_path / pkg.__name__)
        c1 = pkg.TranslationCache(store=store)
        c1.get_or_translate(("interp", "fp", 0, 0),
                            lambda: ([1, 2, 3], ("interp-plan", [1, 2, 3])))
        c2 = pkg.TranslationCache(store=pkg.DiskStore(tmp_path
                                                      / pkg.__name__))
        calls = []
        val = c2.get_or_translate(("interp", "fp", 0, 0),
                                  lambda: (calls.append(1) or [], None))
        assert val == [1, 2, 3] and not calls
        assert c2.stats()["restored"] == 1 and c2.stats()["translated"] == 0


# ---------------------------------------------------------------------------
# atomic writes, corruption tolerance, invalidation
# ---------------------------------------------------------------------------

def test_atomic_writes_from_concurrent_threads(tmp_path):
    """Many threads translating into one store: temp file + rename, no
    torn entries, no leaked temp files; a fresh cache restores it all."""
    store = port.DiskStore(tmp_path)
    cache = port.TranslationCache(store=store)
    errors = []

    def worker(i):
        try:
            be = port.get_backend("interp", cache=cache, device="cpu")
            grid = 2 + (i % 3)
            port.Engine(_prog(port), be, grid, 32,
                        _vadd_args(grid * 32)).run()
        except Exception as exc:  # pragma: no cover - the assertion target
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads)
    assert not list(store.dir.glob("*.tmp")), "leaked temp files"
    fresh = port.TranslationCache(store=port.DiskStore(tmp_path))
    assert fresh.preload(backend="interp") >= 1


def test_corrupt_and_truncated_entries_are_misses_as_in_the_reference(
        tmp_path):
    seen = {}
    for label, pkg in PKGS.items():
        root = tmp_path / label
        store = pkg.DiskStore(root)
        _launch(_session(pkg, store), _prog(pkg), 4, 32, _vadd_args())
        files = sorted(store.dir.glob("*.tce"))
        assert files
        files[0].write_bytes(files[0].read_bytes()[
            : len(files[0].read_bytes()) // 2])
        for f in files[1:]:
            f.write_bytes(b"\x00garbage\xff")
        s2 = _session(pkg, pkg.DiskStore(root))
        _launch(s2, _prog(pkg), 4, 32, _vadd_args())   # must not raise
        st2 = _counts(s2.cache_stats())
        assert st2["translated"] >= 1 and st2["store.corrupt"] >= 1
        # corrupt files were quarantined and fresh entries re-persisted
        s3 = _session(pkg, pkg.DiskStore(root))
        _launch(s3, _prog(pkg), 4, 32, _vadd_args())
        st3 = _counts(s3.cache_stats())
        assert st3["translated"] == 0
        seen[label] = (st2, st3)
    assert seen["port"] == seen["reference"]


def test_version_mismatch_and_key_collision_are_misses(tmp_path):
    store = port.DiskStore(tmp_path)
    key = ("interp", "fp", 0, 0)
    store.save(key, "interp-plan", [1, 2, 3])
    path = store._path(key)
    env = pickle.loads(path.read_bytes())
    env["version"] = 999  # a future format
    path.write_bytes(pickle.dumps(env))
    assert store.load(key) is None
    assert store.stats()["corrupt"] == 1
    key_a, key_b = ("interp", "a", 0, 0), ("interp", "b", 0, 0)
    store.save(key_a, "interp-plan", [1])
    store._path(key_b).write_bytes(store._path(key_a).read_bytes())
    assert store.load(key_b) is None


def test_runtime_tag_isolates_stores(tmp_path):
    old = port.DiskStore(tmp_path, tag="v0-p0-torch0.0-cudanone-cpu")
    old.save(("interp", "fp", 0, 0), "interp-plan", [1])
    new = port.DiskStore(tmp_path)
    assert new.load(("interp", "fp", 0, 0)) is None
    assert new.entry_count() == 0 and old.entry_count() == 1


def test_pass_set_change_invalidates_persisted_entries(tmp_path,
                                                       monkeypatch):
    s1 = _session(port, port.DiskStore(tmp_path))
    _launch(s1, _prog(port), 4, 32, _vadd_args())
    old_tag = s1.cache.store.tag
    monkeypatch.setattr(port_passes, "_PASS_SCHEMA_VERSION", 10 ** 6)
    fresh = port.DiskStore(tmp_path)
    assert fresh.tag != old_tag and fresh.entry_count() == 0
    s2 = _session(port, fresh)
    _launch(s2, _prog(port), 4, 32, _vadd_args())
    st = s2.cache_stats()
    assert st["translated"] >= 1 and st["restored"] == 0


# ---------------------------------------------------------------------------
# sessions on the tiers
# ---------------------------------------------------------------------------

def test_session_accepts_same_path_store_and_refuses_another(tmp_path):
    def session(**kw):
        return port.HetSession("interp", device="cpu", cache=cache, **kw)

    cache = port.TranslationCache(store=port.DiskStore(tmp_path / "a"))
    session(store=port.DiskStore(tmp_path / "a"))
    with pytest.raises(ValueError, match="different store"):
        session(store=port.DiskStore(tmp_path / "b"))
    session(shared=str(tmp_path / "f"))
    assert cache.shared.root == tmp_path / "f"
    with pytest.raises(ValueError, match="different shared"):
        session(shared=str(tmp_path / "g"))
    s = port.HetSession("interp", device="cpu", store=str(tmp_path / "c"))
    assert s.cache is not port.global_cache()
    assert isinstance(s.cache.store, port.DiskStore)


def test_failed_store_write_degrades_to_memory_only(tmp_path, monkeypatch):
    store = port.DiskStore(tmp_path)

    def boom(*a, **k):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(store, "save", boom)
    cache = port.TranslationCache(store=store)
    val = cache.get_or_translate(
        ("interp", "fp", 0, 0), lambda: ("LIVE", ("interp-plan", "LIVE")))
    assert val == "LIVE" and cache.get(("interp", "fp", 0, 0)) == "LIVE"
    assert cache.stats()["persist_errors"] == 1


def test_global_cache_honours_the_env(tmp_path, monkeypatch):
    monkeypatch.setattr(port_cache, "_GLOBAL_CACHE",
                        port.TranslationCache())
    monkeypatch.setenv("HETGPU_CACHE_DIR", str(tmp_path / "local"))
    monkeypatch.setenv("HETGPU_CACHE_SHARED_DIR", str(tmp_path / "fabric"))
    monkeypatch.setenv("HETGPU_CACHE_SHARED_MAX_BYTES", "4321")
    c = port.global_cache()
    assert c.store.root == tmp_path / "local"
    assert c.shared.root == tmp_path / "fabric"
    assert c.shared.max_bytes == 4321 and c.store.max_bytes == 0


def test_warmup_translates_then_restores_as_the_reference(tmp_path):
    seen = {}
    for label, pkg in PKGS.items():
        progs = [_prog(pkg), (_prog(pkg, "saxpy"),
                              {"X": np.ones(64, np.float32),
                               "Y": np.ones(64, np.float32),
                               "n": 64, "a": 2.0})]
        reps = []
        for _ in range(2):
            s = _session(pkg, pkg.DiskStore(tmp_path / label))
            rep = s.warmup(progs, grids=((2, 32),))
            assert rep["errors"] == 0
            reps.append({k: rep[k] for k in ("translated", "restored",
                                             "cache_hits", "fetched")})
        assert reps[0]["translated"] >= 2 and reps[0]["restored"] == 0
        assert reps[1]["translated"] == 0
        assert reps[1]["restored"] == reps[0]["translated"]
        seen[label] = reps
    assert seen["port"] == seen["reference"]


def test_migrate_warms_destination_from_store(tmp_path):
    """A destination whose store saw this program pays no translation on
    migration: the port's ``cuda`` launch (plain version) migrates to an
    ``interp`` session on a warm store and finishes with interp's bits."""
    args = _vadd_args()
    hist = _session(port, port.DiskStore(tmp_path))
    want = _launch(hist, _prog(port), 4, 32, args)
    src = _session(port, backend="cuda")
    dst = _session(port, port.DiskStore(tmp_path))
    fn = src.load(_prog(port)).function()
    dst.load(_prog(port))
    bound = {p.name: (src.alloc(64 * 2).copy_from_host(args[p.name])
                      if p.kind == "buffer" else args[p.name])
             for p in fn.params}
    rec = fn.launch_async(4, 32, bound)
    new = port.migrate(rec, src, dst, "vadd")
    assert dst.stats["last_migration"]["cache_restored"] >= 1
    assert new.wait()
    assert dst.cache_stats()["translated"] == 0
    np.testing.assert_array_equal(new.buffer("C").copy_to_host(), want)


# ---------------------------------------------------------------------------
# cost-aware (GDSF) eviction, memory and disk, against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("label", PKGS)
def test_memory_eviction_is_gdsf(label):
    pkg = PKGS[label]
    c = pkg.TranslationCache(capacity=2)
    c.put("expensive", "E", cost_ms=500.0, size_bytes=10)
    c.put("cheap-1", "c1", cost_ms=0.01, size_bytes=10)
    c.put("cheap-2", "c2", cost_ms=0.01, size_bytes=10)
    assert c.stats()["evictions"] == 1
    assert c.get("expensive") == "E" and c.get("cheap-1") is None
    # the size term: the same cost over more bytes scores lower
    c = pkg.TranslationCache(capacity=2)
    c.put("big", "B", cost_ms=50.0, size_bytes=10_000)
    c.put("small", "S", cost_ms=50.0, size_bytes=10)
    c.put("new", "N", cost_ms=50.0, size_bytes=100)
    assert c.get("big") is None and c.get("small") == "S"
    # the clock ages out an idle entry; ties fall back to LRU
    c = pkg.TranslationCache(capacity=2)
    c.put("old", "O", cost_ms=1.0, size_bytes=1000)
    for i in range(50):
        c.put(f"k{i}", i, cost_ms=50.0, size_bytes=10)
    assert c.get("old") is None
    c = pkg.TranslationCache(capacity=2)
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1
    c.put("c", 3)
    assert c.get("b") is None and c.get("a") == 1 and c.get("c") == 3


def _blob(i, n=1024):
    return bytes([i % 256]) * n


def test_disk_gc_order_under_max_bytes_equals_the_reference(tmp_path):
    survivors = {}
    for label, pkg in PKGS.items():
        store = pkg.DiskStore(tmp_path / label, tag="t", max_bytes=8_000)
        exp_key = ("cuda", "exp", "module", 1)
        store.save(exp_key, "interp-plan", _blob(0), cost_ms=5000.0)
        for i in range(30):
            store.save(("interp", f"cheap{i}", 0, 0), "interp-plan",
                       _blob(i), cost_ms=float(i % 4))
            assert store.total_bytes() <= 8_000
        assert store.load(exp_key) is not None
        st = store.stats()
        assert st["gc_evictions"] > 0 and st["gc_runs"] > 0
        survivors[label] = sorted(k for k, _ in store.iter_entries())
    assert survivors["port"] == survivors["reference"]


def test_disk_bound_from_env_and_explicit_gc(tmp_path, monkeypatch):
    monkeypatch.setenv("HETGPU_CACHE_MAX_BYTES", "12345")
    assert port.DiskStore(tmp_path).max_bytes == 12345
    monkeypatch.delenv("HETGPU_CACHE_MAX_BYTES")
    store = port.DiskStore(tmp_path)
    assert store.max_bytes == 0
    for i in range(10):
        store.save(("interp", f"fp{i}", 0, 0), "interp-plan", _blob(i))
    assert store.entry_count() == 10
    assert store.gc() == 0              # no bound: a no-op
    assert store.gc(limit=4_000) > 0
    assert store.total_bytes() <= 4_000


def test_bounded_store_still_serves_the_working_set(tmp_path):
    store = port.DiskStore(tmp_path, max_bytes=4096)
    s = _session(port, store)
    got = _launch(s, _prog(port), 4, 32, _vadd_args())
    assert store.total_bytes() <= 4096
    np.testing.assert_array_equal(
        got, _launch(_session(ref), _prog(ref), 4, 32, _vadd_args()))


# ---------------------------------------------------------------------------
# locking: single flight, quarantine, orphan-lock sweep, the fabric
# ---------------------------------------------------------------------------

def test_lock_is_exclusive_per_key(tmp_path):
    store = port.DiskStore(tmp_path, tag="t")
    order = []

    def hold(key, label, dwell):
        with store.lock(key) as locked:
            assert locked
            order.append(("enter", label))
            time.sleep(dwell)
            order.append(("exit", label))

    t1 = threading.Thread(target=hold, args=("k", "a", 0.15))
    t1.start()
    time.sleep(0.05)
    hold("other", "other", 0.0)         # a different key does not contend
    hold("k", "b", 0.0)                 # the same key waits for the holder
    t1.join(timeout=10)
    assert order.index(("exit", "a")) < order.index(("enter", "b"))
    assert list(store.dir.glob("*.lock"))


def test_single_flight_translation_threads(tmp_path):
    port.register_reviver("mpstress", lambda p: p)
    store = port.DiskStore(tmp_path, tag="t")
    caches = [port.TranslationCache(store=store) for _ in range(2)]
    started = threading.Barrier(2)
    calls = []

    def translate():
        calls.append(1)
        time.sleep(0.1)
        return {"v": 42}, ("mpstress", {"v": 42})

    def run(cache):
        started.wait()
        assert cache.get_or_translate(("mpstress", "k"),
                                      translate) == {"v": 42}

    ts = [threading.Thread(target=run, args=(c,)) for c in caches]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10)
    assert len(calls) == 1
    assert sum(c.translated for c in caches) == 1
    assert sum(c.restored for c in caches) == 1


def test_single_flight_opt_out(tmp_path, monkeypatch):
    monkeypatch.setenv("HETGPU_CACHE_SINGLE_FLIGHT", "0")
    port.register_reviver("mpstress", lambda p: p)
    store = port.DiskStore(tmp_path, tag="t")
    cache = port.TranslationCache(store=store)
    assert cache.get_or_translate(("mpstress", "x"),
                                  lambda: (1, ("mpstress", 1))) == 1
    assert cache.translated == 1 and not list(store.dir.glob("*.lock"))


def test_quarantine_spares_a_republished_entry(tmp_path, monkeypatch):
    store = port.DiskStore(tmp_path, tag="t")
    key = ("k",)
    path = store._path(key)
    path.write_bytes(b"garbage \x00 bytes")
    real_read = type(path).read_bytes
    healthy = {"done": False}

    def read_then_republish(self):
        blob = real_read(self)
        if self == path and not healthy["done"]:
            healthy["done"] = True
            store.save(key, "kind", {"ok": True})
        return blob

    monkeypatch.setattr(type(path), "read_bytes", read_then_republish)
    assert store.load(key) is None
    monkeypatch.undo()
    assert store.corrupt == 1
    assert store.load(key)["payload"] == {"ok": True}
    # stable corruption is unlinked
    path.write_bytes(b"garbage")
    assert store.load(key) is None and not path.exists()


def test_gc_sweeps_orphan_locks_but_never_a_held_one(tmp_path):
    store = port.DiskStore(tmp_path, tag="t")
    store.save(("live",), "kind", {"v": 1})
    with store.lock(("live",)):
        pass
    with store.lock(("orphan",)):
        pass
    entered, release = threading.Event(), threading.Event()

    def hold():
        with store.lock(("held",)):
            entered.set()
            release.wait(5)

    t = threading.Thread(target=hold)
    t.start()
    assert entered.wait(5)
    store.gc()
    assert store.lock_sweeps == 1       # the orphan; the held one survives
    assert len(list(store.dir.glob("*.lock"))) == 2
    release.set()
    t.join(timeout=10)
    store.gc()
    remaining = list(store.dir.glob("*.lock"))
    assert store.lock_sweeps == 2 and len(remaining) == 1
    assert remaining[0].with_suffix(".tce").exists()


def test_shared_tier_fetch_on_miss_and_replicate(tmp_path):
    port.register_reviver("mpstress", lambda p: p)
    shared = port.SharedStore(tmp_path / "fabric", tag="t")
    key = ("mpstress", "k")

    def boom():
        raise AssertionError("the fleet already translated this key")

    c1 = port.TranslationCache(store=port.DiskStore(tmp_path / "n1",
                                                    tag="t"), shared=shared)
    assert c1.get_or_translate(
        key, lambda: ({"v": 7}, ("mpstress", {"v": 7}))) == {"v": 7}
    assert shared.publishes == 1 and c1.shared_publishes == 1
    store2 = port.DiskStore(tmp_path / "n2", tag="t")
    c2 = port.TranslationCache(store=store2, shared=shared)
    assert c2.get_or_translate(key, boom) == {"v": 7}
    assert (c2.translated, c2.restored, c2.shared_fetches,
            c2.replicated) == (0, 1, 1, 1)
    c3 = port.TranslationCache(store=store2)
    assert c3.get_or_translate(key, boom) == {"v": 7}
    # preload from the fabric replicates like a fetch
    c4 = port.TranslationCache(store=port.DiskStore(tmp_path / "n4",
                                                    tag="t"), shared=shared)
    assert c4.preload(backend="mpstress") == 1
    assert c4.shared_fetches == 1 and c4.replicated == 1


# ---------------------------------------------------------------------------
# the CUDA backend's "cuda-module" entries
# ---------------------------------------------------------------------------

class _StubModule:
    def __init__(self, path, kernels):
        self.path, self.kernels = path, kernels


@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    """``nvcc`` replaced by a stub that writes a library file of known
    bytes, ``ctypes`` loading by a record of the path, the build directory
    by a temporary one."""
    monkeypatch.setattr(nvcc_build, "BUILD_DIR", tmp_path / "build")
    runs = []

    def build(jobs):
        paths, built = [], 0
        for src, so, _ in jobs:
            paths.append(so)
            if not so.exists():
                so.parent.mkdir(parents=True, exist_ok=True)
                so.write_bytes(b"\x7fELF stub " + src.encode()[:64])
                built += 1
                runs.append(so)
        return {"paths": paths, "built": built, "seconds": 0.5, "logs": {}}

    monkeypatch.setattr(nvcc_build, "build", build)
    monkeypatch.setattr(cuda_backend, "_Module", _StubModule)
    return runs


def test_cuda_module_round_trip_through_a_store(tmp_path, stub_nvcc):
    progs = [_prog(port, "vadd"), _prog(port, "reduction")]
    store = port.DiskStore(tmp_path / "store")
    be = port.get_backend("cuda", device="cpu",
                          cache=port.TranslationCache(store=store))
    rep = be.prebuild(progs)
    assert rep["modules"] == 2 and rep["built"] == 2 == len(stub_nvcc)
    assert be.nvcc["built"] == 2 and be.cache.stats()["translated"] == 2
    assert len(be.modules()) == 2
    mods = [be._module(p) for p in progs]       # memory hits
    assert be.cache.stats()["hits"] >= 2
    envs = [store.load(be._module_key(p, 1)) for p in progs]
    for p, env, mod in zip(progs, envs, mods):
        assert env["kind"] == "cuda-module"
        payload = env["payload"]
        src, kernels = cuda_backend.emit_module(p)
        assert payload["name"] == nvcc_build.library_path(src).name \
            == mod.path.name
        assert payload["library"] == mod.path.read_bytes()
        assert sorted(payload["kernels"]) == sorted(kernels)
        for i, k in kernels.items():
            got = payload["kernels"][i]
            assert (got.slots.inputs, got.slots.outputs, got.serial,
                    got.scratch, got.staged, got.tree_folds,
                    got.has_block) == (k.slots.inputs, k.slots.outputs,
                                       k.serial, k.scratch, k.staged,
                                       k.tree_folds, k.has_block)
        mod.path.unlink()              # a node with an empty build dir
    # a fresh process on the same store: restored, no nvcc, libraries
    # written back under their hashed names with the same bytes
    be2 = port.get_backend("cuda", device="cpu",
                           cache=port.TranslationCache(store=store))
    rep2 = be2.prebuild(progs)
    assert rep2["built"] == 0 and len(stub_nvcc) == 2
    st = be2.cache.stats()
    assert (st["translated"], st["restored"], st["libraries_written"]) \
        == (0, 2, 2)
    for p, env in zip(progs, envs):
        mod = be2._module(p)
        assert mod.path.read_bytes() == env["payload"]["library"]
    # a library already on disk is not rewritten
    be3 = port.get_backend("cuda", device="cpu",
                           cache=port.TranslationCache(store=store))
    be3.prebuild(progs)
    assert be3.cache.stats()["libraries_written"] == 0
    assert be3.cache.stats()["restored"] == 2


def test_cuda_module_through_the_fabric_and_a_migration(tmp_path,
                                                        stub_nvcc):
    """A module published to the fabric is fetched by a node with no
    store, and ``migrate`` preloads it on a ``cuda`` destination."""
    prog = _prog(port, "vadd")
    fabric = tmp_path / "fabric"
    pub = port.get_backend("cuda", device="cpu", cache=port.TranslationCache(
        shared=port.SharedStore(fabric)))
    pub._module(prog)
    assert pub.cache.stats()["shared_publishes"] == 1
    src = _session(port, backend="interp", cache=port.TranslationCache(
        shared=port.SharedStore(fabric)))
    dst = _session(port, backend="cuda")
    fn = src.load(prog).function()
    dst.load(prog)
    args = _vadd_args()
    bound = {p.name: (src.alloc(128).copy_from_host(args[p.name])
                      if p.kind == "buffer" else args[p.name])
             for p in fn.params}
    rec = fn.launch_async(4, 32, bound)
    new = port.migrate(rec, src, dst, "vadd")
    # the destination has no tiers: it preloads from the source's fabric
    assert dst.stats["last_migration"]["cache_restored"] == 1
    assert len(stub_nvcc) == 1
    assert new.wait()
    np.testing.assert_array_equal(new.buffer("C").copy_to_host(),
                                  args["A"] + args["B"])


def test_install_library_writes_only_a_missing_file(tmp_path, monkeypatch):
    monkeypatch.setattr(nvcc_build, "BUILD_DIR", tmp_path)
    path, written = nvcc_build.install_library("het_ab.so", b"one")
    assert written and path.read_bytes() == b"one"
    path, written = nvcc_build.install_library("het_ab.so", b"two")
    assert not written and path.read_bytes() == b"one"
    assert not list(tmp_path.glob("*.tmp"))
    for bad in ("../het_ab.so", "het_ab.txt"):
        with pytest.raises(ValueError):
            nvcc_build.install_library(bad, b"x")
    # one ctypes handle per library path in a process
    libm = ctypes.util.find_library("m")
    assert cuda_backend._load_library(libm) is \
        cuda_backend._load_library(libm)


def _repro_torch_modules(root):
    """The modules of ``repro_torch`` that ``root`` reaches through its
    globals: imported modules, and the home modules of imported functions
    and classes."""
    seen, todo = set(), [root]
    while todo:
        mod = todo.pop()
        if mod.__name__ in seen:
            continue
        seen.add(mod.__name__)
        for value in vars(mod).values():
            name = (value.__name__ if isinstance(value, type(sys))
                    else getattr(value, "__module__", None))
            if isinstance(name, str) and name.startswith("repro_torch") \
                    and name not in seen:
                todo.append(sys.modules[name])
    return {sys.modules[n] for n in seen}


def test_codegen_tag_covers_the_translator(tmp_path):
    """Every module the CUDA emitter reaches is hashed into the module
    key's ``codegen_tag``, and an edit to any of them (or to the device
    runtime header) changes the tag."""
    sources = set(nvcc_build.codegen_sources())
    reached = {Path(m.__file__).resolve()
               for m in _repro_torch_modules(cuda_backend)}
    assert {Path(port_passes.__file__).resolve(),
            Path(port_cache.__file__).resolve()} <= reached
    assert reached <= sources, sorted(map(str, reached - sources))
    root = nvcc_build.CSRC.parent
    copy = tmp_path / "repro_torch"
    for path in sources:
        dst = copy / path.relative_to(root)
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_bytes(path.read_bytes())
    copied = [copy / p.relative_to(root) for p in nvcc_build.codegen_sources()]
    assert nvcc_build.digest_sources(copied, copy) == nvcc_build.codegen_tag()
    for rel in ("core/alias.py", "core/passes.py",
                "core/backends/semantics.py", "csrc/hetir_rt.cuh"):
        edited = copy / rel
        before = edited.read_bytes()
        edited.write_bytes(before + b"\n")
        assert nvcc_build.digest_sources(copied, copy) \
            != nvcc_build.codegen_tag(), rel
        edited.write_bytes(before)


def test_a_changed_translator_misses_the_module_entry(tmp_path, stub_nvcc,
                                                      monkeypatch):
    """A ``"cuda-module"`` entry written under one ``codegen_tag`` is a
    store miss to a translator with another: the module is translated
    again, never revived."""
    prog = _prog(port, "vadd")
    store = port.DiskStore(tmp_path / "store")
    be = port.get_backend("cuda", device="cpu",
                          cache=port.TranslationCache(store=store))
    be._module(prog)
    assert be.cache.stats()["translated"] == 1
    same = port.get_backend("cuda", device="cpu",
                            cache=port.TranslationCache(store=store))
    same._module(prog)
    assert (same.cache.stats()["restored"],
            same.cache.stats()["translated"]) == (1, 0)
    monkeypatch.setattr(nvcc_build, "codegen_tag", lambda: "0" * 16)
    other = port.get_backend("cuda", device="cpu",
                             cache=port.TranslationCache(store=store))
    other._module(prog)
    st = other.cache.stats()
    assert (st["restored"], st["translated"], st["disk_misses"]) == (0, 1, 1)


def test_chip_smoke_phase6_cold_and_warm_children(tmp_path, stub_nvcc,
                                                  capsys):
    """``chip_smoke.py`` phase 6 (a), rehearsed on the CPU with the stub
    ``nvcc``: the cold process builds one library per module through the
    cache, the warm one (libraries removed) restores every module, writes
    the libraries back and builds nothing; both run every canonical launch
    bit-equal to the interpreter, with the same output digest."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    def child(role):
        chip_smoke.phase6_child(role, str(tmp_path / "store"), device="cpu")
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    cold = child("cold")
    assert not cold["mismatches"] and cold["modules"] > 21
    assert cold["built"] == cold["translated"] == cold["modules"]
    warm = child("warm")
    assert not warm["mismatches"] and warm["digest"] == cold["digest"]
    assert (warm["built"], warm["translated"]) == (0, 0)
    assert warm["restored"] == warm["libraries_written"] == cold["modules"]


def test_chip_smoke_phase6_fabric_children(tmp_path, stub_nvcc, capsys):
    """``chip_smoke.py`` phase 6 (b), rehearsed on the CPU with the stub
    ``nvcc``: fabric processes with build directories of their own — the
    first builds every module and publishes it, the next builds nothing
    and fetches every module; a library reaches it only through the
    fabric."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    def child(i):
        chip_smoke.phase6_child("fabric", str(tmp_path / "fabric"),
                                str(tmp_path / f"build{i}"), device="cpu")
        return json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    first, second = child(0), child(1)
    modules = first["modules"]
    assert not first["mismatches"] and not second["mismatches"]
    assert first["built"] == first["translated"] == first["published"] \
        == modules
    assert (second["built"], second["translated"]) == (0, 0)
    assert second["fetched"] == second["restored"] == modules
    assert second["digest"] == first["digest"]
    assert len(list((tmp_path / "build1").glob("*.so"))) == modules
