"""Shared translation cache (paper §4.2, Module Loading and JIT).

The paper's runtime JIT-translates each hetIR segment to the target's
native code and "caches these translated kernels, so subsequent launches of
the same kernel do not pay the translation cost again."
:class:`TranslationCache` is that cache: one process-wide table, shared by
every backend, keyed on

    ``(backend name, program fingerprint, opt level, segment index, ...)``

where the fingerprint is :func:`~repro_torch.core.hetir.program_fingerprint`
— a content hash, so structurally identical programs built independently
(or carried over from another package with ``hetir.from_foreign``) share
translations.  Backends append whatever else their code specializes on.

Three layers extend the per-process cache to the paper's *cluster
lifetime* amortization (JIT cost is paid once per kernel, not per process
— and with the fabric, once per fleet):

* **Persistence** — an optional :class:`DiskStore` gives the cache a
  content-addressed on-disk tier.  Entries are written atomically
  (temp-file + ``os.replace``) into a directory named by the store format
  and :func:`runtime_tag`, and loads are corruption-tolerant: a truncated,
  garbled or version-skewed entry file is a *miss*, never an exception.
  What goes to disk is decided by the backend that translated the value,
  as a ``(kind, payload)`` pair revived through :func:`register_reviver`:

  - ``"cuda-module"`` (:mod:`~repro_torch.core.backends.cuda_backend`):
    one optimized program's segment library — the bytes of the shared
    library ``nvcc`` built, its content-addressed file name, and the
    per-segment launch metadata.  This is the translation that costs
    seconds; a warm process writes the library back under its hashed name
    (when it is not there already), loads it with ``ctypes`` and runs no
    ``nvcc``.
  - ``"interp-plan"`` (:mod:`~repro_torch.core.backends.interp`): the
    interpreter's staged step tree, pickled verbatim.

  The ``vectorized`` backend persists nothing: its translations are eager
  torch over the segment's statements and cost microseconds, less than
  reading an entry back.  The CUDA backend's block-path verdicts stay in
  memory for the same reason.

* **Cluster fabric** — an optional :class:`SharedStore` (a shared
  filesystem, ``HETGPU_CACHE_SHARED_DIR``) layered *under* the local
  store: fetch-on-miss with local replication, publish-on-translate, and
  fleet-wide single-flight locking, so N fresh processes pay exactly one
  translation cluster-wide.

* **Cost-aware eviction** — every entry carries its measured translation
  wall-time and serialized size; in-memory eviction uses the GDSF score
  ``clock + cost_ms / size`` (Greedy-Dual-Size-Frequency) instead of plain
  LRU, so a seconds-long ``nvcc`` build is not evicted to make room for a
  microsecond interpreter plan.  The ``clock`` advances to each victim's
  score, which ages out stale expensive entries.  The on-disk tier is
  bounded the same way: past ``HETGPU_CACHE_MAX_BYTES`` (or ``max_bytes``)
  :meth:`DiskStore.gc` evicts by ``cost_ms / size`` until the store fits.

A store written by the JAX package carries another runtime tag, so the
port never reads its entries (a miss, not an error).  Set
``HETGPU_CACHE_DIR`` to attach a :class:`DiskStore` to the process-wide
default cache.
"""
from __future__ import annotations

import contextlib
import hashlib
import os
import pickle
import tempfile
import threading
import time
from pathlib import Path
from typing import (Any, Callable, Dict, Hashable, Iterator, List, Optional,
                    Tuple)

import torch

try:
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX platform
    fcntl = None

#: bump when the envelope layout or any persisted payload format changes —
#: old store directories are simply never looked at again (tag mismatch)
STORE_FORMAT_VERSION = 1

_ENVELOPE_MAGIC = "hetgpu-torch-tcache"

# ---------------------------------------------------------------------------
# reviver registry: disk payload ``kind`` -> live-value constructor.
# Backends register their kinds at import time (backends/interp.py,
# backends/cuda_backend.py); an entry whose kind has no reviver is a miss.
# ---------------------------------------------------------------------------
_REVIVERS: Dict[str, Callable[[Any], Any]] = {}


def register_reviver(kind: str, fn: Callable[[Any], Any]) -> None:
    """Register ``fn`` to turn a persisted payload of ``kind`` back into a
    live cache value.  Last registration wins (idempotent re-imports)."""
    _REVIVERS[kind] = fn


# Side-channel from revivers back to the cache doing the restore: revivers
# are plain ``payload -> value`` callables with no cache handle, but the
# CUDA module reviver reports whether it had to write its library back.
# They call :func:`note_restore_detail`; the cache pops the fields right
# after the reviver returns, on the same thread.
_RESTORE_DETAIL = threading.local()


def note_restore_detail(**fields) -> None:
    """Called by revivers to annotate the in-progress restore (thread-local;
    consumed by the cache that invoked the reviver)."""
    current = getattr(_RESTORE_DETAIL, "fields", None) or {}
    current.update(fields)
    _RESTORE_DETAIL.fields = current


def _pop_restore_detail() -> Dict[str, Any]:
    fields = getattr(_RESTORE_DETAIL, "fields", None) or {}
    _RESTORE_DETAIL.fields = {}
    return fields


def runtime_tag() -> str:
    """Version tag of the code-generation contract: translated kernels are
    only shared between processes with the same torch and CUDA versions,
    the same device capability, and the same pass pipeline (a pass-set
    change retires every entry optimized by the old pipeline)."""
    from .passes import pipeline_fingerprint
    cuda = torch.version.cuda or "none"
    if torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability(0)
        cap = f"sm{major}{minor}"
    else:
        cap = "cpu"
    return f"p{pipeline_fingerprint()}-torch{torch.__version__}" \
           f"-cuda{cuda}-{cap}"


def _store_tag() -> str:
    return f"v{STORE_FORMAT_VERSION}-{runtime_tag()}"


class DiskStore:
    """Content-addressed on-disk tier for :class:`TranslationCache`.

    Layout: ``<root>/<store tag>/<sha256(key)[:40]>.tce`` — one pickled
    *envelope* per entry, carrying the full key (collision + integrity
    guard), the payload ``kind``, the payload itself, and the measured
    translation cost.  Writes are atomic (same-directory temp file +
    ``os.replace``), so concurrent writers race benignly (last identical
    write wins) and a crash can never leave a half-written entry visible.
    Loads never raise on bad data: any unpickling error, magic/version
    skew, or key mismatch counts as a miss and quarantines the file — but
    only when the file is provably still the bytes that failed to parse
    (same size and mtime): another process may have atomically republished
    a healthy entry at that path between our read and the unlink.

    The store is **process-safe**: a fleet of worker processes
    (:mod:`~repro_torch.core.fleet`) shares one directory.  :meth:`lock`
    hands out a per-key advisory ``flock`` (a sidecar ``.lock`` file, never
    unlinked on release — removing a lock file another process is blocked
    on would silently split the lock), which
    :meth:`TranslationCache.get_or_translate` uses for cross-process
    *single-flight* translation: N processes missing on the same key
    produce one translation and N−1 restores.  Set
    ``HETGPU_CACHE_SINGLE_FLIGHT=0`` to opt out (translations then race
    benignly, last write wins, work is duplicated).

    Entries are pickles: point a store only at a directory this program or
    its fleet writes.
    """

    def __init__(self, root, tag: Optional[str] = None,
                 max_bytes: Optional[int] = None):
        self.root = Path(root)
        self.tag = tag if tag is not None else _store_tag()
        self.dir = self.root / self.tag
        self.dir.mkdir(parents=True, exist_ok=True)
        # sweep temp files orphaned by writers killed mid-save (atomic
        # rename means they were never visible as entries).  Age-gated so
        # we never race a live writer in another process.
        cutoff = time.time() - 3600
        for stale in self.dir.glob("*.tmp"):
            try:
                if stale.stat().st_mtime < cutoff:
                    os.unlink(stale)
            except OSError:
                pass
        # on-disk size bound: past it, gc() evicts lowest-GDSF-score
        # entries (HETGPU_CACHE_MAX_BYTES; 0/unset = unbounded)
        if max_bytes is None:
            max_bytes = int(os.environ.get("HETGPU_CACHE_MAX_BYTES",
                                           "0") or 0)
        self.max_bytes = max(0, int(max_bytes))
        self._lock = threading.Lock()
        self.saves = 0
        self.loads = 0
        self.load_misses = 0
        self.corrupt = 0
        self.gc_evictions = 0
        self.gc_runs = 0
        self.lock_sweeps = 0
        # running estimate of the directory's entry bytes; seeded by a
        # scan here, incremented per save, corrected exactly by each gc()
        self._approx_bytes = self.total_bytes()

    # -- key addressing -------------------------------------------------
    def _path(self, key: Hashable) -> Path:
        digest = hashlib.sha256(repr(key).encode()).hexdigest()[:40]
        return self.dir / f"{digest}.tce"

    # -- cross-process locking ------------------------------------------
    @contextlib.contextmanager
    def lock(self, key: Hashable) -> Iterator[bool]:
        """Advisory per-key cross-process lock (``flock`` on a sidecar
        ``<digest>.lock`` file).  Yields ``True`` while holding the lock,
        or ``False`` when locking is unavailable (no ``fcntl``, unwritable
        directory) — callers treat ``False`` as "proceed unlocked", which
        is always safe because entry publishes are atomic; the lock only
        de-duplicates work.  Lock files are never unlinked here: removing
        one while another process is blocked on it would hand out two
        "exclusive" locks on fresh inodes (:meth:`gc` sweeps orphans)."""
        if fcntl is None:
            yield False
            return
        lock_path = self._path(key).with_suffix(".lock")
        try:
            fd = os.open(str(lock_path), os.O_RDWR | os.O_CREAT, 0o644)
        except OSError:
            yield False
            return
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield True
        finally:
            try:
                fcntl.flock(fd, fcntl.LOCK_UN)
            finally:
                os.close(fd)

    # -- write ----------------------------------------------------------
    def save(self, key: Hashable, kind: str, payload: Any,
             cost_ms: float = 0.0) -> int:
        """Atomically persist one translation.  Returns the entry's size in
        bytes (the size term of its eviction score)."""
        envelope = {
            "magic": _ENVELOPE_MAGIC,
            "version": STORE_FORMAT_VERSION,
            "tag": self.tag,
            "key": key,
            "kind": kind,
            "payload": payload,
            "cost_ms": float(cost_ms),
            "created": time.time(),
        }
        blob = pickle.dumps(envelope, protocol=pickle.HIGHEST_PROTOCOL)
        path = self._path(key)
        try:
            replaced = path.stat().st_size  # re-save: count the delta
        except OSError:
            replaced = 0
        fd, tmp = tempfile.mkstemp(dir=str(self.dir), suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)  # atomic publish
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        with self._lock:
            self.saves += 1
            self._approx_bytes += len(blob) - replaced
            over = self.max_bytes and self._approx_bytes > self.max_bytes
        if over:
            self.gc()
        return len(blob)

    # -- read -----------------------------------------------------------
    def load(self, key: Hashable) -> Optional[Dict[str, Any]]:
        """Load an envelope, or ``None`` (miss) for absent / truncated /
        corrupt / version-mismatched / colliding entries.  Never raises."""
        with self._lock:
            self.loads += 1
        env = self._read_envelope(self._path(key))
        if env is None or env["key"] != key:
            with self._lock:
                self.load_misses += 1
            return None
        return env

    def _read_envelope(self, path: Path) -> Optional[Dict[str, Any]]:
        try:
            stat_before = path.stat()
            blob = path.read_bytes()
        except OSError:
            return None
        try:
            env = pickle.loads(blob)
            if (not isinstance(env, dict)
                    or env.get("magic") != _ENVELOPE_MAGIC
                    or env.get("version") != STORE_FORMAT_VERSION
                    or "key" not in env or "kind" not in env
                    or "payload" not in env):
                raise ValueError("bad envelope")
            env["size_bytes"] = len(blob)
        except Exception:
            # corruption tolerance: quarantine and report a miss — but only
            # if the file is still the bytes that failed to parse
            with self._lock:
                self.corrupt += 1
            try:
                st = path.stat()
                if (st.st_mtime_ns == stat_before.st_mtime_ns
                        and st.st_size == stat_before.st_size):
                    os.unlink(path)
            except OSError:
                pass
            return None
        return env

    # -- scan (warm-up / migration preload) -----------------------------
    def iter_entries(self) -> Iterator[Tuple[Hashable, Dict[str, Any]]]:
        """Yield ``(key, envelope)`` for every readable entry; unreadable
        files are skipped (and quarantined), never raised."""
        for path in sorted(self.dir.glob("*.tce")):
            env = self._read_envelope(path)
            if env is not None:
                yield env["key"], env

    def entry_count(self) -> int:
        return sum(1 for _ in self.dir.glob("*.tce"))

    def total_bytes(self) -> int:
        """Exact on-disk entry bytes (directory scan)."""
        total = 0
        for path in self.dir.glob("*.tce"):
            try:
                total += path.stat().st_size
            except OSError:
                pass
        return total

    # -- garbage collection (store size bound) ---------------------------
    #: GC evicts down to this fraction of the bound, not just under it —
    #: the scan reads every envelope (cost_ms lives inside), so draining
    #: some slack per run keeps a store at its bound from paying a full
    #: directory scan on every later save
    GC_WATERMARK = 0.85

    def gc(self, limit: Optional[int] = None) -> int:
        """Evict entries until the store fits within ``limit`` bytes
        (default: ``max_bytes``), lowest GDSF score ``cost_ms / size``
        first, age (envelope ``created``) breaking ties — a bounded store
        sheds its cheapest-to-rebuild translations and keeps the ``nvcc``
        builds.  Runs after any save that pushes the store past
        ``max_bytes``, draining to ``GC_WATERMARK × limit``.  Unreadable
        entries are quarantined as usual (they count as ``corrupt``).
        Also sweeps orphaned lock sidecars.  Returns the number of entries
        evicted; concurrent GCs race benignly."""
        limit = self.max_bytes if limit is None else max(0, int(limit))
        scored = []
        total = 0
        for path in sorted(self.dir.glob("*.tce")):
            env = self._read_envelope(path)
            if env is None:
                continue
            size = env["size_bytes"]
            total += size
            scored.append((env.get("cost_ms", 0.0) / max(1, size),
                           env.get("created", 0.0), str(path), size))
        evicted = 0
        if limit:
            target = int(limit * self.GC_WATERMARK)
            for _score, _created, path, size in sorted(scored):
                if total <= target:
                    break
                try:
                    os.unlink(path)
                except OSError:
                    continue
                total -= size
                evicted += 1
        swept = self._sweep_orphan_locks()
        with self._lock:
            self._approx_bytes = total
            self.gc_evictions += evicted
            self.gc_runs += 1
            self.lock_sweeps += swept
        return evicted

    def _sweep_orphan_locks(self) -> int:
        """Unlink ``.lock`` sidecars whose entry is gone (evicted,
        quarantined, or cleared).  A sidecar is only removed while we hold
        its ``flock`` non-blocking, so a lock someone holds right now (an
        in-flight first translation, which takes the lock before any entry
        exists) is never touched.  A process that opened the file but has
        not flocked yet can still end up on the doomed inode: a split lock
        only duplicates translation work, since publishes stay atomic."""
        if fcntl is None:
            return 0
        swept = 0
        for lock_path in self.dir.glob("*.lock"):
            if lock_path.with_suffix(".tce").exists():
                continue
            try:
                fd = os.open(str(lock_path), os.O_RDWR)
            except OSError:
                continue
            try:
                try:
                    fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                except OSError:
                    continue  # held right now: an in-flight translation
                try:
                    os.unlink(lock_path)
                    swept += 1
                except OSError:
                    pass
            finally:
                os.close(fd)
        return swept

    def stats(self) -> Dict[str, object]:
        """Cheap counters only — no directory scan (this runs on the launch
        path via ``HetSession._sync_cache_stats``)."""
        with self._lock:
            return {
                "path": str(self.dir),
                "tag": self.tag,
                "saves": self.saves,
                "loads": self.loads,
                "load_misses": self.load_misses,
                "corrupt": self.corrupt,
                "max_bytes": self.max_bytes,
                "approx_bytes": self._approx_bytes,
                "gc_evictions": self.gc_evictions,
                "gc_runs": self.gc_runs,
                "lock_sweeps": self.lock_sweeps,
            }

    def clear(self) -> None:
        for pattern in ("*.tce", "*.tmp"):
            for path in self.dir.glob(pattern):
                try:
                    os.unlink(path)
                except OSError:
                    pass
        with self._lock:
            self._approx_bytes = 0


class SharedStore(DiskStore):
    """Cluster-wide fetch-on-miss tier: one :class:`DiskStore` directory on
    a shared filesystem, layered *under* each node's local store.

    A translation is published once (the same atomic envelope and
    corruption tolerance as the local tier) and every other process in the
    fleet *fetches* it instead of translating.  The flock sidecar protocol
    works unchanged on the shared directory, which turns per-process
    single-flight into **fleet-wide** single-flight: a cache with a shared
    tier takes its translation lock there, so N fresh processes missing on
    the same key run one ``nvcc`` between them.

    Fetched entries are *replicated* into the fetching process's local
    store (when it has one), so later cold starts on that node never touch
    the shared filesystem again — the fabric is a fill path, not a
    dependency.

    Attach via ``HETGPU_CACHE_SHARED_DIR`` (process-wide default cache),
    ``HetSession(shared=...)`` or ``FleetCoordinator(shared_dir=...)``.
    Size-bound with ``HETGPU_CACHE_SHARED_MAX_BYTES`` (unset = unbounded).
    """

    def __init__(self, root, tag: Optional[str] = None,
                 max_bytes: Optional[int] = None):
        if max_bytes is None:
            max_bytes = int(os.environ.get("HETGPU_CACHE_SHARED_MAX_BYTES",
                                           "0") or 0)
        super().__init__(root, tag=tag, max_bytes=max_bytes)
        self.publishes = 0
        self.fetches = 0
        self.fetch_misses = 0

    def publish(self, key: Hashable, kind: str, payload: Any,
                cost_ms: float = 0.0) -> int:
        """Atomically publish one translation to the fleet."""
        nbytes = self.save(key, kind, payload, cost_ms=cost_ms)
        with self._lock:
            self.publishes += 1
        return nbytes

    def fetch(self, key: Hashable) -> Optional[Dict[str, Any]]:
        """Load an envelope published by any fleet member (``None`` = clean
        miss, same corruption tolerance as :meth:`DiskStore.load`)."""
        env = self.load(key)
        with self._lock:
            if env is None:
                self.fetch_misses += 1
            else:
                self.fetches += 1
        return env

    def stats(self) -> Dict[str, object]:
        st = super().stats()
        with self._lock:
            st.update(publishes=self.publishes, fetches=self.fetches,
                      fetch_misses=self.fetch_misses)
        return st


class _Entry:
    """One cached translation plus its cost accounting."""

    __slots__ = ("value", "cost_ms", "size_bytes", "score", "seq")

    def __init__(self, value, cost_ms: float, size_bytes: int,
                 score: float, seq: int):
        self.value = value
        self.cost_ms = cost_ms
        self.size_bytes = size_bytes
        self.score = score
        self.seq = seq


class TranslationCache:
    """Thread-safe, cost-aware cache for translated kernels, with an
    optional persistent :class:`DiskStore` tier and an optional
    cluster-wide :class:`SharedStore` tier underneath it.

    Lookup order: memory → local disk → shared fabric → translate.  A
    shared-tier hit is *replicated* into the local store on the way up; a
    translation is saved locally *and published* to the fabric.  When a
    shared tier is attached, single-flight translation locks live on the
    shared directory, making them fleet-wide."""

    def __init__(self, capacity: int = 1024,
                 store: Optional[DiskStore] = None,
                 shared: Optional[SharedStore] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.store = DiskStore(store) if isinstance(store, (str, Path)) \
            else store
        self.shared = SharedStore(shared) if isinstance(shared, (str, Path)) \
            else shared
        self._entries: Dict[Hashable, _Entry] = {}
        self._lock = threading.RLock()
        self._clock = 0.0   # GDSF aging clock: advances to each victim's score
        self._seq = 0       # recency tie-break among equal scores
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.translated = 0      # fresh translations (factory ran)
        self.restored = 0        # served from the disk/shared tiers
        self.disk_misses = 0     # memory miss that no store could serve
        self.translate_ms = 0.0  # total wall-time spent translating
        self.restore_ms = 0.0    # total wall-time spent reviving from disk
        self.shared_fetches = 0        # restores served by the shared tier
        self.shared_publishes = 0      # translations published to the fabric
        self.replicated = 0            # shared-tier hits copied to local disk
        self.persist_errors = 0        # store writes that failed (disk full…)
        self.libraries_written = 0     # restores that wrote a missing library

    # -- GDSF internals --------------------------------------------------
    def _score(self, cost_ms: float, size_bytes: int) -> float:
        return self._clock + cost_ms / max(1.0, float(size_bytes))

    def _insert(self, key: Hashable, value: Any, cost_ms: float,
                size_bytes: int) -> None:
        """Insert under the lock, evicting lowest-score entries past
        capacity (cost-aware: cheap-to-rebuild entries go first)."""
        self._seq += 1
        self._entries[key] = _Entry(value, cost_ms, max(1, int(size_bytes)),
                                    self._score(cost_ms, size_bytes),
                                    self._seq)
        while len(self._entries) > self.capacity:
            victim = min(self._entries,
                         key=lambda k: (self._entries[k].score,
                                        self._entries[k].seq))
            self._clock = max(self._clock, self._entries[victim].score)
            del self._entries[victim]
            self.evictions += 1

    # -- memory tier -----------------------------------------------------
    def get(self, key: Hashable) -> Optional[Any]:
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                self.hits += 1
                self._seq += 1
                e.seq = self._seq
                e.score = self._score(e.cost_ms, e.size_bytes)  # refresh
                return e.value
            self.misses += 1
            return None

    def put(self, key: Hashable, value: Any, cost_ms: float = 0.0,
            size_bytes: int = 1) -> Any:
        """Insert a memory-only entry of the given cost and size."""
        with self._lock:
            self._insert(key, value, cost_ms, size_bytes)
        return value

    def items(self) -> List[Tuple[Hashable, Any]]:
        """``(key, value)`` of every entry in the memory tier (a copy)."""
        with self._lock:
            return [(k, e.value) for k, e in self._entries.items()]

    def _safe_save(self, key: Hashable, kind: str, payload: Any,
                   cost_ms: float) -> int:
        """Persist without ever failing the launch: a full/read-only disk
        degrades the entry to memory-only (counted in ``persist_errors``).
        Returns the written size, or 0 when the save did not happen."""
        try:
            return self.store.save(key, kind, payload, cost_ms=cost_ms)
        except Exception:
            with self._lock:
                self.persist_errors += 1
            return 0

    def _try_restore(self, key: Hashable) -> Optional[Any]:
        """Store-tier lookup: local disk first, then the shared fabric.
        Revives the envelope into the memory tier; a fabric hit is also
        replicated into the local store so this node never refetches it.
        Returns the live value, or ``None`` on any miss (absent entry,
        unknown kind, revival failure)."""
        env, from_shared = None, False
        if self.store is not None:
            env = self.store.load(key)
        if env is None and self.shared is not None:
            env = self.shared.fetch(key)
            from_shared = env is not None
        if env is None or env["kind"] not in _REVIVERS:
            return None
        value = self._revive(key, env)
        if value is not None and from_shared:
            self._note_fetched(key, env)
        return value

    def _note_fetched(self, key: Hashable, env: Dict[str, Any]) -> None:
        with self._lock:
            self.shared_fetches += 1
        if self.store is not None and self._safe_save(
                key, env["kind"], env["payload"], env.get("cost_ms", 0.0)):
            with self._lock:
                self.replicated += 1

    def _revive(self, key: Hashable, env: Dict[str, Any]) -> Optional[Any]:
        """Run the reviver for one loaded envelope, account the restore,
        and insert the live value into the memory tier."""
        t0 = time.perf_counter()
        _pop_restore_detail()  # drop any stale fields from a failed revive
        try:
            value = _REVIVERS[env["kind"]](env["payload"])
        except Exception:
            return None  # revival failure degrades to a miss
        dt = (time.perf_counter() - t0) * 1e3
        detail = _pop_restore_detail()
        if value is not None:
            with self._lock:
                self.restored += 1
                self.restore_ms += dt
                self.libraries_written += bool(detail.get("library_written"))
                self._insert(key, value, env.get("cost_ms", 0.0),
                             env.get("size_bytes", 1))
        return value

    # -- full lookup path: memory -> disk -> fabric -> translate ----------
    def get_or_translate(
            self, key: Hashable,
            translate: Callable[[], Tuple[Any, Optional[Tuple[str, Any]]]]
    ) -> Any:
        """Three-tier lookup.  ``translate`` runs only when neither the
        memory tier nor a store can serve ``key``; it returns ``(live
        value, persist)`` where ``persist`` is ``(kind, payload)`` for the
        stores or ``None`` for memory-only values.  Translation wall-time
        is measured here and drives both the eviction score and
        ``stats()['translate_ms']``.

        With a store attached, translation runs under the store's per-key
        cross-process lock (*single-flight*): of N processes missing on
        the same key, one translates while the rest block on the lock,
        then find the published entry on their re-check and restore it.
        With a shared fabric attached, the lock is taken on the *shared*
        directory, so single-flight holds across the whole fleet.
        ``HETGPU_CACHE_SINGLE_FLIGHT=0`` disables the lock."""
        value = self.get(key)
        if value is not None:
            return value
        if self.store is not None or self.shared is not None:
            value = self._try_restore(key)
            if value is not None:
                return value
            with self._lock:
                self.disk_misses += 1
            lock_store = self.shared if self.shared is not None else self.store
            if os.environ.get("HETGPU_CACHE_SINGLE_FLIGHT", "1") != "0":
                with lock_store.lock(key) as locked:
                    if locked:
                        # a lock-holder may have published while we waited
                        value = self._try_restore(key)
                        if value is not None:
                            return value
                    return self._translate_and_insert(key, translate)
        return self._translate_and_insert(key, translate)

    def _translate_and_insert(
            self, key: Hashable,
            translate: Callable[[], Tuple[Any, Optional[Tuple[str, Any]]]]
    ) -> Any:
        t0 = time.perf_counter()
        value, persist = translate()
        dt = (time.perf_counter() - t0) * 1e3
        with self._lock:
            self.translated += 1
            self.translate_ms += dt
        size = 1
        if persist is not None:
            kind, payload = persist
            if self.store is not None:
                size = self._safe_save(key, kind, payload, dt) or 1
            if self.shared is not None:
                try:
                    nbytes = self.shared.publish(key, kind, payload,
                                                 cost_ms=dt)
                    with self._lock:
                        self.shared_publishes += 1
                    if size == 1:
                        size = nbytes or 1
                except Exception:
                    with self._lock:
                        self.persist_errors += 1
        with self._lock:
            self._insert(key, value, dt, size)
        return value

    def preload(self, backend: Optional[str] = None,
                fingerprint: Optional[str] = None,
                store: Optional[DiskStore] = None) -> int:
        """Revive matching store entries into the memory tier ahead of use
        (warm-up / migration).  ``backend`` / ``fingerprint`` filter on the
        leading key components; ``store`` overrides the default scan order
        — local store, then the shared fabric (a migration source may hand
        over its own store).  Fabric entries revived here are replicated
        into the local store, exactly like a fetch-on-miss.  Returns the
        number of entries restored; unrevivable entries are skipped."""
        if store is not None:
            sources = [store]
        else:
            sources = [s for s in (self.store, self.shared) if s is not None]
        count = 0
        for src in sources:
            for key, env in src.iter_entries():
                if not isinstance(key, tuple) or len(key) < 2:
                    continue
                if backend is not None and key[0] != backend:
                    continue
                if fingerprint is not None and key[1] != fingerprint:
                    continue
                with self._lock:
                    if key in self._entries:
                        continue
                if env["kind"] not in _REVIVERS:
                    continue
                if self._revive(key, env) is None:
                    continue
                if src is self.shared:
                    self._note_fetched(key, env)
                count += 1
        return count

    # ------------------------------------------------------------------
    def size(self, backend: Optional[str] = None) -> int:
        """Entry count, optionally restricted to one backend's keys (every
        backend key leads with the backend name)."""
        with self._lock:
            if backend is None:
                return len(self._entries)
            return sum(1 for k in self._entries
                       if isinstance(k, tuple) and k and k[0] == backend)

    def stats(self) -> Dict[str, object]:
        with self._lock:
            lookups = self.hits + self.misses
            st: Dict[str, object] = {
                "entries": len(self._entries),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": (self.hits / lookups) if lookups else 0.0,
                "translated": self.translated,
                "restored": self.restored,
                "disk_misses": self.disk_misses,
                "translate_ms": self.translate_ms,
                "restore_ms": self.restore_ms,
                "shared_fetches": self.shared_fetches,
                "shared_publishes": self.shared_publishes,
                "replicated": self.replicated,
                "persist_errors": self.persist_errors,
                "libraries_written": self.libraries_written,
            }
        if self.store is not None:
            st["store"] = self.store.stats()
        if self.shared is not None:
            st["shared"] = self.shared.stats()
        return st

    def clear(self) -> None:
        """Drop the memory tier and reset counters (the stores, if any, are
        left intact — use ``store.clear()`` for that)."""
        with self._lock:
            self._entries.clear()
            self.hits = self.misses = self.evictions = 0
            self.translated = self.restored = self.disk_misses = 0
            self.translate_ms = self.restore_ms = 0.0
            self.shared_fetches = self.shared_publishes = self.replicated = 0
            self.persist_errors = self.libraries_written = 0
            self._clock = 0.0


# process-wide default: sessions and backends share translations unless
# handed an explicit cache (tests inject fresh instances for isolation).
# HETGPU_CACHE_DIR attaches a persistent tier; HETGPU_CACHE_SHARED_DIR
# attaches the cluster fabric.
_GLOBAL_CACHE = TranslationCache()


def global_cache() -> TranslationCache:
    # re-checked on every call (not latched): an application may set the
    # env vars after some backend has already touched the global cache
    if _GLOBAL_CACHE.store is None:
        cache_dir = os.environ.get("HETGPU_CACHE_DIR")
        if cache_dir:
            _GLOBAL_CACHE.store = DiskStore(cache_dir)
    if _GLOBAL_CACHE.shared is None:
        shared_dir = os.environ.get("HETGPU_CACHE_SHARED_DIR")
        if shared_dir:
            _GLOBAL_CACHE.shared = SharedStore(shared_dir)
    return _GLOBAL_CACHE
