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

In-memory eviction is cost-aware: every entry carries its measured
translation wall-time, and the victim is the lowest GreedyDual score
``clock + cost_ms`` (entries have no serialized size until the persistent
tiers are ported, so the reference's size term drops out), so an expensive
CUDA module build is not evicted to make room for a microsecond
interpreter plan.  The ``clock`` advances to each victim's score, which
ages out stale expensive entries over time.

The persistent tiers (an on-disk store and the cluster-wide shared store)
are not ported yet; see ROADMAP.md, Queue A.  The CUDA backend keeps its
built shared libraries on disk under ``build/repro_torch/`` keyed by a hash
of the generated source, header and compiler flags, which already spares a
second process the ``nvcc`` run.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Hashable, Optional

import torch


def runtime_tag() -> str:
    """Version tag of the code-generation contract: translated kernels are
    only shared between processes with the same torch and CUDA versions,
    the same device capability, and the same pass pipeline."""
    from .passes import pipeline_fingerprint
    cuda = torch.version.cuda or "none"
    if torch.cuda.is_available():
        major, minor = torch.cuda.get_device_capability(0)
        cap = f"sm{major}{minor}"
    else:
        cap = "cpu"
    return f"p{pipeline_fingerprint()}-torch{torch.__version__}" \
           f"-cuda{cuda}-{cap}"


class _Entry:
    """One cached translation plus its cost accounting."""

    __slots__ = ("value", "cost_ms", "score", "seq")

    def __init__(self, value, cost_ms: float, score: float, seq: int):
        self.value = value
        self.cost_ms = cost_ms
        self.score = score
        self.seq = seq


class TranslationCache:
    """Thread-safe, cost-aware in-memory cache for per-segment translated
    kernels."""

    def __init__(self, capacity: int = 1024):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._entries: Dict[Hashable, _Entry] = {}
        self._lock = threading.RLock()
        self._clock = 0.0   # aging clock: advances to each victim's score
        self._seq = 0       # recency tie-break among equal scores
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.translated = 0      # fresh translations (factory ran)
        self.translate_ms = 0.0  # total wall-time spent translating

    # -- GreedyDual internals -------------------------------------------
    def _score(self, cost_ms: float) -> float:
        return self._clock + cost_ms

    def _insert(self, key: Hashable, value: Any, cost_ms: float) -> None:
        """Insert under the lock, evicting lowest-score entries past
        capacity (cost-aware: cheap-to-rebuild entries go first)."""
        self._seq += 1
        self._entries[key] = _Entry(value, cost_ms, self._score(cost_ms),
                                    self._seq)
        while len(self._entries) > self.capacity:
            victim = min(self._entries,
                         key=lambda k: (self._entries[k].score,
                                        self._entries[k].seq))
            self._clock = max(self._clock, self._entries[victim].score)
            del self._entries[victim]
            self.evictions += 1

    # -- lookup ------------------------------------------------------------
    def get(self, key: Hashable) -> Optional[Any]:
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                self.hits += 1
                self._seq += 1
                e.seq = self._seq
                e.score = self._score(e.cost_ms)  # refresh
                return e.value
            self.misses += 1
            return None

    def get_or_translate(self, key: Hashable,
                         translate: Callable[[], Any]) -> Any:
        """Lookup; on a miss run ``translate`` (timed — the wall-time
        drives both the eviction score and ``stats()['translate_ms']``)
        and cache its result."""
        value = self.get(key)
        if value is not None:
            return value
        t0 = time.perf_counter()
        value = translate()
        dt = (time.perf_counter() - t0) * 1e3
        with self._lock:
            self.translated += 1
            self.translate_ms += dt
            self._insert(key, value, dt)
        return value

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
            return {
                "entries": len(self._entries),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": (self.hits / lookups) if lookups else 0.0,
                "translated": self.translated,
                "translate_ms": self.translate_ms,
            }

    def clear(self) -> None:
        """Drop every entry and reset the counters."""
        with self._lock:
            self._entries.clear()
            self.hits = self.misses = self.evictions = 0
            self.translated = 0
            self.translate_ms = 0.0
            self._clock = 0.0


# process-wide default: sessions and backends share translations unless
# handed an explicit cache (tests inject fresh instances for isolation)
_GLOBAL_CACHE = TranslationCache()


def global_cache() -> TranslationCache:
    return _GLOBAL_CACHE
