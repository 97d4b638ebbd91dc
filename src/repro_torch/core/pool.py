"""Device-memory pooling for the serving tier (paper §4.3 memory
abstraction under load).

The driver API hands out :class:`~repro_torch.core.runtime.DeviceBuffer`
handles; a serving workload allocates and frees thousands of short-lived
buffers per second, and backing each one with a fresh ``torch.zeros`` turns
the allocator into the hot path.  :class:`BufferPool` is a size-class
sub-allocator: backings are carved in power-of-two element classes, a
freed buffer's backing returns to the class free list, and the next
``alloc`` of a compatible (dtype, class) reuses it — zeroed, so the
"fresh allocation is zero-initialized" contract holds either way.

The pool is bounded (``max_bytes``, env ``HETGPU_POOL_MAX_BYTES``):
backings past the bound are dropped to the host allocator instead of
accumulating.  ``stats()`` exposes hit/miss/reuse-rate counters — the
serving benchmark's steady-state acceptance bar is a ≥ 90% reuse rate.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import torch

#: floor for the smallest size class, in elements — tiny buffers all land
#: in one class so a mixed small-allocation workload still pools well
_MIN_CLASS = 64

#: default pool bound: 64 MiB of retained free backings
_DEFAULT_MAX_BYTES = 64 << 20


def size_class(size: int) -> int:
    """The pooled capacity (in elements) that backs a ``size``-element
    request: the next power of two, floored at ``_MIN_CLASS``."""
    size = max(int(size), 1)
    cls = _MIN_CLASS
    while cls < size:
        cls <<= 1
    return cls


class BufferPool:
    """Size-class free lists of tensor backings, keyed by (device, dtype,
    class).

    ``take(size, dtype, device)`` returns a zeroed backing of
    ``size_class(size)`` elements (the caller views the first ``size``);
    ``release(backing)`` returns it for reuse.  Both are O(1).  A
    ``max_bytes=0`` (or ``enabled=False``) pool degenerates to plain
    allocation — every take is a miss, every release a drop."""

    def __init__(self, max_bytes: Optional[int] = None,
                 enabled: bool = True):
        if max_bytes is None:
            max_bytes = int(os.environ.get("HETGPU_POOL_MAX_BYTES",
                                           _DEFAULT_MAX_BYTES))
        self.max_bytes = int(max_bytes)
        self.enabled = bool(enabled) and self.max_bytes > 0
        self._free: Dict[Tuple[str, str, int], List[torch.Tensor]] = {}
        self.pooled_bytes = 0
        self.hits = 0          # takes served from a free list
        self.misses = 0        # takes that hit the host allocator
        self.released = 0      # backings accepted back into the pool
        self.dropped = 0       # releases past the bound (or disabled)

    # ------------------------------------------------------------------
    def take(self, size: int, dtype: torch.dtype,
             device: torch.device) -> torch.Tensor:
        """A zeroed 1-D backing tensor of ``size_class(size)`` elements."""
        cls = size_class(size)
        lst = self._free.get((str(device), str(dtype), cls))
        if lst:
            backing = lst.pop()
            self.pooled_bytes -= _nbytes(backing)
            self.hits += 1
            backing[:size].zero_()      # the visible span must read as fresh
            return backing
        self.misses += 1
        return torch.zeros(cls, dtype=dtype, device=device)

    def release(self, backing: torch.Tensor) -> bool:
        """Return a backing to its class free list.  Returns False when the
        pool is full (or disabled) and the backing was dropped instead."""
        nbytes = _nbytes(backing)
        if not self.enabled or self.pooled_bytes + nbytes > self.max_bytes:
            self.dropped += 1
            return False
        key = (str(backing.device), str(backing.dtype), backing.numel())
        self._free.setdefault(key, []).append(backing)
        self.pooled_bytes += nbytes
        self.released += 1
        return True

    def trim(self) -> int:
        """Drop every retained backing (e.g. before handing memory back to
        the host).  Returns the number of bytes released."""
        freed = self.pooled_bytes
        self._free.clear()
        self.pooled_bytes = 0
        return freed

    # ------------------------------------------------------------------
    def reuse_rate(self) -> float:
        """Fraction of takes served from the pool."""
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> Dict[str, object]:
        return {
            "hits": self.hits, "misses": self.misses,
            "released": self.released, "dropped": self.dropped,
            "pooled_bytes": self.pooled_bytes,
            "max_bytes": self.max_bytes,
            "free_lists": len(self._free),
            "reuse_rate": round(self.reuse_rate(), 4),
        }

    def __repr__(self) -> str:
        return (f"<BufferPool {self.pooled_bytes}/{self.max_bytes}B "
                f"reuse={self.reuse_rate():.2%}>")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()
