"""HetSession — the hetGPU abstraction layer as a driver-style API
(paper §4.3).

The paper promises "a uniform abstraction of threads, memory, and
synchronization"; this module presents it the way the CUDA Driver / HIP
APIs present theirs — as an *object model*, not a string-keyed grab-bag:

* :meth:`HetSession.load` turns a hetIR "binary" into a :class:`Module`;
  :meth:`Module.function` returns a :class:`Function` carrying typed
  parameter metadata (buffer vs scalar, dtype).
* :meth:`HetSession.alloc` returns a first-class :class:`DeviceBuffer`
  handle.  Kernels mutate buffers **in place** — results land in the very
  buffer object that was passed, with explicit
  :meth:`DeviceBuffer.copy_to_host` / :meth:`~DeviceBuffer.copy_from_host`
  transfers and no name-matching writeback.
* :meth:`Function.launch_async` enqueues onto a real :class:`Stream` and
  returns a :class:`LaunchRecord` future.  A cooperative priority /
  weighted-fair-share scheduler interleaves *segments* (the unit between
  barriers — see :mod:`~repro_torch.core.engine`) from concurrent streams —
  equal weights degenerate to exact round-robin — so two async launches
  genuinely overlap at segment granularity, observable in
  ``HetSession.sched_trace`` (a capped ring).
* :class:`Event` objects give cross-stream ordering
  (:meth:`Stream.record_event` / :meth:`Stream.wait_event` / ``query`` /
  ``synchronize``), with CUDA's semantics (waiting on a never-recorded
  event is a no-op).
* The scheduler is a **priority / weighted-fair-share** segment scheduler
  (the serving tier): each :class:`Stream` carries a ``weight`` and a
  ``priority``, the session picks the runnable stream with the highest
  priority and least weighted virtual time for each segment, preemption
  happens at segment boundaries (via the engine's segment-boundary yield
  hook), and a starvation guard periodically serves the longest-waiting
  stream so zero-weight / low-priority work still progresses.
* :meth:`DeviceBuffer.copy_from_host_async` /
  :meth:`~DeviceBuffer.copy_to_host_async` enqueue data movement as
  stream work items, so copies participate in stream ordering *and* in
  scheduling; :meth:`HetSession.alloc` sub-allocates from a bounded
  :class:`~repro_torch.core.pool.BufferPool` so short-lived serving buffers
  reuse backings instead of thrashing the host allocator.
* ``checkpoint`` / :func:`migrate` work on in-flight async launches at
  their next barrier; :class:`DeviceBuffer` identity survives restore
  within a session (a restored launch re-binds the live buffer by uid)
  and migration carries uids so a chain of hops stays identity-stable.

The "JIT modules" are entries in the shared :class:`~repro_torch.core.
cache.TranslationCache` (paper §4.2), surfaced via :meth:`HetSession.
cache_stats` and ``stats`` (``translate_ms`` from cache counters,
``launch_ms`` for end-to-end launch work), plus :meth:`HetSession.warmup`
ahead-of-time translation.  ``HetSession(store=..., shared=...)`` puts the
cache on the persistent tiers (a local :class:`~repro_torch.core.cache.
DiskStore` and the cluster fabric), so translations — on ``cuda`` the
``nvcc``-built segment libraries — outlive the process.

A session lives on one ``torch.device``: ``cuda:0`` unless the caller asks
for ``device="cpu"`` (it raises when there is no GPU and no device was
given).  Device buffers are tensors on that device, and launch state stays
there between segments.

The old string-keyed surface (``load_kernel`` / ``gpu_malloc`` /
``memcpy_h2d`` / ``memcpy_d2h`` / ``launch`` / ``device_synchronize``)
survives as a thin deprecated shim on top of the object model — each call
raises :class:`DeprecationWarning` and is mapped in docs/API.md's
old→new table.
"""
from __future__ import annotations

import itertools
import os
import time
import uuid
import warnings
from collections import deque
from dataclasses import dataclass
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from . import hetir as ir
from .backends import get_backend
from .backends.base import (TORCH_DTYPES, Backend, resolve_device, to_numpy,
                            torch_dtype)
from .cache import DiskStore, SharedStore, TranslationCache
from .engine import Engine
from .passes import DEFAULT_OPT_LEVEL, OPT_MAX
from .pool import BufferPool
from .state import Snapshot

#: default ``sched_trace`` ring capacity — generous enough that every
#: existing test window fits whole, small enough that a serving session
#: driving millions of segments stays bounded
_DEFAULT_TRACE_CAP = 100_000

#: a zero-weight stream's virtual time advances this fast per segment —
#: effectively "never pick me on weight grounds"; only the starvation
#: guard (or an otherwise-idle session) serves it
_ZERO_WEIGHT_RATE = 1e9


class TraceRing:
    """The scheduler trace as a capped ring buffer: list-like for readers
    (iteration, indexing, ``len``, ``clear``), but appends past ``cap``
    evict the oldest entry and bump ``dropped`` — a serving session that
    executes millions of segments keeps a bounded window of the most
    recent ones instead of leaking one dict per segment."""

    __slots__ = ("_d", "dropped")

    def __init__(self, cap: int = _DEFAULT_TRACE_CAP):
        if cap <= 0:
            raise ValueError(f"trace cap must be positive, got {cap}")
        self._d: deque = deque(maxlen=int(cap))
        self.dropped = 0

    @property
    def cap(self) -> int:
        return self._d.maxlen

    def append(self, item: Dict[str, object]) -> None:
        if len(self._d) == self._d.maxlen:
            self.dropped += 1
        self._d.append(item)

    def clear(self) -> None:
        """Empty the window (``dropped`` stays cumulative)."""
        self._d.clear()

    def __len__(self) -> int:
        return len(self._d)

    def __iter__(self):
        return iter(self._d)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return list(self._d)[idx]
        return self._d[idx]

    def __bool__(self) -> bool:
        return bool(self._d)

    def __repr__(self) -> str:
        return (f"<TraceRing {len(self._d)}/{self.cap} "
                f"dropped={self.dropped}>")

# Buffer uids must stay unique across sessions *and* across processes
# (snapshots carry them; restore re-binds by uid, and a false match would
# silently alias two unrelated buffers), so they carry a per-process salt.
_UID_SALT = uuid.uuid4().hex[:8]
_UID_COUNTER = itertools.count()


def _next_uid() -> str:
    return f"b{_UID_SALT}-{next(_UID_COUNTER)}"


def _deprecated(old: str, new: str) -> None:
    warnings.warn(
        f"HetSession.{old} is deprecated; use {new} instead "
        "(driver-style API — see docs/API.md for the old→new table)",
        DeprecationWarning, stacklevel=3)


def _ir_dtype(dtype) -> str:
    """hetIR dtype code of a hetIR code, numpy dtype or torch dtype."""
    if isinstance(dtype, torch.dtype):
        for code, tdt in TORCH_DTYPES.items():
            if tdt == dtype:
                return code
        raise TypeError(f"no hetIR dtype for {dtype}")
    return ir.ir_dtype(dtype)


def _np_torch_dtype(np_dt: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, np_dt)).dtype


def _torch_np_dtype(tdt: torch.dtype) -> np.dtype:
    return torch.zeros(0, dtype=tdt).numpy().dtype


def _host_array(host, np_dt: np.dtype, size: int) -> np.ndarray:
    """``host`` (array-like or tensor) as a flat array of ``np_dt``, under
    ``np.copyto``'s ``same_kind`` casting rule."""
    arr = to_numpy(host) if isinstance(host, torch.Tensor) \
        else np.asarray(host)
    if arr.size != size:
        raise ValueError(
            f"host array has {arr.size} elements, buffer holds {size}")
    if not np.can_cast(arr.dtype, np_dt, casting="same_kind"):
        raise TypeError(f"cannot copy {arr.dtype} into a {np_dt} buffer")
    return arr.reshape(-1).astype(np_dt)


# ---------------------------------------------------------------------------
# Device memory
# ---------------------------------------------------------------------------

class DeviceBuffer:
    """A typed handle to linear device memory (the driver-API analogue of a
    ``CUdeviceptr``): ``data`` is a 1-D tensor on the session's device.
    Like driver allocations buffers are a span of elements, and kernels
    index them linearly; ``copy_from_host`` accepts any host array of
    matching total size and flattens it.

    Kernels mutate the buffer **in place**: after a launch that bound this
    buffer completes, ``data`` holds the kernel's writes — same object,
    no name matching, no implicit writeback.  Host transfers are explicit
    (:meth:`copy_to_host` returns a defensive copy); the ``_async``
    variants enqueue the transfer on a :class:`Stream` instead, so it
    runs in stream order and participates in scheduling.

    Backings come from the session's :class:`~repro_torch.core.pool.
    BufferPool` when one is attached: ``data`` is a ``size``-element view
    of a size-class backing, and :meth:`free` returns the backing for
    reuse.
    """

    __slots__ = ("session", "uid", "dtype", "data", "freed", "_backing")

    def __init__(self, session: "HetSession", size: int,
                 dtype: object = np.float32, uid: Optional[str] = None,
                 pool: Optional[BufferPool] = None):
        self.session = session
        self.uid = uid if uid is not None else _next_uid()
        # non-hetIR dtypes (f64, f16, ...) are allocatable for host-side
        # staging — the legacy memcpy surface accepted them — but carry
        # dtype=None and are rejected by the typed Function binding
        try:
            self.dtype: Optional[str] = _ir_dtype(dtype)
            tdt = torch_dtype(self.dtype)
        except TypeError:
            self.dtype = None
            tdt = dtype if isinstance(dtype, torch.dtype) \
                else _np_torch_dtype(np.dtype(dtype))
        size = int(size)
        if pool is not None:
            self._backing: Optional[torch.Tensor] = pool.take(
                size, tdt, session.device)
            self.data = self._backing[:size]
        else:
            self._backing = None
            self.data = torch.zeros(size, dtype=tdt, device=session.device)
        self.freed = False

    # -- geometry ----------------------------------------------------------
    @property
    def size(self) -> int:
        return self.data.numel()

    @property
    def nbytes(self) -> int:
        return self.data.numel() * self.data.element_size()

    @property
    def np_dtype(self) -> np.dtype:
        return ir.np_dtype(self.dtype) if self.dtype is not None \
            else _torch_np_dtype(self.data.dtype)

    # -- transfers ---------------------------------------------------------
    def copy_from_host(self, host) -> "DeviceBuffer":
        """Explicit H2D: copy ``host`` (any shape, matching total size)
        into this buffer.  Returns ``self`` for chaining."""
        self._check_alive()
        arr = _host_array(host, self.np_dtype, self.size)
        self.data.copy_(torch.from_numpy(arr))
        return self

    def copy_to_host(self) -> np.ndarray:
        """Explicit D2H: a defensive host copy of the buffer contents."""
        self._check_alive()
        return to_numpy(self.data)

    # -- asynchronous transfers (stream work items) ------------------------
    def copy_from_host_async(self, host, stream: Optional["Stream"] = None
                             ) -> "CopyRecord":
        """Enqueue an H2D copy on ``stream`` (default stream if None) and
        return a :class:`CopyRecord` future.  The copy executes in stream
        order — work enqueued after it observes the new contents — and
        counts as one unit of scheduled work, so data movement competes
        under the same fair-share policy as kernels.  Like the driver
        APIs' async memcpy, ``host`` must stay unmodified until the copy
        completes (the array is referenced, not staged)."""
        self._check_alive()
        arr = _host_array(host, self.np_dtype, self.size)
        return self.session._enqueue_copy("h2d", self, stream, host=arr)

    def copy_to_host_async(self, stream: Optional["Stream"] = None
                           ) -> "CopyRecord":
        """Enqueue a D2H copy on ``stream``; the returned
        :class:`CopyRecord`'s :meth:`~CopyRecord.result` holds the buffer
        contents *as of the copy's position in the stream* once it
        completes (enqueue before a launch to read the pre-launch
        state — CUDA stream semantics)."""
        self._check_alive()
        return self.session._enqueue_copy("d2h", self, stream)

    def fill(self, value) -> "DeviceBuffer":
        self._check_alive()
        self.data.copy_(torch.from_numpy(
            np.full(self.size, value, dtype=self.np_dtype)))
        return self

    def free(self) -> None:
        """Release the handle (drops the session's uid registration; a
        later restore can no longer re-bind this buffer, and queued work
        that still binds it fails with a use-after-free error when it
        reaches the stream front).  The backing returns to the session's
        buffer pool for reuse.  Idempotent."""
        if self.freed:
            return
        self.session._buffers_by_uid.pop(self.uid, None)
        self.freed = True
        backing, self._backing = self._backing, None
        if backing is not None:
            self.session.pool.release(backing)

    def _check_alive(self) -> None:
        if self.freed:
            raise ValueError(f"buffer {self.uid} has been freed")

    def __repr__(self) -> str:
        state = "freed" if self.freed else f"{self.size}x{self.dtype}"
        return f"<DeviceBuffer {self.uid} {state}>"


# ---------------------------------------------------------------------------
# Events and streams
# ---------------------------------------------------------------------------

class Event:
    """A stream ordering marker (CUDA-event semantics): ``record`` places
    it in a stream's work queue, it *completes* when everything enqueued
    before it on that stream has finished, and other streams can
    :meth:`Stream.wait_event` on it.  Waiting on a never-recorded event is
    a no-op, exactly as in the driver APIs."""

    def __init__(self, session: Optional["HetSession"] = None):
        self._session = session
        self._recorded = False
        self._complete = False
        # bumped on every record: a re-recorded event must only complete
        # at its *latest* record point — stale queue markers from earlier
        # records retire without completing it.  Waits capture the
        # generation current when the wait was issued (CUDA: a wait refers
        # to the most recent record *at wait time*, unaffected by later
        # re-records), and unblock once that record point is reached.
        self._generation = 0
        self._last_retired_generation = 0

    def query(self) -> bool:
        """Non-blocking completion check (retires any ripe queue markers
        first; never executes kernel segments)."""
        if self._session is not None:
            self._session._settle()
        return self._complete

    def synchronize(self) -> bool:
        """Drive the scheduler until this event completes.  Returns False
        if progress stopped on a paused stream (cooperative checkpoint)."""
        if not self._recorded:
            raise RuntimeError("cannot synchronize an event that was "
                               "never recorded")
        return self._session._drain(until=lambda: self._complete)


@dataclass
class _EventRecord:
    """Queue marker: the recording point of an Event (at a specific
    record generation — markers from superseded records are stale)."""
    event: Event
    generation: int


@dataclass
class _EventWait:
    """Queue marker: this stream blocks until the record point ``event``
    had when the wait was issued (``generation``) is reached."""
    event: Event
    generation: int

    def satisfied(self) -> bool:
        return self.event._last_retired_generation >= self.generation


class CopyRecord:
    """Future for an asynchronous host↔device copy: a first-class stream
    work item (the scheduler executes it at the stream front, one
    scheduling unit, traced as ``<h2d>`` / ``<d2h>``), with the same
    future surface as a :class:`LaunchRecord` (``done`` / ``wait``)."""

    __slots__ = ("session", "kind", "buffer", "stream", "seq", "finished",
                 "_host", "_array")

    def __init__(self, session: "HetSession", kind: str,
                 buffer: DeviceBuffer, stream: "Stream",
                 host: Optional[np.ndarray] = None):
        self.session = session
        self.kind = kind                      # "h2d" | "d2h"
        self.buffer = buffer
        self.stream = stream
        self.seq = next(session._seq)
        self.finished = False
        self._host = host
        self._array: Optional[np.ndarray] = None

    def done(self) -> bool:
        return self.finished

    def wait(self) -> bool:
        """Drive the scheduler until this copy completes.  Returns False
        if blocked by paused work."""
        ok = self.session._drain(until=lambda: self.finished)
        return ok and self.finished

    def result(self) -> np.ndarray:
        """The copied host array (D2H only) — waits if still pending."""
        if self.kind != "d2h":
            raise ValueError("result() is only defined for d2h copies")
        if not self.finished and not self.wait():
            raise RuntimeError("d2h copy blocked on paused work")
        return self._array

    def _execute(self) -> None:
        db = self.buffer
        if db.freed:
            raise RuntimeError(
                f"async {self.kind} copy #{self.seq} on stream "
                f"{self.stream.sid}: buffer {db.uid} was freed before the "
                "copy reached the stream front — device memory must stay "
                "alive until queued work that binds it has run")
        if self.kind == "h2d":
            db.data.copy_(torch.from_numpy(self._host))
            self._host = None
        else:
            self._array = to_numpy(db.data)
        self.finished = True

    def __repr__(self) -> str:
        state = "finished" if self.finished else "queued"
        return (f"<CopyRecord #{self.seq} {self.kind} {self.buffer.uid} "
                f"stream={self.stream.sid} {state}>")


class Stream:
    """An in-order work queue with genuinely asynchronous execution: the
    session's priority / weighted-fair-share scheduler hands out segments
    to runnable streams.  Within a stream, a launch only *starts* (binds
    its buffers and translates) once everything before it has completed —
    so same-stream dataflow through a :class:`DeviceBuffer` behaves like
    CUDA stream ordering.

    Scheduling knobs (the serving tier's policy surface):

    * ``weight`` — fair-share weight: over any window where a set of
      streams stays backlogged, each receives segment service roughly
      proportional to its weight.  ``0`` opts the stream out of weighted
      competition entirely; it only runs via the starvation guard or when
      nothing else is runnable.
    * ``priority`` — strict tiers: a runnable higher-priority stream is
      always served first (and *preempts* a lower-priority stream's
      multi-segment quantum at the next segment boundary).  Fair share
      applies within a tier.  The starvation guard is the backstop that
      keeps lower tiers alive under sustained high-priority load.
    * ``quantum`` — segments granted per scheduling decision (default 1 =
      finest interleaving; serving fronts raise it to cut scheduler
      overhead per segment).
    """

    def __init__(self, session: "HetSession", sid: int,
                 weight: float = 1.0, priority: int = 0, quantum: int = 1):
        if weight < 0:
            raise ValueError(f"stream weight must be >= 0, got {weight}")
        self.session = session
        self.sid = sid
        self.weight = float(weight)
        self.priority = int(priority)
        self.quantum = max(1, int(quantum))
        self._q: deque = deque()
        #: cooperative per-stream pause: the scheduler stops stepping this
        #: stream's launches (they hold at their current barrier — the
        #: checkpoint hook), while other streams keep running.
        self.paused = False
        self.destroyed = False
        # weighted-fair bookkeeping: virtual time consumed (advances by
        # 1/weight per executed segment) and the pick counter at the last
        # scheduling decision that chose this stream (starvation guard +
        # tie-break).
        self._vtime = 0.0
        self._last_pick = 0

    # -- queue state -------------------------------------------------------
    def query(self) -> bool:
        """True iff all work enqueued on this stream has completed."""
        self.session._settle()
        return not self._q

    def synchronize(self) -> bool:
        """Drive the scheduler until this stream drains.  Returns False if
        progress stopped on paused work."""
        return self.session._drain(until=lambda: not self._q)

    # -- retirement --------------------------------------------------------
    def destroy(self) -> None:
        """Retire the stream: refuse further work and drop it from the
        scheduler's scan set, so long-lived sessions that create many
        short-lived streams keep stepping in O(active streams).  Refuses
        while work is pending (drain first); the default stream cannot be
        destroyed."""
        if self.destroyed:
            return
        self.session._settle()
        if self._q:
            raise RuntimeError(
                f"cannot destroy stream {self.sid}: {len(self._q)} work "
                "item(s) still pending — synchronize() it first")
        if self is self.session.default_stream:
            raise ValueError("the default stream cannot be destroyed")
        self.destroyed = True
        self.session._retire_stream(self)

    def _check_usable(self) -> None:
        if self.destroyed:
            raise RuntimeError(
                f"stream {self.sid} has been destroyed — create a new "
                "stream with session.stream()")

    # -- pause (cooperative checkpoint) ------------------------------------
    def pause(self) -> None:
        self.paused = True

    def resume(self) -> None:
        self.paused = False

    # -- events ------------------------------------------------------------
    def record_event(self, event: Optional[Event] = None) -> Event:
        self._check_usable()
        ev = event if event is not None else Event(self.session)
        ev._session = self.session
        ev._recorded = True
        ev._complete = False
        ev._generation += 1             # invalidates earlier queue markers
        self._q.append(_EventRecord(ev, ev._generation))
        self.session._settle()          # empty queue => completes at once
        return ev

    def wait_event(self, event: Event) -> None:
        """Block this stream's later work until ``event``'s *current*
        record point is reached (CUDA semantics: a later re-record does
        not move an already-issued wait).  A never-recorded or
        already-complete event is a no-op."""
        self._check_usable()
        self.session._settle()
        if not event._recorded \
                or event._last_retired_generation >= event._generation:
            return
        self._q.append(_EventWait(event, event._generation))

    def _enqueue(self, rec) -> None:
        self._check_usable()
        if not self._q:
            # idle -> runnable: catch the virtual clock up so a stream
            # that slept does not monopolize the scheduler on wake
            self._vtime = max(self._vtime, self.session._vclock)
        self._q.append(rec)

    def _charge(self, units: float = 1.0) -> None:
        """Advance virtual time by ``units`` of weighted service."""
        rate = 1.0 / self.weight if self.weight > 0 else _ZERO_WEIGHT_RATE
        self._vtime += units * rate

    def _describe_front(self) -> str:
        if not self._q:
            return "empty"
        item = self._q[0]
        if isinstance(item, _EventWait):
            return "waiting on event"
        if isinstance(item, _EventRecord):
            return "event record"
        if isinstance(item, CopyRecord):
            return f"{item.kind} copy #{item.seq}"
        return f"launch #{item.seq} ({item.program_name})"

    def __repr__(self) -> str:
        flags = " paused" if self.paused else ""
        flags += " destroyed" if self.destroyed else ""
        return (f"<Stream {self.sid} w={self.weight:g} p={self.priority} "
                f"depth={len(self._q)}{flags}>")


# ---------------------------------------------------------------------------
# Launches
# ---------------------------------------------------------------------------

class LaunchRecord:
    """Future for an enqueued kernel launch.

    A record enqueued via :meth:`Function.launch_async` is *lazy*: its
    :class:`~repro_torch.core.engine.Engine` (which snapshots buffer contents
    and translates) materializes only when the launch reaches the front of
    its stream with all prior work done — that is what gives same-stream
    dataflow CUDA semantics.  Accessing ``.engine`` earlier forces
    materialization (used by ``checkpoint`` of a not-yet-started launch).
    """

    def __init__(self, session: "HetSession",
                 function: Optional["Function"], grid: int, block: int,
                 eng_args: Optional[Dict[str, object]],
                 bindings: Dict[str, DeviceBuffer], stream: "Stream",
                 engine: Optional[Engine] = None):
        self.session = session
        self.function = function
        self.grid = grid
        self.block = block
        self._eng_args = eng_args
        self.bindings = dict(bindings)
        self.stream = stream
        self.seq = next(session._seq)
        self._engine = engine
        self.finished = bool(engine is not None and engine.finished)
        self.cancelled = False
        #: on a CUDA session, an event recorded on the device stream right
        #: after the launch's last segment and its writeback (set when the
        #: host finishes the launch): the device is done once it completes
        self.done_event: Optional[torch.cuda.Event] = None
        if engine is not None:
            engine.launch.stream_id = stream.sid
            engine.launch.launch_seq = self.seq

    # -- engine materialization -------------------------------------------
    @property
    def started(self) -> bool:
        return self._engine is not None

    @property
    def engine(self) -> Engine:
        if self._engine is None:
            # binding early would snapshot buffer contents *before* prior
            # same-stream work has written them — silently wrong data for
            # this launch and for any checkpoint taken from it.  Only the
            # stream-front launch may bind.
            if self.stream._q and self.stream._q[0] is not self:
                raise RuntimeError(
                    f"launch #{self.seq} ({self.program_name}) has not "
                    "started: it is queued behind other work on stream "
                    f"{self.stream.sid}, and its buffers only bind once "
                    "that work completes — drive the scheduler "
                    "(session.step()/synchronize()) before checkpointing "
                    "or migrating it")
            self._materialize()
        return self._engine

    @property
    def program_name(self) -> str:
        if self._engine is not None:
            return self._engine.program.name
        return self.function.name

    def _materialize(self) -> None:
        s = self.session
        # use-after-free guard: a buffer freed between launch_async and
        # the lazy stream-front bind still *has* a ``.data`` array, so
        # without this check the launch would silently execute against
        # released memory (and its writes would vanish at _finish, which
        # skips freed buffers).  Fail loudly instead.
        for pname, db in self.bindings.items():
            if db.freed:
                raise RuntimeError(
                    f"launch #{self.seq} ({self.program_name}): buffer "
                    f"parameter {pname!r} ({db.uid}) was freed before the "
                    "launch reached the stream front — device memory must "
                    "stay alive until queued work that binds it has run")
        eng = Engine(self.function.program, s.backend, self.grid,
                     self.block, self._eng_args, opt_level=s.opt_level,
                     specialize=s.specialize)
        eng.launch.stream_id = self.stream.sid
        eng.launch.launch_seq = self.seq
        self._engine = eng
        self._eng_args = None
        s.stats["last_opt"] = eng.opt_stats.as_dict()
        s.stats["last_spec_key"] = eng.spec_key
        if eng.spec_key:
            s.stats["specialized_launches"] = \
                s.stats.get("specialized_launches", 0) + 1

    # -- future surface ----------------------------------------------------
    def done(self) -> bool:
        return self.finished

    def wait(self) -> bool:
        """Drive the scheduler until this launch completes (other streams
        make fair-share progress too — host-side sync, not serialization).
        Returns False if blocked by a paused stream or the pause flag."""
        ok = self.session._drain(
            until=lambda: self.finished or self.cancelled)
        return ok and self.finished

    def buffer(self, name: str) -> DeviceBuffer:
        """The DeviceBuffer bound to buffer parameter ``name``."""
        return self.bindings[name]

    def advance(self, max_segments: Optional[int] = None,
                on_segment: Optional[Callable[[Engine], bool]] = None
                ) -> bool:
        """Drive *only this launch* forward by up to ``max_segments``
        segments (None = to completion), returning True iff it finished.

        This is the control-plane stepping primitive the worker-fleet
        layer (:mod:`~repro_torch.core.fleet`) drives over IPC: a coordinator
        hands out bounded segment slices, and between slices the launch
        rests at a barrier — exactly where ``checkpoint`` is legal — so
        drain / rebalance / evacuation policies can interpose without a
        cooperative pause flag.  ``on_segment`` is forwarded to the
        engine's segment-boundary yield hook (fault injectors hang off
        it); segments executed here are charged/traced like scheduler
        steps, so fleet work shows up in ``sched_trace`` and stats.

        The launch must be at its stream front (same rule as lazy
        materialization — prior same-stream work must have written its
        buffers); a cancelled launch cannot be advanced.
        """
        if self.finished:
            return True
        if self.cancelled:
            raise RuntimeError(
                f"launch #{self.seq} ({self.program_name}) was cancelled "
                "— it cannot be advanced")
        s = self.session
        s._settle()
        if not self.stream._q or self.stream._q[0] is not self:
            raise RuntimeError(
                f"launch #{self.seq} ({self.program_name}) is not at the "
                f"front of stream {self.stream.sid} — drain prior work "
                "before single-stepping it")
        eng = self.engine

        def _boundary(e: Engine) -> bool:
            self.stream._charge(1.0)
            s._trace(self.stream, e.program.name, self.seq, e.node_idx)
            s.stats["segments_executed"] += 1
            return bool(on_segment is not None and on_segment(e))

        finished = eng.run(max_segments=max_segments, on_segment=_boundary)
        if finished:
            self.stream._q.popleft()
            self._finish()
            s._settle()
        return finished

    def cancel(self) -> None:
        """Withdraw the launch from its stream (a migrated-away launch
        must not also run to completion on the source)."""
        try:
            self.stream._q.remove(self)
        except ValueError:
            pass
        self.cancelled = True

    def _finish(self) -> None:
        """Completion hook: propagate kernel writes into the bound
        DeviceBuffers *in place* (object identity preserved), device to
        device.  The typed binding guarantees matching dtypes on the new
        surface; a legacy buffer whose dtype differs from the kernel
        param's falls back to the old rebind-the-array semantics."""
        self.finished = True
        for name, db in self.bindings.items():
            if db.freed:
                continue
            res = self._engine.state.globals_[name]
            if res.dtype == db.data.dtype:
                db.data.copy_(res)
            else:
                db.data = res.clone()
                db.dtype = _ir_dtype(res.dtype)
        dev = self.session.device
        if dev.type == "cuda":
            self.done_event = torch.cuda.Event(enable_timing=True)
            self.done_event.record(torch.cuda.current_stream(dev))

    def __repr__(self) -> str:
        state = ("finished" if self.finished else
                 "cancelled" if self.cancelled else
                 "running" if self.started else "queued")
        return (f"<LaunchRecord #{self.seq} {self.program_name} "
                f"stream={self.stream.sid} {state}>")


# ---------------------------------------------------------------------------
# Modules and functions
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ParamInfo:
    """Typed parameter metadata a Function exposes (the driver-API
    analogue of ``cuFuncGetParamInfo``)."""
    name: str
    kind: str       # "buffer" | "scalar"
    dtype: str      # hetIR dtype code ("f32", "i32", ...)


class Function:
    """A launchable kernel entry point with typed parameter metadata.
    Obtained from :meth:`Module.function`; launches go through
    :meth:`launch` / :meth:`launch_async`."""

    def __init__(self, session: "HetSession", program: ir.Program):
        self.session = session
        self.program = program
        self.name = program.name
        self.params: Tuple[ParamInfo, ...] = tuple(
            ParamInfo(p.name,
                      "buffer" if isinstance(p, ir.Ptr) else "scalar",
                      p.dtype)
            for p in program.params)

    def param(self, name: str) -> ParamInfo:
        for p in self.params:
            if p.name == name:
                return p
        raise KeyError(f"{self.name} has no parameter {name!r}")

    # -- launching ---------------------------------------------------------
    def launch_async(self, grid: int, block: int,
                     args: Dict[str, object],
                     stream: Optional[Stream] = None) -> LaunchRecord:
        """Enqueue onto ``stream`` (default stream if None) and return a
        :class:`LaunchRecord` future immediately.  Buffer parameters must
        be :class:`DeviceBuffer` handles of matching dtype; results appear
        in those buffers in place once the launch completes."""
        s = self.session
        t0 = time.perf_counter()
        stream = stream if stream is not None else s.default_stream
        if stream.session is not s:
            raise ValueError("stream belongs to a different session")
        eng_args, bindings = self._bind(args)
        rec = LaunchRecord(s, self, grid, block, eng_args, bindings,
                           stream)
        stream._enqueue(rec)
        s.stats["launches"] += 1
        s.stats["launch_ms"] += (time.perf_counter() - t0) * 1e3
        return rec

    def launch(self, grid: int, block: int, args: Dict[str, object],
               stream: Optional[Stream] = None) -> LaunchRecord:
        """Blocking launch: enqueue, then drive until this launch (and by
        stream order, everything before it) completes."""
        rec = self.launch_async(grid, block, args, stream=stream)
        rec.wait()
        return rec

    def _bind(self, args: Dict[str, object]
              ) -> Tuple[Dict[str, object], Dict[str, DeviceBuffer]]:
        eng_args: Dict[str, object] = {}
        bindings: Dict[str, DeviceBuffer] = {}
        names = set()
        for p in self.program.params:
            names.add(p.name)
            if p.name not in args:
                raise ValueError(f"{self.name}: missing argument {p.name}")
            v = args[p.name]
            if isinstance(p, ir.Ptr):
                if not isinstance(v, DeviceBuffer):
                    raise TypeError(
                        f"{self.name}: parameter {p.name!r} is a buffer — "
                        f"pass a DeviceBuffer from session.alloc() (got "
                        f"{type(v).__name__}); host arrays go through "
                        "buf.copy_from_host()")
                if v.session is not self.session:
                    raise ValueError(
                        f"{self.name}: buffer {p.name!r} belongs to a "
                        "different session")
                v._check_alive()
                if v.dtype != p.dtype:
                    raise TypeError(
                        f"{self.name}: buffer {p.name!r} has dtype "
                        f"{v.dtype}, parameter expects {p.dtype}")
                eng_args[p.name] = v          # Engine unwraps the handle
                bindings[p.name] = v
            else:
                if isinstance(v, DeviceBuffer):
                    raise TypeError(
                        f"{self.name}: parameter {p.name!r} is a scalar, "
                        "got a DeviceBuffer")
                eng_args[p.name] = v
        unknown = set(args) - names
        if unknown:
            raise ValueError(
                f"{self.name}: unknown argument(s) {sorted(unknown)}")
        return eng_args, bindings

    def __repr__(self) -> str:
        sig = ", ".join(f"{p.name}:{p.kind}[{p.dtype}]"
                        for p in self.params)
        return f"<Function {self.name}({sig})>"


class Module:
    """A loaded hetIR "binary": one or more entry points, looked up by
    name via :meth:`function`.  A single-entry module can itself be used
    as the function (``module.launch_async(...)``) — the driver-API
    convenience for the overwhelmingly common one-kernel case."""

    def __init__(self, session: "HetSession",
                 programs: Sequence[ir.Program]):
        self.session = session
        self._functions: Dict[str, Function] = {}
        for prog in programs:
            prog.validate()
            self._functions[prog.name] = Function(session, prog)

    def function(self, name: Optional[str] = None) -> Function:
        if name is None:
            if len(self._functions) != 1:
                raise ValueError(
                    "module has multiple entry points "
                    f"({sorted(self._functions)}); name one")
            return next(iter(self._functions.values()))
        try:
            return self._functions[name]
        except KeyError:
            raise KeyError(
                f"module has no function {name!r} "
                f"(entries: {sorted(self._functions)})") from None

    def functions(self) -> Tuple[str, ...]:
        return tuple(self._functions)

    # single-entry convenience: the module acts as its only function
    @property
    def params(self) -> Tuple[ParamInfo, ...]:
        return self.function().params

    def launch_async(self, *a, **kw) -> LaunchRecord:
        return self.function().launch_async(*a, **kw)

    def launch(self, *a, **kw) -> LaunchRecord:
        return self.function().launch(*a, **kw)

    def __repr__(self) -> str:
        return f"<Module entries={sorted(self._functions)}>"


# ---------------------------------------------------------------------------
# The session (device context)
# ---------------------------------------------------------------------------

class HetSession:
    """One "device context" bound to a backend and a torch device, with
    streams, events, typed device memory, and migration support."""

    def __init__(self, backend: str = "cuda",
                 opt_level: Optional[int] = None,
                 cache: Optional[TranslationCache] = None,
                 store: Optional[Union[str, DiskStore]] = None,
                 shared: Optional[Union[str, SharedStore]] = None,
                 specialize: Optional[bool] = None,
                 pool: Optional[Union[BufferPool, bool]] = None,
                 trace_cap: Optional[int] = None,
                 starvation_guard: Optional[int] = None,
                 device=None):
        self.device = resolve_device(device)
        # specialize: None = policy default (HETGPU_SPECIALIZE / auto),
        # True = force launch-time specialization, False = always generic
        self.specialize = specialize
        # pool: None = a default bounded BufferPool (HETGPU_POOL_MAX_BYTES),
        # False = pooling off, or a caller-provided BufferPool instance
        if pool is None or pool is True:
            pool = BufferPool()
        elif pool is False:
            pool = BufferPool(enabled=False)
        self.pool: BufferPool = pool
        if trace_cap is None:
            trace_cap = int(os.environ.get("HETGPU_SCHED_TRACE_CAP",
                                           _DEFAULT_TRACE_CAP))
        # starvation guard period: every Nth scheduling decision serves
        # the longest-waiting runnable stream regardless of priority and
        # weight (0 disables — pure priority/WFQ)
        if starvation_guard is None:
            starvation_guard = int(os.environ.get(
                "HETGPU_STARVATION_GUARD", "32"))
        self.starvation_guard = max(0, int(starvation_guard))
        self.backend_name = backend
        if store is not None and not isinstance(store, DiskStore):
            store = DiskStore(store)
        if shared is not None and not isinstance(shared, SharedStore):
            shared = SharedStore(shared)
        if cache is None and (store is not None or shared is not None):
            # a session opened "against a store": private memory tier,
            # persistent disk tier — translations survive this process —
            # and optionally the cluster fabric underneath
            cache = TranslationCache(store=store, shared=shared)
        elif cache is not None:
            if store is not None:
                if cache.store is None:
                    cache.store = store
                elif cache.store.dir.resolve() != store.dir.resolve():
                    raise ValueError(
                        "cache is already bound to a different store "
                        f"({cache.store.dir}); refusing to silently ignore "
                        f"store={store.dir}")
            if shared is not None:
                if cache.shared is None:
                    cache.shared = shared
                elif cache.shared.dir.resolve() != shared.dir.resolve():
                    raise ValueError(
                        "cache is already bound to a different shared tier "
                        f"({cache.shared.dir}); refusing to silently ignore "
                        f"shared={shared.dir}")
        self.backend: Backend = get_backend(backend, cache=cache,
                                            device=self.device)
        self.cache: TranslationCache = self.backend.cache
        self.opt_level = DEFAULT_OPT_LEVEL if opt_level is None \
            else max(0, min(int(opt_level), OPT_MAX))

        # -- object model state -------------------------------------------
        self._functions: Dict[str, Function] = {}
        self._buffers_by_uid: Dict[str, DeviceBuffer] = {}
        self._seq = itertools.count()
        #: the *active* streams — the scheduler's scan set.  Destroyed
        #: streams are removed, so a long-lived serving session that has
        #: created (and retired) thousands of streams still schedules in
        #: O(active).
        self.streams: List[Stream] = []
        self._sid_counter = itertools.count()
        # scheduler state: decision counter (starvation guard + LRU
        # tie-break) and the virtual clock newly-runnable streams sync to
        self._picks = 0
        self._vclock = 0.0
        self.default_stream = self.stream()          # sid 0
        #: scheduler trace: one entry per executed segment or async copy
        #: {"stream", "kernel", "seq", "node_idx"} — the observable
        #: interleaving (tests assert alternation and fair shares on it).
        #: A capped ring: the newest ``trace_cap`` entries are kept and
        #: ``stats["sched_trace_dropped"]`` counts evictions.
        self.sched_trace = TraceRing(trace_cap)
        self.pause_flag = False  # the paper's cooperative pause flag

        # -- legacy shim state --------------------------------------------
        self._named: Dict[str, DeviceBuffer] = {}    # gpu_malloc names
        self._named_shapes: Dict[str, Tuple[int, ...]] = {}  # host shapes
        self._legacy_streams: Dict[int, Stream] = {0: self.default_stream}
        # append-only per-legacy-stream launch history (old `_streams`
        # shape: Dict[int, List[LaunchRecord]])
        self._streams: Dict[int, List[LaunchRecord]] = {0: []}

        self.stats = {"launches": 0, "launch_ms": 0.0, "translate_ms": 0.0,
                      "segments_executed": 0, "migrations": 0,
                      "async_copies": 0, "sched_trace_dropped": 0,
                      "streams_retired": 0,
                      "cache_hits": 0, "cache_misses": 0,
                      "cache_evictions": 0, "cache_restored": 0,
                      "cache_translated": 0}
        # translate_ms is reported as this session's *delta* over the
        # (possibly shared) cache's lifetime counter
        self._translate_ms_base = float(
            self.cache.stats().get("translate_ms", 0.0))

    # -- cache stats -------------------------------------------------------
    def cache_stats(self) -> Dict[str, object]:
        """Shared translation-cache counters (paper §4.2 JIT cache)."""
        return self.cache.stats()

    def block_stats(self) -> Dict[str, object]:
        """Block-tiled fast-path counters for backends that have one
        (cuda): segment executions that took the ``tiled`` vs ``scalar``
        path and the per-reason refusal histogram.  Empty for backends
        without a tiled path."""
        st = getattr(self.backend, "block_stats", None)
        if not st:
            return {}
        return {"tiled": st["tiled"], "scalar": st["scalar"],
                "reasons": dict(st["reasons"])}

    def _sync_cache_stats(self) -> None:
        st = self.cache.stats()
        self.stats["cache_hits"] = st["hits"]
        self.stats["cache_misses"] = st["misses"]
        self.stats["cache_evictions"] = st["evictions"]
        self.stats["cache_restored"] = st["restored"]
        self.stats["cache_translated"] = st["translated"]
        self.stats["translate_ms"] = (
            float(st.get("translate_ms", 0.0)) - self._translate_ms_base)

    # -- module loading ----------------------------------------------------
    def load(self, program: Union[ir.Program, Sequence[ir.Program]]
             ) -> Module:
        """Load one hetIR program (or several) into a :class:`Module`.
        Translation stays lazy, at first launch (paper §4.2 Module
        Loading and JIT)."""
        programs = [program] if isinstance(program, ir.Program) \
            else list(program)
        mod = Module(self, programs)
        self._functions.update(mod._functions)
        return mod

    def function(self, name: str) -> Function:
        """Look up a loaded entry point by name across all modules."""
        try:
            return self._functions[name]
        except KeyError:
            raise KeyError(f"no loaded kernel {name!r} "
                           f"(loaded: {sorted(self._functions)})") from None

    # -- device memory -----------------------------------------------------
    def alloc(self, shape, dtype: object = np.float32) -> DeviceBuffer:
        """Allocate a typed :class:`DeviceBuffer` (zero-initialized).
        ``shape`` may be an int or a tuple — device memory is linear, so
        multi-dim shapes are flattened to their total size.  Backings are
        sub-allocated from the session's bounded :class:`BufferPool`
        (``pool=False`` to opt out), so alloc/free churn under serving
        load reuses memory instead of thrashing the host allocator."""
        size = int(shape) if isinstance(shape, (int, np.integer)) \
            else int(np.prod(shape))
        db = DeviceBuffer(self, size, dtype, pool=self.pool)
        self._buffers_by_uid[db.uid] = db
        return db

    def pool_stats(self) -> Dict[str, object]:
        """Buffer-pool counters (hits/misses/reuse_rate/pooled_bytes)."""
        return self.pool.stats()

    # -- streams and events ------------------------------------------------
    def stream(self, weight: float = 1.0, priority: int = 0,
               quantum: int = 1) -> Stream:
        """Create a new asynchronous stream with fair-share scheduling
        policy: ``weight`` (share of segment service while backlogged;
        0 = guard-only), ``priority`` (strict tiers, higher first), and
        ``quantum`` (segments per scheduling decision)."""
        st = Stream(self, next(self._sid_counter), weight=weight,
                    priority=priority, quantum=quantum)
        self.streams.append(st)
        return st

    def _retire_stream(self, st: Stream) -> None:
        try:
            self.streams.remove(st)
        except ValueError:
            pass
        self.stats["streams_retired"] += 1

    def _enqueue_copy(self, kind: str, db: DeviceBuffer,
                      stream: Optional[Stream],
                      host: Optional[np.ndarray] = None) -> CopyRecord:
        st = stream if stream is not None else self.default_stream
        if st.session is not self:
            raise ValueError("stream belongs to a different session")
        rec = CopyRecord(self, kind, db, st, host=host)
        st._enqueue(rec)
        return rec

    def event(self) -> Event:
        return Event(self)

    # -- the cooperative fair-share segment scheduler ----------------------
    def _settle(self) -> None:
        """Retire every ripe non-launch queue item (event records at queue
        front, waits whose event completed) without executing segments."""
        progressed = True
        while progressed:
            progressed = False
            for st in self.streams:
                while st._q:
                    item = st._q[0]
                    if isinstance(item, _EventRecord):
                        # reaching a record point releases every wait
                        # issued against it (or an earlier one); only the
                        # *latest* record completes the event itself — a
                        # superseded marker retires without doing so
                        ev = item.event
                        ev._last_retired_generation = max(
                            ev._last_retired_generation, item.generation)
                        if item.generation == ev._generation:
                            ev._complete = True
                        st._q.popleft()
                        progressed = True
                    elif isinstance(item, _EventWait):
                        if item.satisfied():
                            st._q.popleft()
                            progressed = True
                        else:
                            break
                    else:
                        break

    def step(self, passes: int = 1) -> bool:
        """Public scheduler stepping: make up to ``passes`` scheduling
        decisions.  Each decision picks one runnable stream under the
        priority / weighted-fair-share policy and advances it by up to its
        ``quantum`` of *segments* (the paper's barrier-to-barrier unit) —
        with equal weights and the default quantum of 1 this degenerates
        to exact round-robin.  Returns True iff any progress was made —
        the hook cooperative serving layers (and the stream tests) drive."""
        progressed = False
        for _ in range(passes):
            if not self._step():
                break
            progressed = True
        return progressed

    def _runnable(self) -> List[Stream]:
        """Streams whose front item is executable work (a launch or an
        async copy) right now.  Callers settle first, so event markers at
        queue fronts have already been retired."""
        return [st for st in self.streams
                if st._q and not st.paused
                and isinstance(st._q[0], (LaunchRecord, CopyRecord))]

    def _pick(self) -> Optional[Stream]:
        """One scheduling decision: highest priority tier first, least
        weighted virtual time within the tier (ties broken
        least-recently-served, then by sid).  Every ``starvation_guard``-th
        decision instead serves the longest-waiting runnable stream
        outright — the guard that keeps zero-weight / low-priority
        streams progressing under sustained load."""
        if self.pause_flag:
            return None
        runnable = self._runnable()
        if not runnable:
            return None
        self._picks += 1
        guard = self.starvation_guard
        if guard and self._picks % guard == 0:
            st = min(runnable, key=lambda s: (s._last_pick, s.sid))
        else:
            # zero-weight streams opt out of competition entirely: they
            # are served by the guard or when nothing weighted is
            # runnable, and never advance the virtual clock
            weighted = [s for s in runnable if s.weight > 0]
            pool_ = weighted or runnable
            top = max(s.priority for s in pool_)
            st = min((s for s in pool_ if s.priority == top),
                     key=lambda s: (s._vtime, s._last_pick, s.sid))
        st._last_pick = self._picks
        if st.weight > 0:
            self._vclock = max(self._vclock, st._vtime)
        return st

    def _preempt_for_higher_priority(self, cur: Stream) -> bool:
        """Mid-quantum yield check (the engine's segment-boundary hook):
        a runnable stream in a strictly higher priority tier takes the
        next scheduling decision."""
        return any(st.priority > cur.priority for st in self._runnable()
                   if st is not cur)

    def _trace(self, st: Stream, kernel: str, seq: int,
               node_idx: int) -> None:
        self.sched_trace.append(
            {"stream": st.sid, "kernel": kernel, "seq": seq,
             "node_idx": node_idx})
        self.stats["sched_trace_dropped"] = self.sched_trace.dropped

    def _step(self) -> bool:
        self._settle()
        st = self._pick()
        if st is None:
            return False
        item = st._q[0]
        if isinstance(item, CopyRecord):
            # data movement is scheduled work: one decision, one copy
            try:
                item._execute()
            except Exception:
                st._q.popleft()     # don't wedge the stream on the error
                raise
            st._q.popleft()
            st._charge(1.0)
            self._trace(st, f"<{item.kind}>", item.seq, -1)
            self.stats["async_copies"] += 1
            self._settle()
            return True
        try:
            eng = item.engine   # lazy copy-in happens here, at start
        except Exception:
            # e.g. a freed-buffer bind: withdraw the poisoned launch so
            # the stream is not permanently wedged, then surface it
            st._q.popleft()
            item.cancelled = True
            raise
        quantum = st.quantum
        executed = 0

        def _boundary(e: Engine) -> bool:
            # segment-boundary yield hook: trace + charge each segment,
            # end the quantum when it is spent or a higher-priority
            # stream became runnable (preemption at the barrier)
            nonlocal executed
            executed += 1
            st._charge(1.0)
            self._trace(st, e.program.name, item.seq, e.node_idx)
            self.stats["segments_executed"] += 1
            return (executed >= quantum
                    or self._preempt_for_higher_priority(st))

        finished = eng.run(on_segment=_boundary)
        if finished:
            st._q.popleft()
            item._finish()
        self._settle()
        return True

    def _drain(self, until: Optional[Callable[[], bool]] = None) -> bool:
        """Drive the scheduler until ``until()`` holds (or, with no
        condition, until every stream drains).  Returns False when
        progress stops on cooperatively paused work (per-stream ``pause``
        or the session ``pause_flag``); raises on a genuine event
        deadlock."""
        t0 = time.perf_counter()
        try:
            while True:
                self._settle()
                if until is not None and until():
                    return True
                pending = [st for st in self.streams if st._q]
                if not pending:
                    return True if until is None else bool(until())
                if self._step():
                    continue
                # no progress: paused work holds the rest, or a deadlock
                if self.pause_flag or any(st.paused for st in pending):
                    return False
                fronts = "; ".join(
                    f"stream {st.sid}: {st._describe_front()}"
                    for st in pending)
                raise RuntimeError(
                    "stream scheduler deadlock — queues are non-empty but "
                    f"nothing is runnable ({fronts})")
        finally:
            self.stats["launch_ms"] += (time.perf_counter() - t0) * 1e3
            self._sync_cache_stats()

    def synchronize(self) -> bool:
        """Drive *all* streams to completion (the old
        ``device_synchronize`` only swept stream 0).  Returns False if
        paused work remains."""
        return self._drain()

    # -- cache warm-up -----------------------------------------------------
    def warmup(self, programs: Iterable, grids: Sequence[Tuple[int, int]]
               = ((2, 32),)) -> Dict[str, object]:
        """Ahead-of-time translate a kernel set (paper §4.2: JIT cost is
        paid per *cluster lifetime* — a node expecting migrated work can
        translate it before the work arrives).

        ``programs`` is an iterable of ``ir.Program`` or ``(ir.Program,
        example_args)`` pairs; ``grids`` is a sequence of ``(grid, block)``
        geometries to specialize for.  When no example args are given they
        are synthesized (unit scalars, zero buffers sized ``grid*block``)
        and any kernel the synthetic args cannot drive is reported —
        warm-up is best-effort by design.  Each warm-up launch runs on
        scratch copies; session buffers are untouched.

        Returns a report: per-kernel status plus how many translations
        were ``restored`` from the disk store versus freshly
        ``translated`` (warm restarts of ``interp`` see ``translated ==
        0``; on ``cuda`` only the block-path verdicts, which cost
        microseconds and stay in memory, are made again, and every segment
        library is restored), how many restores were ``fetched`` from the
        shared tier, and how many lookups hit the in-memory cache
        (``cache_hits``).
        """
        report: Dict[str, object] = {"kernels": [], "translated": 0,
                                     "restored": 0, "cache_hits": 0,
                                     "fetched": 0, "errors": 0}
        for item in programs:
            prog, args = item if isinstance(item, tuple) else (item, None)
            for grid, block in grids:
                before = self.cache.stats()
                entry = {"kernel": prog.name, "grid": grid, "block": block}
                t0 = time.perf_counter()
                try:
                    use_args = dict(args) if args is not None else \
                        _synthesize_args(prog, grid, block)
                    # synthesized args carry made-up unit scalars: never
                    # specialize on them — it would warm (and persist) a
                    # variant no real launch will ask for, and burn one of
                    # the program's specialization-budget slots.  The
                    # generic entries warmed instead are the ones budget
                    # fallbacks and policy-off launches share.  Explicit
                    # example args warm whatever a real launch would run.
                    eng = Engine(prog, self.backend, grid, block, use_args,
                                 opt_level=self.opt_level,
                                 specialize=(False if args is None
                                             else self.specialize))
                    eng.run()
                    entry["status"] = "ok"
                except Exception as exc:  # best-effort: report, don't raise
                    entry["status"] = f"error: {type(exc).__name__}: {exc}"
                    report["errors"] += 1
                after = self.cache.stats()
                for field_ in ("translated", "restored"):
                    entry[field_] = after[field_] - before[field_]
                    report[field_] += entry[field_]
                entry["fetched"] = (after["shared_fetches"]
                                    - before["shared_fetches"])
                report["fetched"] += entry["fetched"]
                entry["cache_hits"] = after["hits"] - before["hits"]
                report["cache_hits"] += entry["cache_hits"]
                entry["ms"] = round((time.perf_counter() - t0) * 1e3, 2)
                report["kernels"].append(entry)
        self._sync_cache_stats()
        return report

    # -- checkpoint / restore / migration ----------------------------------
    def checkpoint(self, rec: LaunchRecord) -> bytes:
        """Serialize a launch paused at a barrier (or finished) — the
        migration payload.  Works on in-flight async launches: between
        scheduler steps every launch sits at a barrier by construction."""
        return rec.engine.snapshot().to_bytes()

    def restore(self, kernel: Union[str, Function], blob: bytes,
                stream: Union[None, int, Stream] = None) -> LaunchRecord:
        """Re-instantiate a checkpoint onto a caller-chosen stream
        (default stream if None; a legacy int names an old-style stream).

        Buffer identity: each restored global re-binds the session's live
        :class:`DeviceBuffer` with the snapshot's recorded uid when one
        exists (same size/dtype) — a checkpoint/restore round-trip in one
        session lands results in the *same* buffer objects.  Unknown uids
        get fresh buffers that *adopt* the snapshot uid, so identity stays
        stable across chained migrations."""
        snap = Snapshot.from_bytes(blob)
        fn = kernel if isinstance(kernel, Function) \
            else self.function(kernel)
        eng = Engine.resume(fn.program, self.backend, snap)
        history_key: Optional[int] = None
        if isinstance(stream, (int, np.integer)):
            # legacy int stream: the history view below must use the
            # caller's id, which need not equal the Stream's internal sid
            history_key = int(stream)
            st = self._legacy_stream(history_key)
        elif stream is None:
            st = self.default_stream
        elif stream.session is not self:
            raise ValueError("stream belongs to a different session")
        else:
            st = stream
        bindings: Dict[str, DeviceBuffer] = {}
        for name, arr in eng.state.globals_.items():
            uid = eng.buffer_uids.get(name)
            db = self._buffers_by_uid.get(uid) if uid else None
            if db is not None and (db.size != arr.numel()
                                   or db.data.dtype != arr.dtype
                                   or db.freed):
                db = None
            if db is None:
                db = DeviceBuffer(self, arr.numel(), arr.dtype, uid=uid)
                self._buffers_by_uid[db.uid] = db
            # seed with checkpoint contents so host reads before
            # completion observe the paused state
            db.data.copy_(arr)
            bindings[name] = db
        rec = LaunchRecord(self, fn, snap.num_blocks, snap.block_size,
                           None, bindings, st, engine=eng)
        if eng.finished:
            rec._finish()
        else:
            st._enqueue(rec)
        self._streams.setdefault(
            st.sid if history_key is None else history_key, []).append(rec)
        return rec

    def run_to_completion(self, rec: LaunchRecord) -> None:
        """Drive the scheduler until ``rec`` finishes (equivalent to
        ``rec.wait()``; kept for the pre-driver-API callers)."""
        rec.wait()
        self._sync_cache_stats()

    # ======================================================================
    # Deprecated string-keyed shim (old→new table in docs/API.md)
    # ======================================================================
    def load_kernel(self, program: ir.Program) -> str:
        """Deprecated: use :meth:`load` (returns a :class:`Module`)."""
        _deprecated("load_kernel(program)", "session.load(program)")
        self.load(program)
        return program.name

    def gpu_malloc(self, name: str, shape, dtype=np.float32) -> torch.Tensor:
        """Deprecated: use :meth:`alloc` (returns a typed
        :class:`DeviceBuffer` handle instead of registering a name).

        The old surface preserved multi-dim shapes and accepted any numpy
        dtype; the shim keeps both (the returned tensor is a shape-intact
        *view* of the underlying linear buffer, on the session's
        device)."""
        _deprecated("gpu_malloc(name, shape)", "session.alloc(shape, dtype)")
        db = self.alloc(shape, dtype)
        self._named[name] = db
        self._named_shapes[name] = (int(shape),) \
            if isinstance(shape, (int, np.integer)) \
            else tuple(int(d) for d in shape)
        return db.data.view(self._named_shapes[name])

    def memcpy_h2d(self, name: str, host) -> None:
        """Deprecated: use :meth:`DeviceBuffer.copy_from_host`."""
        _deprecated("memcpy_h2d(name, host)", "buffer.copy_from_host(host)")
        host = to_numpy(host) if isinstance(host, torch.Tensor) \
            else np.asarray(host)
        db = self._named.get(name)
        if db is None or db.size != host.size or db.np_dtype != host.dtype:
            # old memcpy_h2d rebound the name wholesale; emulate
            db = self.alloc(host.size, host.dtype)
            self._named[name] = db
        self._named_shapes[name] = host.shape
        db.copy_from_host(host)

    def memcpy_d2h(self, name: str) -> np.ndarray:
        """Deprecated: use :meth:`DeviceBuffer.copy_to_host`."""
        _deprecated("memcpy_d2h(name)", "buffer.copy_to_host()")
        out = self._named[name].copy_to_host()
        shape = self._named_shapes.get(name)
        return out.reshape(shape) if shape is not None else out

    def _legacy_stream(self, sid: int) -> Stream:
        st = self._legacy_streams.get(sid)
        if st is None:
            st = self.stream()
            self._legacy_streams[sid] = st
        return st

    def launch(self, kernel: str, grid: int, block: int,
               args: Dict[str, object], stream: int = 0,
               blocking: bool = True) -> LaunchRecord:
        """Deprecated: use :meth:`Function.launch` /
        :meth:`Function.launch_async` with DeviceBuffer arguments.

        Shim semantics (unchanged where safe, fixed where lossy): buffer
        params resolve from explicit ``args`` first, then by name against
        ``gpu_malloc`` buffers.  A resolved session buffer — including one
        the caller passed *explicitly* (the old code silently dropped
        those writes) — receives the kernel's writes in place.  A raw host
        array passed explicitly keeps copy-in semantics and is never
        mutated; read results via the record's engine."""
        _deprecated("launch(kernel, ...)",
                    "module.function(name).launch_async(...)")
        fn = self.function(kernel)
        eng_args: Dict[str, object] = {}
        bindings: Dict[str, DeviceBuffer] = {}
        for p in fn.program.params:
            named = self._named.get(p.name) \
                if isinstance(p, ir.Ptr) else None
            if p.name in args:
                v = args[p.name]
                if isinstance(v, DeviceBuffer):
                    eng_args[p.name] = v
                    bindings[p.name] = v
                elif named is not None and _shares_memory(v, named.data):
                    # an explicitly passed session buffer (or the
                    # gpu_malloc-returned view of it) is still a session
                    # buffer and receives the kernel's writes
                    eng_args[p.name] = named
                    bindings[p.name] = named
                else:
                    eng_args[p.name] = v
            elif named is not None:
                eng_args[p.name] = named
                bindings[p.name] = named
            else:
                raise ValueError(f"missing argument {p.name}")
        st = self._legacy_stream(stream)
        t0 = time.perf_counter()
        rec = LaunchRecord(self, fn, grid, block, eng_args, bindings, st)
        rec._materialize()      # old surface bound eagerly; tests poke
        st._enqueue(rec)        # rec.engine right after a non-blocking
        self._streams.setdefault(stream, []).append(rec)  # legacy view
        self.stats["launches"] += 1
        self.stats["launch_ms"] += (time.perf_counter() - t0) * 1e3
        if blocking:
            rec.wait()
        self._sync_cache_stats()
        return rec

    def device_synchronize(self, stream: int = 0) -> None:
        """Deprecated: use :meth:`Stream.synchronize` (one stream) or
        :meth:`HetSession.synchronize` (all streams).  Unlike the old
        implementation this *completes* the results: kernel writes land in
        the session buffers (the old path ran the engines but never wrote
        back — non-blocking launches silently dropped their results)."""
        _deprecated("device_synchronize(stream)",
                    "stream.synchronize() / session.synchronize()")
        self._legacy_stream(stream).synchronize()


def _shares_memory(value, data: torch.Tensor) -> bool:
    """Is ``value`` (a tensor, or a host array over a CPU tensor's memory)
    a view of the buffer ``data``?"""
    if isinstance(value, torch.Tensor):
        return value.device == data.device and \
            value.untyped_storage().data_ptr() \
            == data.untyped_storage().data_ptr()
    return isinstance(value, np.ndarray) and data.device.type == "cpu" \
        and np.shares_memory(value, data.numpy())


def _synthesize_args(prog: ir.Program, grid: int,
                     block: int) -> Dict[str, object]:
    """Best-effort example arguments for warm-up launches: unit scalars
    and ``grid*block``-sized zero buffers (covers gid-indexed kernels; a
    kernel needing real geometry scalars should be warmed with explicit
    example args)."""
    args: Dict[str, object] = {}
    for p in prog.params:
        if isinstance(p, ir.Ptr):
            args[p.name] = np.zeros(grid * block, dtype=ir.np_dtype(p.dtype))
        else:
            args[p.name] = ir.np_dtype(p.dtype).type(1)
    return args


def migrate(rec: LaunchRecord, src: HetSession, dst: HetSession,
            kernel: Union[str, Function],
            stream: Optional[Stream] = None) -> LaunchRecord:
    """Live-migrate a launch from one session/backend to another
    (paper §6.3).  Works on in-flight *async* launches: the scheduler only
    ever rests a launch at a barrier, so the checkpoint below is always
    legal.  Returns the resumed launch on ``dst`` (landing on ``stream``,
    default stream if None); the source record is cancelled — the moved
    launch must not also finish on the source.  Timing stats are recorded
    on both sessions.

    Specialization keys ride along: the snapshot records the source
    engine's bound-scalar vector, and ``Engine.resume`` re-derives the
    identical specialized body from it (never re-consulting the policy),
    so a mid-kernel checkpoint of a specialized kernel restores
    bit-identical.  DeviceBuffer uids ride along too: the destination's
    restored buffers adopt them, keeping buffer identity stable across
    chained hops.  The snapshot is host numpy, so the two sessions may
    live on different devices.

    Before resuming, the destination's translation cache is preloaded from
    its own tiers (local store, then shared fabric), or else from the
    source's fabric, then the source's local store: if this program was
    ever translated for the destination backend within the fabric's
    lifetime, the migrated launch pays no translation — on ``cuda``, no
    ``nvcc``.  The preload is keyed on the *optimized* program's
    fingerprint, which is what every cache key carries."""
    t0 = time.perf_counter()
    blob = src.checkpoint(rec)  # capture at barrier
    rec.cancel()
    t1 = time.perf_counter()
    fp = ir.program_fingerprint(rec.engine.program)
    restored = 0
    if dst.cache.store is not None or dst.cache.shared is not None:
        restored = dst.cache.preload(backend=dst.backend_name,
                                     fingerprint=fp)
    else:
        store = src.cache.shared if src.cache.shared is not None \
            else src.cache.store
        if store is not None:
            restored = dst.cache.preload(backend=dst.backend_name,
                                         fingerprint=fp, store=store)
    t2 = time.perf_counter()
    new = dst.restore(kernel, blob, stream=stream)  # reload + reshard
    t3 = time.perf_counter()
    src.stats["migrations"] += 1
    dst.stats["migrations"] += 1
    dst.stats["last_migration"] = {
        "checkpoint_ms": (t1 - t0) * 1e3,
        "warmup_ms": (t2 - t1) * 1e3,
        "restore_ms": (t3 - t2) * 1e3,
        "payload_bytes": len(blob),
        "cache_restored": restored,
    }
    return new
