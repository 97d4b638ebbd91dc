"""Self-healing worker fleet — the paper's live-migration claim at
production scale (§6.3 migration, §4.3 state capture, under failure).

* **Workers** (:func:`_worker_main`) are separate OS processes, started
  with ``spawn`` (CUDA cannot be used in a forked child), each owning a
  full :class:`~repro_torch.core.runtime.HetSession` bound to its own
  backend and device — ``cuda`` on the card, ``interp`` or ``vectorized``
  on the host: a fleet can be heterogeneous, which is the paper's whole
  point.  The coordinator talks to each worker over a ``multiprocessing``
  pipe with a strict request/reply protocol; kernels execute in bounded
  *segment slices* (:meth:`~repro_torch.core.runtime.LaunchRecord.
  advance`), so between slices every launch rests at a barrier — exactly
  where the paper's snapshot is legal — and the control plane can
  interpose.  A worker on the card synchronises its device before it
  replies, so an acknowledged slice has run, and a worker killed between
  slices leaves nothing the coordinator waits on.

* The **control plane** (:class:`FleetCoordinator`) dispatches accepted
  launches to the least-loaded alive worker and pumps slices round-robin.
  Migration is *policy-driven* rather than caller-driven:
  :meth:`~FleetCoordinator.drain` moves a worker's in-flight launches
  elsewhere via checkpoint/restore (graceful — live state rides along,
  across backends: the snapshot is host numpy),
  :meth:`~FleetCoordinator.rebalance` evens out load the same way, and
  :meth:`~FleetCoordinator.evacuate_on_failure` handles the ungraceful
  case: a dead worker's state is gone, so its launches *replay* from the
  retry queue on a surviving worker — bit-identically, because every
  backend follows the reference interpreter bit for bit.

* The **two-tier retry queue** (:class:`RetryQueue`) makes every accepted
  launch durable until acked: an in-memory tier for dispatch bookkeeping
  plus a JSON-on-disk persistent tier (atomic temp-file + ``os.replace``
  writes, ndarray args base64-encoded bit-exactly), so a coordinator
  restart recovers unacked work and a double ack is structurally
  impossible (``ack`` consumes exactly once).  The record layout is the
  JAX package's, so a queue directory written by either package is
  recovered by the other.

* The **fault-injection harness** (:class:`FaultInjector`) is the proof.
  It is env-gated (``HETGPU_FAULT_PLAN`` — a JSON plan, or ``@path`` to
  one; ``HETGPU_FAULT_SEED`` resolves any unpinned choices
  deterministically) and runs *inside* the worker: at a named fault
  point — ``pre-launch``, ``mid-kernel`` (at a segment boundary, with the
  segment's kernel enqueued on the card), or ``post-checkpoint-pre-ack``
  (work complete, ack never sent) — it SIGKILLs the worker process, no
  cleanup.  The coordinator must detect the death, requeue, replay, and
  still produce bit-identical results with zero lost and zero
  double-acked launches.

Workers attached to the same ``store_dir`` share one persistent
:class:`~repro_torch.core.cache.DiskStore`, and with ``shared_dir`` one
cluster fabric, so a kernel is translated — on ``cuda``, built by
``nvcc`` — once per fleet (single-flight cross-process locking lives in
:mod:`~repro_torch.core.cache`).
"""
from __future__ import annotations

import base64
import itertools
import json
import os
import pickle
import signal
import tempfile
import time
import traceback
import uuid
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import hetir as ir

#: the named fault points a :class:`FaultInjector` can kill a worker at
PRE_LAUNCH = "pre-launch"
MID_KERNEL = "mid-kernel"
POST_CHECKPOINT_PRE_ACK = "post-checkpoint-pre-ack"
FAULT_POINTS = (PRE_LAUNCH, MID_KERNEL, POST_CHECKPOINT_PRE_ACK)

#: default per-RPC timeout: a wedged worker fails loudly, never hangs CI
_DEFAULT_RPC_TIMEOUT = float(os.environ.get("HETGPU_FLEET_TIMEOUT", "60"))


class FleetError(RuntimeError):
    """Base class for fleet control-plane failures."""


class FleetTimeout(FleetError):
    """A worker did not reply within the RPC timeout — it is treated as
    wedged and the operation fails loudly instead of hanging."""


class WorkerLost(FleetError):
    """The worker died mid-conversation (its launches have already been
    requeued by the time this is raised)."""


class FleetWorkerError(FleetError):
    """The worker survived but the command raised; carries the remote
    traceback."""


# ---------------------------------------------------------------------------
# Fault injection (runs inside the worker process)
# ---------------------------------------------------------------------------

class FaultInjector:
    """Deterministic kill-switch for chaos testing.  Each *spec* names a
    fault point and what must match for it to arm:

    ``{"point": "mid-kernel", "worker": 1, "kernel": "dyn_matmul",
       "nth": 1, "after_segments": 3}``

    * ``point`` — one of :data:`FAULT_POINTS`;
    * ``worker`` — worker id the spec applies to (``None`` = any; specs
      for other workers are dropped at construction);
    * ``kernel`` — kernel name filter (``None`` = any);
    * ``nth`` — fire on the n-th matching occurrence (1-based, default 1);
    * ``after_segments`` — for ``mid-kernel``: kill once this many
      segments of the matched launch have executed.  When omitted it is
      resolved from the seed (``HETGPU_FAULT_SEED``), deterministically
      per worker and spec index, so an unpinned plan is still exactly
      reproducible.

    Firing is ``os.kill(os.getpid(), SIGKILL)`` — the hard death the
    self-healing machinery must survive.  The injector is inert with an
    empty plan (the production default: no env var, no faults).
    """

    def __init__(self, specs: Optional[Sequence[Dict]] = None,
                 worker_id: Optional[int] = None, seed: int = 0):
        self.worker_id = worker_id
        rng = np.random.default_rng(
            abs(int(seed)) + 7919 * (worker_id if worker_id else 0))
        self._specs: List[Dict] = []
        for idx, raw in enumerate(specs or []):
            spec = dict(raw)
            if spec.get("point") not in FAULT_POINTS:
                raise ValueError(
                    f"fault spec {idx}: unknown point {spec.get('point')!r} "
                    f"(valid: {FAULT_POINTS})")
            w = spec.get("worker")
            if worker_id is not None and w is not None \
                    and int(w) != worker_id:
                continue
            spec["nth"] = int(spec.get("nth", 1))
            if spec["point"] == MID_KERNEL \
                    and not spec.get("after_segments"):
                spec["after_segments"] = int(rng.integers(1, 6))
            spec["_matched"] = 0
            spec["_armed"] = None   # the launch_id the spec armed on
            self._specs.append(spec)

    @classmethod
    def from_env(cls, worker_id: Optional[int] = None) -> "FaultInjector":
        """Env-gated construction: no ``HETGPU_FAULT_PLAN`` → inert."""
        return cls(load_fault_plan(), worker_id,
                   int(os.environ.get("HETGPU_FAULT_SEED", "0") or 0))

    def _match(self, spec: Dict, kernel: str) -> bool:
        return spec.get("kernel") in (None, kernel)

    def _kill(self) -> None:  # pragma: no cover - the process dies here
        os.kill(os.getpid(), signal.SIGKILL)

    # -- hooks the worker calls at the named points ------------------------
    def begin_launch(self, kernel: str, launch_id: str = "") -> None:
        """Called when a launch starts (or a migrated one restores):
        counts occurrences and arms matching ``mid-kernel`` specs *on
        that launch* — arming is per-launch, so a worker juggling
        several launches (starts arrive before any of them advances)
        keeps the armed spec pointed at the n-th match, not at whichever
        launch happened to start last."""
        for s in self._specs:
            if s["point"] == MID_KERNEL and s["_armed"] is None \
                    and self._match(s, kernel):
                s["_matched"] += 1
                if s["_matched"] == s["nth"]:
                    s["_armed"] = launch_id

    def on_segment(self, kernel: str, segments_done: int,
                   launch_id: str = "") -> None:
        """Called at every segment boundary of the running launch."""
        for s in self._specs:
            if s["point"] == MID_KERNEL and s["_armed"] == launch_id \
                    and s["_armed"] is not None \
                    and segments_done >= s["after_segments"]:
                self._kill()

    def at_point(self, point: str, kernel: str) -> None:
        """Called at ``pre-launch`` / ``post-checkpoint-pre-ack``."""
        for s in self._specs:
            if s["point"] == point and self._match(s, kernel):
                s["_matched"] += 1
                if s["_matched"] == s["nth"]:
                    self._kill()


def load_fault_plan() -> List[Dict]:
    """Parse ``HETGPU_FAULT_PLAN`` (inline JSON, or ``@/path/to.json``).
    Absent/empty → no faults."""
    raw = os.environ.get("HETGPU_FAULT_PLAN", "").strip()
    if not raw:
        return []
    if raw.startswith("@"):
        raw = Path(raw[1:]).read_text()
    plan = json.loads(raw)
    if not isinstance(plan, list):
        raise ValueError("HETGPU_FAULT_PLAN must be a JSON list of specs")
    return plan


# ---------------------------------------------------------------------------
# Durable launch payloads (JSON-safe, bit-exact)
# ---------------------------------------------------------------------------

def _encode_value(v) -> object:
    if isinstance(v, np.ndarray):
        return {"__ndarray__": {
            "dtype": v.dtype.str, "shape": list(v.shape),
            "data": base64.b64encode(np.ascontiguousarray(v).tobytes())
            .decode("ascii")}}
    if isinstance(v, np.generic):
        return {"__npscalar__": {"dtype": v.dtype.str,
                                 "value": v.item()}}
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    raise TypeError(f"launch argument of type {type(v).__name__} is not "
                    "durable (pass scalars or numpy arrays)")


def _decode_value(v):
    if isinstance(v, dict) and "__ndarray__" in v:
        d = v["__ndarray__"]
        return np.frombuffer(
            base64.b64decode(d["data"]),
            dtype=np.dtype(d["dtype"])).reshape(d["shape"]).copy()
    if isinstance(v, dict) and "__npscalar__" in v:
        d = v["__npscalar__"]
        return np.dtype(d["dtype"]).type(d["value"])
    return v


# ---------------------------------------------------------------------------
# Two-tier retry queue: in-memory dispatch state + JSON-on-disk durability
# ---------------------------------------------------------------------------

class RetryQueue:
    """Every accepted launch lives here until acked — the self-healing
    invariant's source of truth.

    States: ``pending`` (awaiting dispatch) → ``inflight`` (on a worker;
    ``attempts`` counts dispatches) → ``acked`` (result delivered,
    terminal).  A worker death moves its inflight records back to
    ``pending`` via :meth:`requeue` — nothing is lost; :meth:`ack`
    consumes exactly once and reports whether *this* call was the first —
    nothing is delivered twice.

    With a ``queue_dir`` every record is mirrored to
    ``<dir>/<launch_id>.json`` with atomic writes (temp file +
    ``os.replace``), numpy args encoded base64 bit-exactly.  A fresh
    :class:`RetryQueue` over the same directory reloads every record;
    :meth:`recover` then demotes stale ``inflight`` records (their
    workers died with the old coordinator) back to ``pending``.
    Memory-only operation (``queue_dir=None``) keeps the same semantics
    minus restart durability.
    """

    def __init__(self, queue_dir: Optional[Union[str, Path]] = None):
        self.dir = Path(queue_dir) if queue_dir is not None else None
        self._records: Dict[str, Dict] = {}
        self._seq = itertools.count()
        if self.dir is not None:
            self.dir.mkdir(parents=True, exist_ok=True)
            self._load()

    # -- persistence -----------------------------------------------------
    def _path(self, launch_id: str) -> Path:
        return self.dir / f"{launch_id}.json"

    def _persist(self, rec: Dict) -> None:
        if self.dir is None:
            return
        blob = json.dumps(rec).encode()
        fd, tmp = tempfile.mkstemp(dir=str(self.dir), suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
            os.replace(tmp, self._path(rec["launch_id"]))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def _load(self) -> None:
        loaded = []
        for path in self.dir.glob("*.json"):
            try:
                rec = json.loads(path.read_text())
                if not isinstance(rec, dict) or "launch_id" not in rec \
                        or rec.get("state") not in ("pending", "inflight",
                                                    "acked"):
                    raise ValueError("bad record")
            except Exception:
                continue  # torn/foreign file: skip, never raise
            loaded.append(rec)
        # preserve enqueue order across restarts
        loaded.sort(key=lambda r: r.get("seq", 0))
        for rec in loaded:
            self._records[rec["launch_id"]] = rec
        if loaded:
            self._seq = itertools.count(
                max(r.get("seq", 0) for r in loaded) + 1)

    # -- lifecycle -------------------------------------------------------
    def enqueue(self, launch_id: str, kernel: str, grid: int, block: int,
                args: Dict[str, object],
                outputs: Sequence[str]) -> Dict:
        if launch_id in self._records:
            raise ValueError(f"launch {launch_id!r} already enqueued")
        rec = {
            "launch_id": launch_id, "kernel": kernel,
            "grid": int(grid), "block": int(block),
            "args": {k: _encode_value(v) for k, v in args.items()},
            "outputs": list(outputs),
            "state": "pending", "attempts": 0, "worker": None,
            "seq": next(self._seq), "enqueued_at": time.time(),
        }
        self._records[launch_id] = rec
        self._persist(rec)
        return rec

    def get(self, launch_id: str) -> Dict:
        return self._records[launch_id]

    def decode_args(self, launch_id: str) -> Dict[str, object]:
        rec = self._records[launch_id]
        return {k: _decode_value(v) for k, v in rec["args"].items()}

    def pending(self) -> List[str]:
        """Launch ids awaiting dispatch, in enqueue order."""
        return [r["launch_id"]
                for r in sorted(self._records.values(),
                                key=lambda r: r["seq"])
                if r["state"] == "pending"]

    def inflight(self, worker: Optional[int] = None) -> List[str]:
        return [r["launch_id"] for r in self._records.values()
                if r["state"] == "inflight"
                and (worker is None or r["worker"] == worker)]

    def unacked(self) -> List[str]:
        return [r["launch_id"] for r in self._records.values()
                if r["state"] != "acked"]

    def mark_inflight(self, launch_id: str, worker: int) -> int:
        """Record a dispatch; returns the attempt number (1 = first)."""
        rec = self._records[launch_id]
        if rec["state"] == "acked":
            raise ValueError(f"launch {launch_id!r} is already acked")
        rec["state"] = "inflight"
        rec["worker"] = int(worker)
        rec["attempts"] += 1
        self._persist(rec)
        return rec["attempts"]

    def reassign(self, launch_id: str, worker: int) -> None:
        """Graceful migration bookkeeping: the launch moved workers with
        its live state — same attempt, new owner."""
        rec = self._records[launch_id]
        rec["worker"] = int(worker)
        self._persist(rec)

    def requeue(self, launch_id: str) -> bool:
        """Worker died (or dispatch failed): back to ``pending`` so it
        replays.  No-op on acked records; returns True if requeued."""
        rec = self._records[launch_id]
        if rec["state"] == "acked":
            return False
        rec["state"] = "pending"
        rec["worker"] = None
        self._persist(rec)
        return True

    def ack(self, launch_id: str) -> bool:
        """Consume exactly once: True iff *this* call transitioned the
        record to ``acked`` — callers must deliver results only then."""
        rec = self._records[launch_id]
        if rec["state"] == "acked":
            return False
        rec["state"] = "acked"
        rec["acked_at"] = time.time()
        self._persist(rec)
        return True

    def is_acked(self, launch_id: str) -> bool:
        return self._records[launch_id]["state"] == "acked"

    def recover(self) -> List[str]:
        """After a coordinator restart: demote stale inflight records
        (their workers belonged to the dead coordinator) to pending.
        Returns the demoted launch ids."""
        demoted = []
        for rec in self._records.values():
            if rec["state"] == "inflight":
                rec["state"] = "pending"
                rec["worker"] = None
                self._persist(rec)
                demoted.append(rec["launch_id"])
        return demoted

    def stats(self) -> Dict[str, int]:
        by_state = {"pending": 0, "inflight": 0, "acked": 0}
        for rec in self._records.values():
            by_state[rec["state"]] += 1
        by_state["total"] = len(self._records)
        by_state["durable"] = self.dir is not None
        return by_state

    def __len__(self) -> int:
        return len(self._records)


# ---------------------------------------------------------------------------
# Worker process
# ---------------------------------------------------------------------------

def _worker_main(worker_id: int, conn, config: Dict) -> None:
    """Worker entry point: one :class:`HetSession` on one backend and
    device (``config["device"]``; ``cuda:0`` when absent, like every entry
    point of the port), a strict request/reply loop over the pipe, fault
    hooks at the named points.  Runs until ``shutdown``, EOF (coordinator
    gone), or the injector kills the process."""
    # import here: under the spawn start method this runs in a fresh
    # interpreter, and the parent's module state does not exist yet
    from .runtime import HetSession

    inj = FaultInjector(config.get("fault_specs"), worker_id,
                        int(config.get("fault_seed", 0)))
    session = HetSession(config.get("backend", "interp"),
                         opt_level=config.get("opt_level"),
                         store=config.get("store_dir"),
                         shared=config.get("shared_dir"),
                         device=config.get("device"))

    def _sync() -> None:
        # the work a reply acknowledges has run on the device
        if session.device.type == "cuda":
            torch.cuda.synchronize(session.device)
    # launch_id -> {"rec", "stream", "kernel", "outputs", "segments"}
    launches: Dict[str, Dict] = {}

    def _outputs(entry) -> Dict[str, np.ndarray]:
        return {name: entry["rec"].buffer(name).copy_to_host()
                for name in entry["outputs"]}

    conn.send(("ready", {"pid": os.getpid(),
                         "backend": config.get("backend", "interp")}))
    while True:
        try:
            cmd, payload = conn.recv()
        except (EOFError, OSError):  # coordinator went away
            return
        try:
            if cmd == "load":
                for prog in pickle.loads(payload["blob"]):
                    session.load(prog)
                conn.send(("ok", {}))
            elif cmd == "start":
                lid, kernel = payload["launch_id"], payload["kernel"]
                inj.begin_launch(kernel, lid)
                inj.at_point(PRE_LAUNCH, kernel)
                fn = session.function(kernel)
                eng_args: Dict[str, object] = {}
                for p in fn.params:
                    v = payload["args"][p.name]
                    if p.kind == "buffer":
                        arr = np.asarray(v)
                        db = session.alloc(arr.size, arr.dtype)
                        db.copy_from_host(arr)
                        eng_args[p.name] = db
                    else:
                        eng_args[p.name] = v
                st = session.stream()
                rec = fn.launch_async(payload["grid"], payload["block"],
                                      eng_args, stream=st)
                launches[lid] = {"rec": rec, "stream": st,
                                 "kernel": kernel, "segments": 0,
                                 "outputs": list(payload["outputs"])}
                conn.send(("ok", {}))
            elif cmd == "advance":
                lid = payload["launch_id"]
                entry = launches[lid]
                rec, kernel = entry["rec"], entry["kernel"]

                def _hook(eng, _e=entry, _k=kernel, _lid=lid):
                    _e["segments"] += 1
                    inj.on_segment(_k, _e["segments"], _lid)
                    return False

                finished = rec.advance(
                    max_segments=payload.get("max_segments"),
                    on_segment=_hook)
                _sync()
                if finished:
                    outs = _outputs(entry)
                    # the work is done and (for a restored launch) its
                    # checkpoint state consumed — but the coordinator has
                    # not heard: the ungraceful-death window the retry
                    # queue must cover
                    inj.at_point(POST_CHECKPOINT_PRE_ACK, kernel)
                    del launches[lid]
                    for db in rec.bindings.values():
                        db.free()
                    entry["stream"].destroy()
                    conn.send(("done", {"outputs": outs,
                                        "segments": entry["segments"]}))
                else:
                    conn.send(("paused",
                               {"segments": entry["segments"]}))
            elif cmd == "checkpoint":
                lid = payload["launch_id"]
                t0 = time.perf_counter()
                entry = launches.pop(lid)
                blob = session.checkpoint(entry["rec"])
                entry["rec"].cancel()
                for db in entry["rec"].bindings.values():
                    db.free()
                entry["stream"].destroy()
                conn.send(("ok", {"blob": blob,
                                  "kernel": entry["kernel"],
                                  "segments": entry["segments"],
                                  "outputs": entry["outputs"],
                                  "ms": (time.perf_counter() - t0) * 1e3}))
            elif cmd == "restore":
                lid, kernel = payload["launch_id"], payload["kernel"]
                t0 = time.perf_counter()
                inj.begin_launch(kernel, lid)
                st = session.stream()
                rec = session.restore(kernel, payload["blob"], stream=st)
                _sync()
                launches[lid] = {"rec": rec, "stream": st,
                                 "kernel": kernel,
                                 "segments": int(payload.get("segments",
                                                             0)),
                                 "outputs": list(payload["outputs"])}
                conn.send(("ok", {"finished": rec.finished,
                                  "ms": (time.perf_counter() - t0) * 1e3}))
            elif cmd == "ping":
                conn.send(("ok", {"pid": os.getpid(),
                                  "inflight": len(launches)}))
            elif cmd == "stats":
                conn.send(("ok", {
                    "inflight": len(launches),
                    "segments_executed":
                        session.stats["segments_executed"],
                    "launches": session.stats["launches"],
                    "kernel_launches": dict(getattr(session.backend,
                                                    "launches", {})),
                    "nvcc": dict(getattr(session.backend, "nvcc", {})),
                    "cache": session.cache_stats()}))
            elif cmd == "shutdown":
                conn.send(("ok", {}))
                return
            else:
                conn.send(("error",
                           {"error": f"unknown command {cmd!r}"}))
        except Exception as exc:
            conn.send(("error", {
                "error": f"{type(exc).__name__}: {exc}",
                "trace": traceback.format_exc()}))


# ---------------------------------------------------------------------------
# Coordinator-side worker handle and tickets
# ---------------------------------------------------------------------------

class _Worker:
    __slots__ = ("wid", "proc", "conn", "backend", "alive", "draining",
                 "launches", "_rr")

    def __init__(self, wid: int, proc, conn, backend: str):
        self.wid = wid
        self.proc = proc
        self.conn = conn
        self.backend = backend
        self.alive = True
        self.draining = False
        self.launches: List[str] = []   # dispatch order
        self._rr = 0                    # round-robin cursor

    def next_launch(self) -> Optional[str]:
        if not self.launches:
            return None
        self._rr = (self._rr + 1) % len(self.launches)
        return self.launches[self._rr]

    def __repr__(self) -> str:
        state = "alive" if self.alive else "dead"
        state += " draining" if self.draining else ""
        return (f"<Worker {self.wid} {self.backend} {state} "
                f"inflight={len(self.launches)}>")


class FleetTicket:
    """Future for a fleet launch: resolves when the coordinator receives
    (and acks) the result — possibly from a different worker, a
    different backend, or a later attempt than the first dispatch."""

    __slots__ = ("launch_id", "kernel", "fleet", "finished", "results",
                 "attempts", "worker", "cancelled")

    def __init__(self, fleet: "FleetCoordinator", launch_id: str,
                 kernel: str):
        self.fleet = fleet
        self.launch_id = launch_id
        self.kernel = kernel
        self.finished = False
        self.cancelled = False          # serving-front duck type
        self.results: Optional[Dict[str, np.ndarray]] = None
        self.attempts = 0
        self.worker: Optional[int] = None

    def done(self) -> bool:
        return self.finished

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Pump the fleet until this launch completes."""
        self.fleet.wait_all(timeout=timeout,
                            until=lambda: self.finished)
        return self.finished

    def result(self, name: str) -> np.ndarray:
        if not self.finished:
            raise RuntimeError(
                f"launch {self.launch_id} has not completed — pump the "
                "fleet (wait()/wait_all()) first")
        return self.results[name]

    @property
    def seq(self) -> str:               # serving-front duck type
        return self.launch_id

    def __repr__(self) -> str:
        state = "finished" if self.finished else "in-flight"
        return (f"<FleetTicket {self.launch_id} {self.kernel} {state} "
                f"attempts={self.attempts}>")


# ---------------------------------------------------------------------------
# The control plane
# ---------------------------------------------------------------------------

class FleetCoordinator:
    """Dispatches launches over IPC to a fleet of worker processes and
    heals around their deaths.

    * ``backends`` — one worker per entry (heterogeneous fleets mix
      cuda / interp / vectorized; snapshots are device-neutral, so any
      launch can land anywhere).
    * ``device`` — the torch device every worker's session runs on
      (``None``: ``cuda:0``, as every entry point of the port; tests pass
      ``"cpu"``).  ``interp`` computes on the host whatever it is.
    * ``queue_dir`` — directory for the retry queue's persistent tier
      (``None`` = in-memory only).
    * ``store_dir`` — shared :class:`~repro_torch.core.cache.DiskStore`
      root every worker session attaches to (translate once per fleet).
    * ``shared_dir`` — cluster cache fabric root
      (:class:`~repro_torch.core.cache.SharedStore`): workers consult the
      fabric before translating, publish what they translate, and take
      their single-flight locks there, so exactly one translation happens
      fleet-wide even across *independent* fleets sharing the directory.
      Defaults to ``HETGPU_CACHE_SHARED_DIR``.  :meth:`prewarm` lets the
      coordinator pre-publish kernels before any worker runs them.
    * ``slice_segments`` — segments granted per pump slice; smaller
      slices mean finer-grained preemption/migration points.
    * ``fault_plan`` / ``fault_seed`` — explicit chaos schedule; both
      default to the env gate (``HETGPU_FAULT_PLAN`` /
      ``HETGPU_FAULT_SEED``), so production fleets are fault-free unless
      deliberately armed.
    * ``respawn`` — spawn a replacement worker (same backend) whenever a
      death is detected.

    Use as a context manager; :meth:`shutdown` is idempotent.
    """

    def __init__(self, backends: Sequence[str] = ("interp",) * 3,
                 queue_dir: Optional[Union[str, Path]] = None,
                 store_dir: Optional[Union[str, Path]] = None,
                 shared_dir: Optional[Union[str, Path]] = None,
                 slice_segments: int = 4,
                 opt_level: Optional[int] = None,
                 fault_plan: Optional[List[Dict]] = None,
                 fault_seed: Optional[int] = None,
                 rpc_timeout: float = _DEFAULT_RPC_TIMEOUT,
                 respawn: bool = False,
                 device=None):
        import multiprocessing as mp
        # spawn: a forked child cannot use CUDA, and must not inherit the
        # coordinator's threads
        self._ctx = mp.get_context("spawn")
        self.device = None if device is None else str(device)
        self.queue = RetryQueue(queue_dir)
        self.store_dir = str(store_dir) if store_dir is not None else None
        if shared_dir is None:
            shared_dir = os.environ.get("HETGPU_CACHE_SHARED_DIR") or None
        self.shared_dir = str(shared_dir) if shared_dir is not None else None
        self.slice_segments = max(1, int(slice_segments))
        self.opt_level = opt_level
        self.rpc_timeout = float(rpc_timeout)
        self.respawn = bool(respawn)
        self.fault_plan = load_fault_plan() if fault_plan is None \
            else list(fault_plan)
        self.fault_seed = int(os.environ.get("HETGPU_FAULT_SEED", "0") or 0) \
            if fault_seed is None else int(fault_seed)
        self._wid = itertools.count()
        self.workers: Dict[int, _Worker] = {}
        self._programs: Dict[str, bytes] = {}       # kernel -> pickled [prog]
        self._buffer_params: Dict[str, Tuple[str, ...]] = {}
        self.tickets: Dict[str, FleetTicket] = {}
        self.counters = {"submitted": 0, "completed": 0, "retried": 0,
                         "evacuated": 0, "migrated": 0, "workers_lost": 0,
                         "workers_spawned": 0, "duplicate_acks": 0}
        #: per-move breakdown of every graceful migration: the source's
        #: checkpoint, the blob's trips through the coordinator, the
        #: destination's restore (ms), and the blob's size
        self.migrations: List[Dict] = []
        #: per-failure recovery log: detection timestamp + the requeued
        #: launches; completions stamp recovery_ms (detect→replay→done)
        self.failures: List[Dict] = []
        for backend in backends:
            self.add_worker(backend)

    # -- lifecycle -------------------------------------------------------
    def __enter__(self) -> "FleetCoordinator":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()

    def add_worker(self, backend: str = "interp") -> int:
        """Spawn one worker process and wait for its handshake."""
        wid = next(self._wid)
        parent, child = self._ctx.Pipe()
        cfg = {"backend": backend, "opt_level": self.opt_level,
               "device": self.device,
               "store_dir": self.store_dir,
               "shared_dir": self.shared_dir,
               "fault_specs": [s for s in self.fault_plan
                               if s.get("worker") in (None, wid)],
               "fault_seed": self.fault_seed}
        proc = self._ctx.Process(target=_worker_main,
                                 args=(wid, child, cfg), daemon=True)
        proc.start()
        child.close()
        w = _Worker(wid, proc, parent, backend)
        self.workers[wid] = w
        self.counters["workers_spawned"] += 1
        status, _ = self._recv(w)       # "ready" handshake
        if status != "ready":
            raise FleetError(f"worker {wid} failed its handshake: {status}")
        for blob in dict.fromkeys(self._programs.values()):
            self._rpc(w, "load", {"blob": blob})
        return wid

    def shutdown(self) -> None:
        """Stop every worker (graceful first, SIGKILL stragglers).  The
        retry queue's persistent tier is left intact for recovery."""
        for w in list(self.workers.values()):
            if not w.alive:
                continue
            try:
                w.conn.send(("shutdown", {}))
                if w.conn.poll(2.0):
                    w.conn.recv()
            except (OSError, EOFError):
                pass
            w.alive = False
        for w in self.workers.values():
            w.proc.join(timeout=5.0)
            if w.proc.is_alive():  # pragma: no cover - stuck worker
                w.proc.kill()
                w.proc.join(timeout=5.0)
            try:
                w.conn.close()
            except OSError:
                pass

    # -- program registry ------------------------------------------------
    def register(self, program) -> None:
        """Register a hetIR program (or a list) with the fleet: pickled
        once here, broadcast to every alive worker, and re-sent to any
        worker spawned later.  Must be re-done after a coordinator
        restart before recovered launches can dispatch."""
        programs = program if isinstance(program, (list, tuple)) \
            else [program]
        blob = pickle.dumps(list(programs),
                            protocol=pickle.HIGHEST_PROTOCOL)
        for prog in programs:
            self._programs[prog.name] = blob
            self._buffer_params[prog.name] = tuple(
                p.name for p in prog.params if isinstance(p, ir.Ptr))
        for w in self._alive():
            self._rpc(w, "load", {"blob": blob})

    def prewarm(self, grids: Sequence[Tuple[int, int]] = ((2, 32),),
                backends: Optional[Sequence[str]] = None) -> Dict[str, object]:
        """Pre-publish translations for every registered kernel into the
        cluster fabric, in-process, before any worker touches them — the
        coordinator pays the one fleet-wide translation up front, and
        every worker (current and future, here and on other hosts sharing
        the fabric) warm-starts from the published translations (on
        ``cuda``, the built segment libraries).

        ``backends`` defaults to the distinct backends of the current
        workers.  Requires a ``shared_dir`` (without a fabric there is
        nowhere to publish — raises ``FleetError``).  Returns a per-backend
        report of :meth:`HetSession.warmup` results."""
        if self.shared_dir is None:
            raise FleetError("prewarm needs a cluster fabric: construct the "
                             "coordinator with shared_dir= (or set "
                             "HETGPU_CACHE_SHARED_DIR)")
        from .runtime import HetSession
        if backends is None:
            backends = sorted({w.backend for w in self.workers.values()})
        programs = [pickle.loads(blob)
                    for blob in dict.fromkeys(self._programs.values())]
        flat = [p for group in programs for p in group]
        report: Dict[str, object] = {}
        for backend in backends:
            session = HetSession(backend, opt_level=self.opt_level,
                                 shared=self.shared_dir, device=self.device)
            report[backend] = session.warmup(flat, grids=grids)
        return report

    # -- submission ------------------------------------------------------
    def submit(self, kernel: str, grid: int, block: int,
               args: Dict[str, object],
               outputs: Optional[Sequence[str]] = None) -> FleetTicket:
        """Accept one launch: durably enqueued (the accept *is* the
        durability point), dispatched by the pump.  ``outputs`` defaults
        to every buffer parameter."""
        if kernel not in self._programs:
            raise KeyError(f"kernel {kernel!r} is not registered — call "
                           "fleet.register(program) first")
        if outputs is None:
            outputs = self._buffer_params[kernel]
        lid = f"L{uuid.uuid4().hex[:12]}"
        self.queue.enqueue(lid, kernel, grid, block, args, outputs)
        ticket = FleetTicket(self, lid, kernel)
        self.tickets[lid] = ticket
        self.counters["submitted"] += 1
        return ticket

    def recover(self) -> List[FleetTicket]:
        """After a coordinator restart over the same ``queue_dir``:
        demote stale inflight records and mint tickets for every unacked
        launch.  Their programs must be :meth:`register`-ed before the
        pump can dispatch them."""
        self.queue.recover()
        out = []
        for lid in self.queue.unacked():
            if lid not in self.tickets:
                rec = self.queue.get(lid)
                ticket = FleetTicket(self, lid, rec["kernel"])
                ticket.attempts = rec["attempts"]
                self.tickets[lid] = ticket
            out.append(self.tickets[lid])
        return out

    # -- RPC plumbing ----------------------------------------------------
    def _alive(self) -> List[_Worker]:
        return [w for w in self.workers.values() if w.alive]

    def _recv(self, w: _Worker, timeout: Optional[float] = None):
        """One reply from ``w`` — raises :class:`WorkerLost` after
        handling the death, :class:`FleetTimeout` on a wedged worker."""
        timeout = self.rpc_timeout if timeout is None else timeout
        try:
            if not w.conn.poll(timeout):
                raise FleetTimeout(
                    f"worker {w.wid} sent no reply within {timeout}s — "
                    "treating it as wedged")
            return w.conn.recv()
        except (EOFError, ConnectionResetError, BrokenPipeError, OSError):
            self._on_worker_death(w)
            raise WorkerLost(f"worker {w.wid} died") from None

    def _rpc(self, w: _Worker, cmd: str, payload: Dict,
             timeout: Optional[float] = None):
        try:
            w.conn.send((cmd, payload))
        except (BrokenPipeError, ConnectionResetError, OSError):
            self._on_worker_death(w)
            raise WorkerLost(f"worker {w.wid} died") from None
        status, reply = self._recv(w, timeout)
        if status == "error":
            raise FleetWorkerError(
                f"worker {w.wid} failed {cmd}: {reply.get('error')}\n"
                f"{reply.get('trace', '')}")
        return status, reply

    # -- failure handling ------------------------------------------------
    def _on_worker_death(self, w: _Worker) -> None:
        """Detection → evacuation: mark dead, requeue every launch it
        owned (nothing acked is touched), optionally respawn."""
        if not w.alive:
            return
        w.alive = False
        w.proc.join(timeout=2.0)
        self.counters["workers_lost"] += 1
        requeued = []
        for lid in list(w.launches):
            if self.queue.requeue(lid):
                requeued.append(lid)
        self.counters["evacuated"] += len(requeued)
        w.launches.clear()
        self.failures.append({"worker": w.wid, "backend": w.backend,
                              "detected_at": time.perf_counter(),
                              "requeued": requeued,
                              "recovered": {}})
        if self.respawn:
            self.add_worker(w.backend)

    def evacuate_on_failure(self, worker_id: int,
                            kill: bool = False) -> List[str]:
        """Failure-evacuation policy, callable directly: with
        ``kill=True`` SIGKILLs the worker first (simulated hard failure),
        then runs the same detect/requeue path the pump takes when it
        notices a death on its own.  Returns the requeued launch ids."""
        w = self.workers[worker_id]
        if kill and w.alive:  # a real kill -9, same as the injector's
            try:
                os.kill(w.proc.pid, signal.SIGKILL)
            except (OSError, ProcessLookupError):
                pass
            w.proc.join(timeout=5.0)
        before = len(self.failures)
        self._on_worker_death(w)
        return self.failures[-1]["requeued"] \
            if len(self.failures) > before else []

    # -- dispatch + pump -------------------------------------------------
    def _pick_worker(self) -> Optional[_Worker]:
        candidates = [w for w in self._alive() if not w.draining]
        if not candidates:
            return None
        return min(candidates, key=lambda w: (len(w.launches), w.wid))

    def _dispatch_pending(self) -> int:
        sent = 0
        for lid in self.queue.pending():
            rec = self.queue.get(lid)
            if rec["kernel"] not in self._programs:
                continue        # recovered launch awaiting register()
            w = self._pick_worker()
            if w is None:
                if not self._alive():
                    raise FleetError(
                        "no alive workers — cannot dispatch "
                        f"{len(self.queue.pending()) + 1} pending "
                        "launch(es); add_worker() or enable respawn")
                break
            attempts = self.queue.mark_inflight(lid, w.wid)
            if attempts > 1:
                self.counters["retried"] += 1
            ticket = self.tickets.get(lid)
            if ticket is not None:
                ticket.attempts = attempts
                ticket.worker = w.wid
            try:
                self._rpc(w, "start", {
                    "launch_id": lid, "kernel": rec["kernel"],
                    "grid": rec["grid"], "block": rec["block"],
                    "args": self.queue.decode_args(lid),
                    "outputs": rec["outputs"]})
            except WorkerLost:
                # the worker died holding this very dispatch (e.g. a
                # pre-launch fault) — it was not in w.launches yet, so
                # the death handler could not requeue it; do it here
                if self.queue.requeue(lid):
                    self.counters["evacuated"] += 1
                    if self.failures:
                        self.failures[-1]["requeued"].append(lid)
                continue
            w.launches.append(lid)
            sent += 1
        return sent

    def _handle_done(self, w: _Worker, lid: str, reply: Dict) -> None:
        if lid in w.launches:
            w.launches.remove(lid)
        if not self.queue.ack(lid):
            # already acked (can only happen if a result raced a
            # migration) — never deliver twice
            self.counters["duplicate_acks"] += 1
            return
        self.counters["completed"] += 1
        ticket = self.tickets.get(lid)
        if ticket is not None:
            ticket.results = reply["outputs"]
            ticket.finished = True
            ticket.worker = w.wid
        now = time.perf_counter()
        for failure in self.failures:
            if lid in failure["requeued"]:
                failure["recovered"][lid] = \
                    (now - failure["detected_at"]) * 1e3

    def pump(self, rounds: int = 1) -> bool:
        """One scheduling sweep per round: dispatch pending launches,
        then grant every busy worker one ``slice_segments`` slice of one
        of its launches (round-robin within the worker).  Worker deaths
        surface here as evacuation + replay, not exceptions.  Returns
        True iff any work was dispatched or advanced."""
        progressed = False
        for _ in range(max(1, int(rounds))):
            # a death detected anywhere in this round *is* progress (its
            # launches were requeued and will re-dispatch next round) —
            # without this, a kill during dispatch reads as a stall
            lost_before = self.counters["workers_lost"]
            if self._dispatch_pending():
                progressed = True
            busy = [(w, w.next_launch()) for w in self._alive()
                    if w.launches]
            busy = [(w, lid) for w, lid in busy if lid is not None]
            if not busy:
                if self.counters["workers_lost"] > lost_before:
                    progressed = True
                if not self.queue.pending():
                    break
                continue
            # phase 1: send every slice (workers run genuinely in
            # parallel); phase 2: collect replies
            issued = []
            for w, lid in busy:
                try:
                    w.conn.send(("advance", {
                        "launch_id": lid,
                        "max_segments": self.slice_segments}))
                    issued.append((w, lid))
                except (BrokenPipeError, ConnectionResetError, OSError):
                    self._on_worker_death(w)
            for w, lid in issued:
                try:
                    status, reply = self._recv(w)
                except WorkerLost:
                    continue    # evacuation already done
                if status == "error":
                    raise FleetWorkerError(
                        f"worker {w.wid} failed advancing {lid}: "
                        f"{reply.get('error')}\n{reply.get('trace', '')}")
                if status == "done":
                    self._handle_done(w, lid, reply)
                progressed = True
            if self.counters["workers_lost"] > lost_before:
                progressed = True
        return progressed

    def wait_all(self, timeout: Optional[float] = None,
                 until=None) -> None:
        """Pump until every accepted launch is acked (or ``until()``
        holds).  Raises :class:`FleetTimeout` on the deadline and
        :class:`FleetError` if work remains but no worker is alive."""
        deadline = None if timeout is None \
            else time.perf_counter() + timeout
        while True:
            if until is not None and until():
                return
            if until is None and not self.queue.unacked():
                return
            if deadline is not None and time.perf_counter() > deadline:
                raise FleetTimeout(
                    f"fleet did not settle within {timeout}s "
                    f"(queue: {self.queue.stats()})")
            if not self.pump():
                # nothing dispatched, nothing advanced — fail loudly
                # instead of spinning (wedged fleets must not hang CI)
                if until is not None and until():
                    return
                missing = sorted({
                    self.queue.get(lid)["kernel"]
                    for lid in self.queue.pending()
                    if self.queue.get(lid)["kernel"]
                    not in self._programs})
                raise FleetError(
                    "fleet stalled with "
                    f"{len(self.queue.unacked())} unacked launch(es)"
                    + (f" — kernels not registered: {missing}"
                       if missing else ""))

    # -- migration policies ---------------------------------------------
    def _move_launch(self, src: _Worker, dst: _Worker, lid: str) -> bool:
        """checkpoint on ``src`` → restore on ``dst``: the live-state
        migration primitive every policy reuses.  Returns False when the
        source died mid-move (the launch is then requeued — replay covers
        what migration could not save)."""
        t0 = time.perf_counter()
        try:
            _, pl = self._rpc(src, "checkpoint", {"launch_id": lid})
        except WorkerLost:
            return False
        src.launches.remove(lid)
        try:
            _, rl = self._rpc(dst, "restore", {
                "launch_id": lid, "kernel": pl["kernel"],
                "blob": pl["blob"], "segments": pl["segments"],
                "outputs": pl["outputs"]})
        except WorkerLost:
            # destination died holding the only copy of the live state:
            # its evacuation requeued everything it owned, but this
            # launch was not registered there yet — requeue explicitly
            self.queue.requeue(lid)
            self.counters["evacuated"] += 1
            return False
        t2 = time.perf_counter()
        dst.launches.append(lid)
        self.queue.reassign(lid, dst.wid)
        self.counters["migrated"] += 1
        self.migrations.append({
            "launch_id": lid, "src": src.wid, "dst": dst.wid,
            "checkpoint_ms": pl["ms"], "restore_ms": rl["ms"],
            "transfer_ms": (t2 - t0) * 1e3 - pl["ms"] - rl["ms"],
            "payload_bytes": len(pl["blob"])})
        ticket = self.tickets.get(lid)
        if ticket is not None:
            ticket.worker = dst.wid
        return True

    def drain(self, worker_id: int, shutdown: bool = True) -> int:
        """Graceful drain policy: move every in-flight launch off the
        worker via checkpoint/restore (live state preserved — not a
        replay), stop dispatching to it, and by default shut it down.
        Returns the number of launches migrated."""
        w = self.workers[worker_id]
        w.draining = True
        moved = 0
        for lid in list(w.launches):
            dst = min((o for o in self._alive()
                       if o is not w and not o.draining),
                      key=lambda o: (len(o.launches), o.wid),
                      default=None)
            if dst is None:
                raise FleetError(
                    f"cannot drain worker {worker_id}: no other alive "
                    "worker to receive its launches")
            if self._move_launch(w, dst, lid):
                moved += 1
            if not w.alive:
                break
        if shutdown and w.alive:
            try:
                self._rpc(w, "shutdown", {}, timeout=5.0)
            except (WorkerLost, FleetTimeout):
                pass
            w.alive = False
            w.proc.join(timeout=5.0)
        return moved

    def rebalance(self) -> int:
        """Load-balance policy: while the most- and least-loaded alive
        workers differ by ≥ 2 launches, migrate one (checkpoint/restore,
        live state preserved).  Returns the number of moves."""
        moves = 0
        while True:
            ws = [w for w in self._alive() if not w.draining]
            if len(ws) < 2:
                return moves
            src = max(ws, key=lambda w: (len(w.launches), -w.wid))
            dst = min(ws, key=lambda w: (len(w.launches), w.wid))
            if len(src.launches) - len(dst.launches) < 2:
                return moves
            lid = src.launches[0]
            if not self._move_launch(src, dst, lid):
                return moves
            moves += 1

    # -- reporting -------------------------------------------------------
    def fleet_stats(self) -> Dict[str, object]:
        recoveries = [ms for f in self.failures
                      for ms in f["recovered"].values()]
        out: Dict[str, object] = dict(self.counters)
        out["queue"] = self.queue.stats()
        out["workers"] = [{"id": w.wid, "backend": w.backend,
                           "alive": w.alive, "draining": w.draining,
                           "inflight": len(w.launches)}
                          for w in self.workers.values()]
        out["alive_workers"] = len(self._alive())
        if self.migrations:
            out["last_migration"] = dict(self.migrations[-1])
        if recoveries:
            out["recovery_ms_max"] = max(recoveries)
            out["recovery_ms_mean"] = sum(recoveries) / len(recoveries)
        return out

    def __repr__(self) -> str:
        return (f"<FleetCoordinator workers={len(self._alive())}/"
                f"{len(self.workers)} queue={self.queue.stats()}>")
