"""Multi-tenant serving tier on the driver API (paper §4.3 under load).

:class:`ServingFrontEnd` puts the :class:`~repro_torch.core.runtime.
HetSession` scheduler under serving load: tenants register with a
fair-share **weight**, a **priority** tier, and an in-flight **quota**;
each tenant gets a *sticky* stream (all of a tenant's launches ride its
own in-order queue, so per-tenant dataflow keeps CUDA stream semantics
while the session's weighted-fair-share scheduler arbitrates *between*
tenants at segment granularity).

Admission control is quota-based load shedding: a ``submit`` that would
exceed the tenant's in-flight quota (or the coordinator's global cap) is
**rejected with an error** (:class:`QuotaExceeded`) before anything is
enqueued — in-flight work is never cancelled or lost to shedding, the
overload is pushed back to the caller, who retries or sheds upstream.

On a CUDA session the host only *enqueues* a launch's segment kernels, so
a request is complete when the device has run them: a ticket stays in
flight (and counts against its quota) until the event its launch recorded
after its last segment (:attr:`LaunchRecord.done_event`) has completed,
and its latency ends at that event's time on the device, read against an
epoch event the front end records when it starts.  On the CPU the launch
is done when the host finishes it.

The front end can alternatively sit on a **fleet**
(:class:`~repro_torch.core.fleet.FleetCoordinator`) instead of an
in-process session: pass a coordinator as the first constructor argument
and tenants keep their quotas, admission control, and latency accounting,
but launches dispatch to worker *processes* (kernels named by string, args
as host arrays) and survive worker deaths via the fleet's retry queue.  A
fleet launch is complete when its results are back on the host.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import torch

from .runtime import Function, HetSession, LaunchRecord, Stream


class QuotaExceeded(RuntimeError):
    """Admission rejected: the tenant (or the coordinator) is at its
    in-flight quota.  Nothing was enqueued — retry after completions
    drain, or shed the request upstream."""

    def __init__(self, message: str, tenant: str):
        super().__init__(message)
        self.tenant = tenant


class ServeTicket:
    """One admitted request: the launch future plus serving metadata
    (tenant, submit/completion timestamps, measured latency)."""

    __slots__ = ("tenant", "record", "submitted_at", "completed_at")

    def __init__(self, tenant: str, record: LaunchRecord):
        self.tenant = tenant
        self.record = record
        self.submitted_at = time.perf_counter()
        self.completed_at: Optional[float] = None

    def done(self) -> bool:
        return self.completed_at is not None

    @property
    def latency_ms(self) -> Optional[float]:
        if self.completed_at is None:
            return None
        return (self.completed_at - self.submitted_at) * 1e3

    def __repr__(self) -> str:
        state = f"{self.latency_ms:.2f}ms" if self.done() else "in-flight"
        return f"<ServeTicket {self.tenant} #{self.record.seq} {state}>"


@dataclass
class TenantState:
    """Per-tenant serving state: the sticky stream (``None`` in fleet
    mode, where dispatch is the fleet's), the quota, and the counters
    the front end reports."""
    name: str
    stream: Optional[Stream]
    max_inflight: int
    weight: float = 1.0
    priority: int = 0
    inflight: List[ServeTicket] = field(default_factory=list)
    admitted: int = 0
    rejected: int = 0
    completed: int = 0
    latencies_ms: List[float] = field(default_factory=list)

    def stats(self) -> Dict[str, object]:
        out = {"tenant": self.name,
               "stream": self.stream.sid if self.stream else None,
               "weight": self.weight, "priority": self.priority,
               "max_inflight": self.max_inflight,
               "inflight": len(self.inflight),
               "admitted": self.admitted, "rejected": self.rejected,
               "completed": self.completed}
        if self.latencies_ms:
            out["p50_ms"] = round(_pct(self.latencies_ms, 50), 3)
            out["p99_ms"] = round(_pct(self.latencies_ms, 99), 3)
        return out


def _pct(samples: List[float], q: float) -> float:
    ordered = sorted(samples)
    idx = min(len(ordered) - 1, int(round((q / 100.0)
                                          * (len(ordered) - 1))))
    return ordered[idx]


class ServingFrontEnd:
    """Coordinator for multi-tenant serving on one session.

    * ``tenant(name, weight=, priority=, max_inflight=)`` registers a
      tenant (idempotent) and pins its sticky stream.
    * ``submit(name, fn, grid, block, args)`` applies admission control,
      then enqueues on the tenant's stream and returns a
      :class:`ServeTicket`.
    * ``pump(decisions)`` drives the scheduler and reaps completions
      (recording per-request latency); ``drain()`` runs everything dry.

    ``slo_ms`` is advisory: completions above it are counted in
    ``slo_violations`` — admission itself sheds on *quotas*, so an
    overload rejects new work instead of silently blowing the deadline of
    admitted work.
    """

    def __init__(self, session, max_inflight: int = 256,
                 default_quota: int = 32, slo_ms: Optional[float] = None,
                 quantum: int = 1):
        # ``session`` is either an in-process HetSession or a
        # FleetCoordinator (duck-typed on its fleet_stats surface)
        self.fleet = session if hasattr(session, "fleet_stats") else None
        self.session: Optional[HetSession] = \
            None if self.fleet is not None else session
        self.max_inflight = int(max_inflight)
        self.default_quota = int(default_quota)
        self.slo_ms = slo_ms
        self.quantum = max(1, int(quantum))
        self.tenants: Dict[str, TenantState] = {}
        self.slo_violations = 0
        self.total_inflight = 0
        # on the card: the device-side epoch completion times are read
        # against, and the host clock at that event
        self._device = None if self.session is None \
            or self.session.device.type != "cuda" else self.session.device
        if self._device is not None:
            self._epoch = torch.cuda.Event(enable_timing=True)
            self._epoch.record(torch.cuda.current_stream(self._device))
            self._epoch.synchronize()
            self._epoch_host = time.perf_counter()

    # -- tenant registry (sticky stream assignment) ------------------------
    def tenant(self, name: str, weight: float = 1.0, priority: int = 0,
               max_inflight: Optional[int] = None) -> TenantState:
        """Register ``name`` (or return its existing state).  The tenant's
        stream is created once and stays sticky — scheduling policy
        changes require a new tenant, matching driver streams whose
        priority is fixed at creation."""
        t = self.tenants.get(name)
        if t is None:
            quota = self.default_quota if max_inflight is None \
                else int(max_inflight)
            if self.fleet is not None:
                # fleet mode: no sticky stream — the fleet's dispatcher
                # owns placement; weight/priority kept for reporting
                t = TenantState(name, None, quota,
                                weight=weight, priority=priority)
            else:
                st = self.session.stream(weight=weight, priority=priority,
                                         quantum=self.quantum)
                t = TenantState(name, st, quota,
                                weight=st.weight, priority=st.priority)
            self.tenants[name] = t
        return t

    def retire_tenant(self, name: str) -> None:
        """Drop a tenant and destroy its stream (refuses while the tenant
        still has in-flight work, like :meth:`Stream.destroy`)."""
        t = self.tenants.get(name)
        if t is None:
            return
        if t.inflight:
            raise RuntimeError(
                f"tenant {name!r} has {len(t.inflight)} in-flight "
                "request(s) — drain before retiring")
        if t.stream is not None:
            t.stream.destroy()
        del self.tenants[name]

    # -- admission + dispatch ----------------------------------------------
    def submit(self, name: str, fn: Union[Function, str], grid: int,
               block: int, args: Dict[str, object]) -> ServeTicket:
        """Admit and enqueue one request for tenant ``name`` (which must
        be registered).  Raises :class:`QuotaExceeded` — *before* anything
        is enqueued — when the tenant or the coordinator is at its
        in-flight cap.  In fleet mode ``fn`` may be the kernel name (the
        fleet registry resolves it in each worker) and ``args`` are host
        values (scalars / numpy arrays), not device buffers."""
        t = self.tenants.get(name)
        if t is None:
            raise KeyError(f"unknown tenant {name!r} — register with "
                           "front.tenant(name, ...) first")
        self._reap(t)
        if len(t.inflight) >= t.max_inflight:
            t.rejected += 1
            raise QuotaExceeded(
                f"tenant {name!r} is at its in-flight quota "
                f"({t.max_inflight}) — shed or retry after completions",
                tenant=name)
        if self.total_inflight >= self.max_inflight:
            t.rejected += 1
            raise QuotaExceeded(
                f"serving front end is at its global in-flight cap "
                f"({self.max_inflight}) — shed or retry after completions",
                tenant=name)
        if self.fleet is not None:
            kernel = fn if isinstance(fn, str) else fn.name
            rec = self.fleet.submit(kernel, grid, block, args)
        else:
            rec = fn.launch_async(grid, block, args, stream=t.stream)
        ticket = ServeTicket(name, rec)
        t.inflight.append(ticket)
        t.admitted += 1
        self.total_inflight += 1
        return ticket

    # -- driving the scheduler ---------------------------------------------
    def pump(self, decisions: int = 64) -> bool:
        """Make up to ``decisions`` scheduling decisions and reap
        completions.  Returns True iff any progress was made.  In fleet
        mode a "decision" is one fleet pump round (dispatch sweep + one
        segment slice per busy worker)."""
        if self.fleet is not None:
            progressed = self.fleet.pump()
        else:
            progressed = self.session.step(decisions)
        for t in self.tenants.values():
            self._reap(t)
        # launches the host has finished are still running on the device
        return progressed or any(tk.record.finished
                                 for t in self.tenants.values()
                                 for tk in t.inflight)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Drive everything to completion (False if paused work remains),
        then reap.  In fleet mode this waits until every accepted launch
        is acked — surviving worker deaths along the way; on the card it
        also waits for the device."""
        if self.fleet is not None:
            self.fleet.wait_all(timeout=timeout)
            ok = True
        else:
            ok = self.session.synchronize()
            if self._device is not None:
                torch.cuda.synchronize(self._device)
        for t in self.tenants.values():
            self._reap(t)
        return ok

    def _completed_at(self, rec) -> Optional[float]:
        """When ``rec`` completed on the host clock, or ``None`` while it
        is still in flight (on the card: its device event has not
        completed)."""
        if rec.cancelled:
            return time.perf_counter()
        if not rec.finished:
            return None
        event = getattr(rec, "done_event", None)
        if event is None:
            return time.perf_counter()
        if not event.query():
            return None
        return self._epoch_host + self._epoch.elapsed_time(event) / 1e3

    def _reap(self, t: TenantState) -> None:
        still: List[ServeTicket] = []
        for ticket in t.inflight:
            done_at = self._completed_at(ticket.record)
            if done_at is None:
                still.append(ticket)
                continue
            # the device may finish before the host got to submit's
            # clock read (an empty launch): never a negative latency
            ticket.completed_at = max(done_at, ticket.submitted_at)
            t.completed += 1
            self.total_inflight -= 1
            lat = ticket.latency_ms
            t.latencies_ms.append(lat)
            if self.slo_ms is not None and lat > self.slo_ms:
                self.slo_violations += 1
        t.inflight = still

    # -- reporting ---------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        per = [t.stats() for t in self.tenants.values()]
        lats = [x for t in self.tenants.values() for x in t.latencies_ms]
        agg: Dict[str, object] = {
            "tenants": per,
            "admitted": sum(t.admitted for t in self.tenants.values()),
            "rejected": sum(t.rejected for t in self.tenants.values()),
            "completed": sum(t.completed for t in self.tenants.values()),
            "inflight": self.total_inflight,
            "slo_ms": self.slo_ms,
            "slo_violations": self.slo_violations,
        }
        if lats:
            agg["p50_ms"] = round(_pct(lats, 50), 3)
            agg["p99_ms"] = round(_pct(lats, 99), 3)
        if self.fleet is not None:
            agg["fleet"] = self.fleet.fleet_stats()
        return agg

    def __repr__(self) -> str:
        return (f"<ServingFrontEnd tenants={len(self.tenants)} "
                f"inflight={self.total_inflight}/{self.max_inflight}>")
