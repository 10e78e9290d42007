"""Request gateway: admission control + weighted fair queueing.

The gateway is the serving front door in front of the demand-driven
Manager.  It does three things the batch path never needed:

**Admission control.**  An open-loop stream can offer more work than
the cluster clears; without a bound the pending queue grows without
limit and *every* request's latency diverges (queueing collapse).  The
gateway sheds (HTTP-429 analogue) when either the queued-request count
or the estimated queued work (sum of per-request service-time
estimates, learned online from observed completions) exceeds its cap —
so p99 latency for *admitted* requests stays bounded at any offered
load, which is the serving contract worth having.

**Per-tenant weighted fair queueing.**  Start-time fair queueing over
virtual time: each admitted request is stamped ``start = max(vtime,
tenant.last_finish)``, ``finish = start + cost/weight``; dispatch
always takes the tenant whose head-of-line request has the smallest
finish tag and advances ``vtime`` to its start tag.  A bursting tenant
only queues behind its own backlog — it cannot starve a light tenant —
and under sustained overload throughput splits proportionally to the
configured weights.

**Deadline inheritance.**  A request's absolute deadline is stamped
onto every stage instance of its pipeline replica
(``ConcreteWorkflow.instantiate(chunk, deadline=...)``), which is what
the Manager's EDF pending tier and the per-node scheduler's EDF lane
order by.

The gateway keeps at most ``max_inflight`` requests inside the Manager
at once: WFQ can only arbitrate among requests it has *not yet*
released, so the window is what converts a fair queue into fair
throughput (an unbounded release would collapse WFQ to FIFO-at-the-
Manager).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Optional

from .request import DONE, FAILED, QUEUED, RUNNING, SHED, ServeRequest
from ..telemetry.metrics import Histogram
from ..telemetry.tracing import use_context

__all__ = ["GatewayConfig", "GatewayStats", "RequestGateway"]


@dataclass
class GatewayConfig:
    #: queued-request cap: submissions beyond it are shed.
    max_queue: int = 256
    #: estimated-work cap in seconds of queued service time (None = no
    #: work-based admission; the queue-depth cap still applies).
    max_est_work_s: Optional[float] = None
    #: requests concurrently released into the Manager.  Small enough
    #: that WFQ still arbitrates, large enough to keep workers busy.
    max_inflight: int = 8
    #: deadline applied when the caller does not pass one (ms).
    default_deadline_ms: Optional[float] = None
    #: initial per-request service-time estimate (seconds), refined by
    #: an EMA over observed completions.
    initial_cost_s: float = 0.05
    #: EMA smoothing for the service-time estimate.
    cost_ema: float = 0.2
    #: feasibility-aware overload shedding: refuse exactly the
    #: deadline-carrying requests whose deadline fails an EDF
    #: schedulability test against the *measured* service-time tail
    #: (histogram p99, not the EMA mean — overload is a tail
    #: phenomenon): with the earlier-or-equal-deadline backlog plus
    #: in-flight requests ahead of it across ``max_inflight`` release
    #: slots, can this request still finish by its deadline?  Requests
    #: without a deadline are never feasibility-shed.  Mirrored as
    #: ``SimConfig.shed_feasibility``.
    shed_feasibility: bool = False
    #: service-time percentile the feasibility test budgets per request.
    feasibility_pct: float = 0.99
    #: observed completions before the histogram percentile is trusted
    #: (the EMA estimate stands in below this).
    feasibility_min_samples: int = 8


@dataclass
class GatewayStats:
    submitted: int = 0
    admitted: int = 0
    shed: int = 0
    #: subset of ``shed`` refused by the EDF feasibility test (their
    #: deadline was unmeetable against measured queued work).
    shed_infeasible: int = 0
    completed: int = 0
    #: requests that terminated in FAILED (pipeline quarantined).
    failed: int = 0
    #: per-tenant completed counts (fairness accounting).
    tenant_completed: dict[str, int] = field(default_factory=dict)
    tenant_shed: dict[str, int] = field(default_factory=dict)
    tenant_failed: dict[str, int] = field(default_factory=dict)
    #: arrival-to-done latencies of completed requests (seconds).
    latencies: list[float] = field(default_factory=list)
    deadline_misses: int = 0

    def bind(self, registry, prefix: str = "gateway") -> None:
        """Re-home the scalar counters as int-like cells in a shared
        :class:`~repro.telemetry.metrics.MetricsRegistry` (the per-
        tenant dicts and the latency list stay plain — they are not
        monotone scalars).  Existing values seed the cells."""
        for name in (
            "submitted",
            "admitted",
            "shed",
            "shed_infeasible",
            "completed",
            "failed",
            "deadline_misses",
        ):
            cell = registry.counter(f"{prefix}.{name}")
            cell.inc(int(getattr(self, name)))
            setattr(self, name, cell)


class _TenantState:
    __slots__ = ("weight", "queue", "last_finish")

    def __init__(self, weight: float):
        self.weight = max(float(weight), 1e-9)
        self.queue: deque[tuple[float, float, ServeRequest]] = deque()
        self.last_finish = 0.0  # virtual finish tag of the newest entry


class RequestGateway:
    """Front door over a streaming Manager.

    ``manager`` must expose ``cw`` (a live ConcreteWorkflow),
    ``submit_instances``, ``open_stream``/``close_stream`` and a
    ``completion_hook`` slot — i.e. :class:`repro.core.manager.Manager`
    in streaming mode.
    """

    def __init__(
        self,
        manager: Any,
        config: Optional[GatewayConfig] = None,
        tenants: Optional[Mapping[str, float]] = None,
        clock: Callable[[], float] = time.monotonic,
        *,
        registry: Any = None,
        tracer: Any = None,
        recorder: Any = None,
    ):
        self.manager = manager
        self.cfg = config or GatewayConfig()
        self.clock = clock
        self.tracer = tracer          # telemetry.Tracer (optional)
        self.recorder = recorder      # telemetry.FlightRecorder (optional)
        self.stats = GatewayStats()
        if registry is not None:
            self.stats.bind(registry)
        self._lock = threading.RLock()
        self._idle = threading.Event()
        self._idle.set()
        self._tenants: dict[str, _TenantState] = {}
        for name, weight in (tenants or {}).items():
            self._tenants[name] = _TenantState(weight)
        self._vtime = 0.0
        self._queued = 0
        self._inflight = 0
        self._est_queued_work = 0.0
        self._service_est = self.cfg.initial_cost_s
        # Measured service-time distribution (dispatch-to-done): the
        # feasibility test budgets its tail percentile per request.
        self._service_hist = (
            registry.histogram("gateway.service_s")
            if registry is not None
            else Histogram("gateway.service_s")
        )
        self._next_id = 0
        #: terminal stage uid -> its request (completion fan-in).
        self._terminal: dict[int, ServeRequest] = {}
        #: req_id -> request (status lookups, e.g. over the bus).
        self._requests: dict[int, ServeRequest] = {}
        manager.completion_hook = self._on_stage_done
        if hasattr(manager, "failure_hook"):
            manager.failure_hook = self._on_stage_failed
        manager.open_stream()

    # -- ingestion ---------------------------------------------------------

    def add_tenant(self, name: str, weight: float = 1.0) -> None:
        with self._lock:
            self._tenants.setdefault(name, _TenantState(weight))

    def submit(
        self,
        tenant: str,
        chunk: Any,
        deadline_ms: Optional[float] = None,
        cost_s: Optional[float] = None,
    ) -> ServeRequest:
        """Admit-or-shed one request.  Returns the request either way;
        check ``accepted`` — a shed request never runs (429)."""
        now = self.clock()
        with self._lock:
            self.stats.submitted += 1
            ts = self._tenants.get(tenant)
            if ts is None:
                ts = self._tenants[tenant] = _TenantState(1.0)
            cost = float(cost_s) if cost_s is not None else self._service_est
            if deadline_ms is None:
                deadline_ms = self.cfg.default_deadline_ms
            deadline = now + deadline_ms / 1000.0 if deadline_ms else None
            req = ServeRequest(
                req_id=self._next_id,
                tenant=tenant,
                chunk=chunk,
                arrival=now,
                cost=cost,
                deadline=deadline,
            )
            self._next_id += 1
            self._requests[req.req_id] = req
            if self._queued >= self.cfg.max_queue or (
                self.cfg.max_est_work_s is not None
                and self._est_queued_work + cost > self.cfg.max_est_work_s
            ):
                req.state = SHED
                self.stats.shed += 1
                self.stats.tenant_shed[tenant] = (
                    self.stats.tenant_shed.get(tenant, 0) + 1
                )
                return req
            if (
                self.cfg.shed_feasibility
                and deadline is not None
                and not self._feasible_locked(now, deadline, req)
            ):
                req.state = SHED
                self.stats.shed += 1
                self.stats.shed_infeasible += 1
                self.stats.tenant_shed[tenant] = (
                    self.stats.tenant_shed.get(tenant, 0) + 1
                )
                return req
            self.stats.admitted += 1
            if self.tracer is not None:
                # Root the request's trace at admission; the sampling
                # decision made here travels with every downstream hop.
                req.trace = self.tracer.start_trace()
                if req.trace.sampled:
                    self.tracer.record_span(
                        "gateway:admit",
                        ctx=self.tracer.child(req.trace),
                        parent=req.trace.span_id,
                        cat="request",
                        tid="gateway",
                        args={"req_id": req.req_id, "tenant": tenant},
                    )
            self._idle.clear()
            # SFQ tags: charge by estimated cost over tenant weight.
            start = max(self._vtime, ts.last_finish)
            finish = start + cost / ts.weight
            ts.last_finish = finish
            ts.queue.append((finish, start, req))
            self._queued += 1
            self._est_queued_work += cost
            self._dispatch_locked()
            return req

    # -- feasibility-aware overload shedding -------------------------------

    def _feasible_locked(
        self, now: float, deadline: float, req: ServeRequest
    ) -> bool:
        """EDF schedulability test for one candidate request: budget the
        measured per-request service tail for every queued request with
        an earlier-or-equal deadline (those run first under EDF), every
        in-flight request (already occupying release slots), and the
        candidate itself, spread across ``max_inflight`` parallel
        slots.  If even that optimistic pipeline cannot land the
        candidate by its deadline, admitting it only converts a certain
        miss into wasted cluster work — shed it instead."""
        if self._service_hist.count >= self.cfg.feasibility_min_samples:
            service = self._service_hist.percentile(self.cfg.feasibility_pct)
        else:
            service = self._service_est
        if not service or service <= 0.0:
            return True
        ahead = self._inflight
        for ts in self._tenants.values():
            for _, _, queued in ts.queue:
                if queued.deadline is None or queued.deadline <= deadline:
                    ahead += 1
        slots = max(self.cfg.max_inflight, 1)
        est_done = now + service * (ahead + 1) / slots
        if est_done <= deadline:
            return True
        if self.recorder is not None:
            self.recorder.note(
                "feasibility_shed",
                req_id=req.req_id,
                tenant=req.tenant,
                deadline_in_s=round(deadline - now, 4),
                service_pct_s=round(service, 4),
                backlog=ahead,
                est_done_in_s=round(est_done - now, 4),
            )
        return False

    # -- WFQ dispatch ------------------------------------------------------

    def _dispatch_locked(self) -> None:
        while self._inflight < self.cfg.max_inflight:
            best: Optional[_TenantState] = None
            for ts in self._tenants.values():
                if ts.queue and (
                    best is None or ts.queue[0][0] < best.queue[0][0]
                ):
                    best = ts
            if best is None:
                return
            finish, start, req = best.queue.popleft()
            self._vtime = max(self._vtime, start)
            self._queued -= 1
            self._est_queued_work = max(
                0.0, self._est_queued_work - req.cost
            )
            self._inflight += 1
            req.state = RUNNING
            req.t_dispatch = self.clock()
            sis = self.manager.cw.instantiate(req.chunk, deadline=req.deadline)
            uids = {si.uid for si in sis}
            terminals = [
                si for si in sis if not (si.dependents & uids)
            ] or sis[-1:]
            req.stage_uids = tuple(sorted(uids))
            req.remaining = len(terminals)
            for si in terminals:
                self._terminal[si.uid] = req
            if req.trace is not None and req.trace.sampled:
                # The Manager captures this context per queued stage and
                # re-installs it around each lease — the whole pipeline
                # replica traces back to this request.
                with use_context(req.trace):
                    self.manager.submit_instances(sis)
            else:
                self.manager.submit_instances(sis)

    # -- completion --------------------------------------------------------

    def _on_stage_done(self, uid: int) -> None:
        with self._lock:
            req = self._terminal.pop(uid, None)
            if req is None:
                return
            req.remaining -= 1
            if req.remaining > 0:
                return
            req.state = DONE
            req.t_done = self.clock()
            self._inflight -= 1
            self.stats.completed += 1
            self.stats.tenant_completed[req.tenant] = (
                self.stats.tenant_completed.get(req.tenant, 0) + 1
            )
            lat = req.latency
            if lat is not None:
                self.stats.latencies.append(lat)
            missed = req.deadline is not None and req.t_done > req.deadline
            if missed:
                self.stats.deadline_misses += 1
            if self.tracer is not None and req.trace is not None and lat is not None:
                # The root span: arrival-to-done, everything else in the
                # trace (leases, ops, pulls, pushes) nests under it.
                self.tracer.record_span(
                    "request",
                    ctx=req.trace,
                    cat="request",
                    ts=time.time() - lat,
                    dur=lat,
                    tid="gateway",
                    args={
                        "req_id": req.req_id,
                        "tenant": req.tenant,
                        "deadline_miss": missed,
                    },
                )
            if missed and self.recorder is not None:
                self.recorder.dump(
                    "deadline_miss",
                    detail={
                        "req_id": req.req_id,
                        "tenant": req.tenant,
                        "latency": lat,
                        "tardiness": req.tardiness,
                    },
                )
            # Online service-time estimate: dispatch-to-done, which is
            # what one admitted request actually costs the cluster
            # (queueing excluded — admission should not double-count
            # its own backlog).
            if req.t_dispatch is not None:
                obs = max(req.t_done - req.t_dispatch, 1e-6)
                a = self.cfg.cost_ema
                self._service_est = (1 - a) * self._service_est + a * obs
                self._service_hist.observe(obs)
            self._dispatch_locked()
            if self._queued == 0 and self._inflight == 0:
                self._idle.set()
        req._done_event.set()

    def _on_stage_failed(self, uid: int, error: str) -> None:
        """Manager ``failure_hook``: a stage of ours was quarantined.

        The Manager cascades quarantine over dependents, so the
        request's terminal stage(s) always land here.  The first
        terminal failure decides the request: it goes FAILED, its
        remaining terminal fan-in entries are cleared, and the tenant
        gets a verdict (``error``) instead of a hung request.
        """
        with self._lock:
            req = self._terminal.pop(uid, None)
            if req is None or req.state in (DONE, FAILED):
                return
            # Drop the request's other terminal entries — the verdict
            # is already decided and later hooks must not double-count.
            for other in [u for u, r in self._terminal.items() if r is req]:
                del self._terminal[other]
            req.remaining = 0
            req.state = FAILED
            req.error = error
            req.t_done = self.clock()
            self._inflight -= 1
            self.stats.failed += 1
            self.stats.tenant_failed[req.tenant] = (
                self.stats.tenant_failed.get(req.tenant, 0) + 1
            )
            if self.tracer is not None and req.trace is not None:
                lat = req.latency or 0.0
                self.tracer.record_span(
                    "request",
                    ctx=req.trace,
                    cat="request",
                    ts=time.time() - lat,
                    dur=lat,
                    tid="gateway",
                    args={
                        "req_id": req.req_id,
                        "tenant": req.tenant,
                        "failed": True,
                        "error": error,
                    },
                )
            self._dispatch_locked()
            if self._queued == 0 and self._inflight == 0:
                self._idle.set()
        req._done_event.set()

    # -- lifecycle ---------------------------------------------------------

    def drain(self, timeout: float = 60.0) -> bool:
        """Wait until everything admitted so far has completed."""
        return self._idle.wait(timeout)

    def close(self, timeout: float = 60.0) -> bool:
        """Drain, then close the Manager's stream."""
        ok = self.drain(timeout)
        return self.manager.close_stream(timeout) and ok

    # -- introspection -----------------------------------------------------

    def request(self, req_id: int) -> Optional[ServeRequest]:
        with self._lock:
            return self._requests.get(req_id)

    def queue_depth(self) -> int:
        with self._lock:
            return self._queued

    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def service_estimate(self) -> float:
        with self._lock:
            return self._service_est
