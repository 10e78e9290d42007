"""Demand-driven Manager (paper §III-B, Fig 4) with fault tolerance.

The Manager has the overall view of the runtime: it instantiates the
abstract workflow, tracks inter-stage dependencies, and leases stage
instances to Workers demand-driven — each Worker holds at most
``window`` leases and requests more as leases complete (the paper's
*Window size*, §V-F).

Beyond the paper, the Manager provides the fault-tolerance required for
thousand-node deployments:

* **heartbeats** — a Worker that stops reporting is declared dead and
  its outstanding leases return to the queue (chunk processing is
  idempotent, so re-execution is safe);
* **straggler backup tasks** — at the tail of a run, outstanding leases
  are duplicated onto idle Workers and the first completion wins;
* **elastic membership** — Workers may register/deregister mid-run;
  the lease queue simply redistributes.

The Manager is transport-agnostic: in a single process Worker objects
are registered directly; on a cluster the same protocol runs over a
:mod:`repro.transport` MessageBus — a ``ManagerEndpoint`` serves the
lease/complete/heartbeat/region-pull RPCs and each remote worker
appears here as a ``WorkerProxy``.  With ``ManagerConfig.journal_path``
set, placement and lease state are write-ahead journaled so a restarted
Manager rehydrates instead of restarting the workflow.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from .workflow import ConcreteWorkflow, StageInstance
from .worker import WorkerRuntime
from .release import result_of
from ..telemetry.metrics import MetricsRegistry
from ..telemetry.tracing import SpanContext, current_context, use_context
from ..telemetry.lanes import mark_pending, record_lease_wait
from ..staging import (
    DirectoryService,
    PlacementDirectory,
    PlacementPolicy,
    op_key,
    select_lease,
)
from ..staging.tiers import RegionKey, sizeof

__all__ = ["Manager", "ManagerConfig"]


@dataclass
class ManagerConfig:
    window: int = 4                  # leases in flight per worker
    heartbeat_timeout: float = 60.0  # seconds without progress => dead
    backup_tasks: bool = True       # duplicate tail leases
    poll_interval: float = 0.01
    # Cluster-level locality-aware lease placement (repro.staging): lease
    # a dependent stage instance to the worker already holding the
    # largest fraction of its input bytes, demand-driven otherwise.
    locality_aware: bool = False
    placement: PlacementPolicy = field(default_factory=PlacementPolicy)
    directory: Optional[PlacementDirectory] = None  # default: fresh one
    # Failover-surviving placement state: when set, the directory is
    # wrapped in a journaled DirectoryService at this path.  A Manager
    # constructed over a path that already holds a journal *rehydrates*:
    # holder maps, completed stages, and the pending-lease queue are
    # replayed so a restarted coordinator resumes instead of restarting.
    journal_path: Optional[str] = None
    snapshot_every: int = 512        # journal appends between checkpoints
    # Byte-keyed compaction: when set, checkpoints trigger on journal
    # *bytes* since the last snapshot (replay time is bounded by bytes
    # to parse, not append count) and snapshot_every is ignored.
    snapshot_bytes: Optional[int] = None
    # Size-tiered (incremental) checkpoints: each trigger writes only
    # the state that changed since the last checkpoint as a small delta
    # run; deltas fold into a fresh full snapshot once their byte tier
    # outgrows the base.  Keeps snapshot pauses bounded by churn, not
    # directory size — load-bearing once a serving stream keeps the
    # directory hot indefinitely.
    incremental_snapshots: bool = False
    # Predictive push of sink outputs (coordinator-bypass data plane):
    # at stage completion the placement rule predicts the next holder
    # of each sink output and the completing worker pushes the bytes
    # there before the dependent lease starts, hiding the first-touch
    # transfer.  Off by default: pull stays the baseline the benchmarks
    # compare against.
    predictive_push: bool = False
    # Data-plane flow control: cap on push bytes in flight toward any
    # single worker's ingress.  A push directive that would overflow
    # the target's cap is *deferred* (per-target queue) instead of
    # sent; the target's ``region_staged`` confirmation is the credit
    # grant that drains the queue.  With nothing in flight one push
    # always goes (a region larger than the cap degrades to
    # pull-on-lease, never a permanent stall); a dead target voids its
    # whole ledger so the cap cannot deadlock on a corpse.  None = the
    # pre-flow-control behavior (push storms queue unbounded bytes on
    # the target's ingress).  The simulator mirrors this knob as
    # ``SimConfig.push_inflight_cap_bytes``.
    push_inflight_cap_bytes: Optional[int] = None
    # Control-plane RPC timeout (seconds) the bus endpoints use for
    # manager->worker calls; the register reply hands it to workers for
    # their worker->manager calls.  Tight by design: a hung peer must
    # surface as BusTimeoutError fast, not stall the caller for the bus
    # default 30s.
    rpc_timeout: float = 10.0
    # Poison-chunk quarantine: a stage instance that fails on (or takes
    # down) this many *distinct* workers is quarantined — it and its
    # dependents become terminal failed state (surfaced through
    # ``failure_hook`` / the serving gateway) instead of being re-leased
    # forever and wedging the run.
    quarantine_after: int = 3
    # Gray-failure detection (alive-but-slow workers, distinct from
    # heartbeat death): a HealthScorer tracks each worker's EMA of
    # observed/expected stage latency (+ heartbeat jitter) and scales
    # its lease window down (capacity-weighted soft anti-affinity); a
    # worker whose score crosses ``probation_ratio`` — or that eats
    # ``probation_after_hedges`` hedges — goes on *probation*: its
    # queued leases re-queue to healthy workers and it keeps a single
    # probe lease until the score recovers, then rejoins automatically.
    # The simulator mirrors this as ``SimConfig.health_scoring``.
    health_scoring: bool = False
    health_alpha: float = 0.35            # EMA weight per ratio sample
    probation_ratio: float = 3.0          # score to enter probation
    probation_recover_ratio: float = 2.0  # score to leave probation
    probation_min_samples: int = 3        # ratio samples before benching
    probation_after_hedges: int = 2       # hedges eaten => probation
    # Percentile hedging (generalized backup tasks): a running lease
    # whose age exceeds its stage's measured latency p99 × this slack
    # is duplicated onto the healthiest worker with window slack —
    # first completion wins through the existing twin-cancel path.
    # Unlike ``backup_tasks`` (tail-of-run only), hedges fire mid-run,
    # latency-triggered against the histogram, and are health-routed.
    # None = off.  Mirrored as ``SimConfig.hedge_slack``.
    hedge_slack: Optional[float] = None
    hedge_min_samples: int = 8            # histogram count before hedging


class HealthScorer:
    """Gray-failure detector: per-worker health from latency + jitter.

    Score = EMA of the observed/expected stage-latency ratio, inflated
    by heartbeat jitter (EMA of inter-heartbeat gap over the timeout).
    1.0 = nominal; a persistently 8x-slow worker converges toward 8.
    ``weight`` maps the score to a dispatch capacity multiplier in
    (0, 1].  All calls run under the Manager lock — no lock of its own.
    """

    def __init__(self, alpha: float = 0.35) -> None:
        self.alpha = float(alpha)
        self._ratio: dict[int, float] = {}
        self._gap: dict[int, float] = {}
        self._n: dict[int, int] = {}

    def observe(self, wid: int, ratio: float) -> None:
        prev = self._ratio.get(wid, 1.0)
        self._ratio[wid] = (1.0 - self.alpha) * prev + self.alpha * ratio
        self._n[wid] = self._n.get(wid, 0) + 1

    def observe_gap(self, wid: int, gap: float) -> None:
        prev = self._gap.get(wid, 0.0)
        self._gap[wid] = (1.0 - self.alpha) * prev + self.alpha * gap

    def samples(self, wid: int) -> int:
        return self._n.get(wid, 0)

    def score(self, wid: int, heartbeat_timeout: float = 60.0) -> float:
        jitter = self._gap.get(wid, 0.0) / max(heartbeat_timeout, 1e-9)
        return self._ratio.get(wid, 1.0) * (1.0 + jitter)

    def weight(self, wid: int, heartbeat_timeout: float = 60.0) -> float:
        return min(1.0, 1.0 / max(self.score(wid, heartbeat_timeout), 1e-9))

    def reset(self, wid: int) -> None:
        """Fresh start after probation exit: a recovered worker earns
        full weight back immediately (re-entry is cheap if it relapses)."""
        self._ratio[wid] = 1.0
        self._gap[wid] = 0.0


@dataclass
class _WorkerState:
    runtime: WorkerRuntime
    leases: set[int] = field(default_factory=set)
    last_heartbeat: float = field(default_factory=time.monotonic)
    dead: bool = False
    # Gray-failure probation: the worker is alive and registered but
    # receives only a single probe lease until its health recovers.
    probation: bool = False
    probe_completions: int = 0   # completions observed while probing
    hedged_against: int = 0      # hedges issued against this worker


@dataclass
class _PushInFlight:
    """One in-flight push toward a target worker: dedup entry for the
    predictor, reserved bytes for the ingress cap, and the inbound
    hint ``forward_inputs`` hands the target's staging agent."""

    t: float              # when the push directive went out
    nbytes: int           # bytes reserved against the target's cap
    leased: bool = False  # a dependent lease already consumed the hint


class Manager:
    def __init__(
        self,
        workflow: ConcreteWorkflow,
        cfg: ManagerConfig | None = None,
        *,
        registry: MetricsRegistry | None = None,
        tracer=None,
        recorder=None,
    ):
        self.cw = workflow
        self.cfg = cfg or ManagerConfig()
        # Coordinator-side observability: every counter below is an
        # int-like cell in this registry (``manager.*``), so one
        # ``metrics.snapshot()`` covers what used to be scattered
        # attributes; ``stats()`` stays the thin compatibility view.
        self.metrics = registry or MetricsRegistry("manager")
        self.tracer = tracer          # telemetry.Tracer (optional)
        self.recorder = recorder      # telemetry.FlightRecorder (optional)
        c = lambda name: self.metrics.counter(f"manager.{name}")  # noqa: E731
        self._lock = threading.RLock()
        self._workers: dict[int, _WorkerState] = {}
        self._pending: deque[StageInstance] = deque()
        self._stage_done: set[int] = set()
        self._stage_outputs: dict[int, dict[str, Any]] = {}
        self._dup_issued: set[int] = set()
        # Trace context per queued stage instance: captured when the
        # instance enters the pending queue (the submitting thread —
        # gateway or stage-complete handler — carries the request's
        # context) and re-installed around the lease so the trace
        # follows the stage to whichever worker wins it.
        self._trace_ctx: dict[int, SpanContext] = {}
        self.recovered_leases = c("recovered_leases")
        self.duplicated_leases = c("duplicated_leases")
        # Per-lease attempt budget: primary uid -> distinct workers that
        # failed (or died) while holding it.  Crossing
        # ``cfg.quarantine_after`` quarantines the stage and its
        # dependents: terminal failed state, not an eternal re-lease.
        # Deliberately NOT journaled: after a failover the chunk re-runs,
        # re-fails, and re-quarantines — slower, never wrong.
        self._attempts: dict[int, set[int]] = {}
        self._quarantined: dict[int, str] = {}
        self.stage_failures = c("stage_failures")  # explicit worker failure reports
        self.lease_retries = c("lease_retries")    # failed leases re-queued elsewhere
        # Gray-failure resilience: per-worker health (feeds capacity-
        # weighted dispatch + probation) and per-lease dispatch times
        # (feed the stage-latency histograms and percentile hedging).
        self.health = HealthScorer(alpha=self.cfg.health_alpha)
        self._lease_t: dict[tuple[int, int], float] = {}  # (wid, uid) -> t
        self.probations = c("probations")            # workers benched as gray
        self.probation_exits = c("probation_exits")  # recovered + rejoined
        self.hedged_leases = c("hedged_leases")      # p99-triggered hedge twins
        # Called outside the lock, once per newly-quarantined primary
        # uid, as hook(uid, error) — the serving gateway maps these to
        # terminal ``failed`` request state.
        self.failure_hook: Optional[Callable[[int, str], None]] = None
        # Cluster placement metadata + locality accounting.  With a
        # journal path the directory becomes a DirectoryService whose
        # mutations are write-ahead logged; opening an existing journal
        # rehydrates holder maps and the lease ledger (failover).
        if self.cfg.journal_path is not None:
            self.directory: PlacementDirectory = DirectoryService(
                self.cfg.journal_path,
                self.cfg.directory,
                snapshot_every=self.cfg.snapshot_every,
                snapshot_bytes=self.cfg.snapshot_bytes,
                incremental=self.cfg.incremental_snapshots,
                registry=self.metrics,
            )
            for uid in self.directory.completed:
                if uid in self.cw.stage_instances:
                    self._stage_done.add(uid)
        else:
            self.directory = self.cfg.directory or PlacementDirectory()
        self.placement_local = c("placement_local")    # dependent leased where its data is
        self.placement_remote = c("placement_remote")  # dependent leased elsewhere
        self.staged_bytes_avoided = c("staged_bytes_avoided")  # inputs not re-sent
        # Coordinator data-plane accounting: region payloads this
        # coordinator relayed (fetch_region(s) serving worker pulls) vs
        # push work it only *directed* (bytes flowed worker-to-worker).
        self.relay_regions = c("relay_regions")
        self.relay_bytes = c("relay_bytes")
        self.push_directives = c("push_directives")  # delegated to a WorkerClient
        self.pushes_inline = c("pushes_inline")      # in-process targets injected directly
        # (target worker, region key) -> in-flight push ledger.  One
        # structure serves three roles: predictor dedup (a push already
        # racing toward the target is not re-sent), ingress byte
        # accounting for flow control (push_inflight_cap_bytes), and
        # the inbound hint forward_inputs consumes so the target's
        # agent defers its duplicate pull.  Entries retire on the
        # target's region_staged credit, on expiry (push evidently
        # lost), or when the target dies.
        self._push_inbound: dict[tuple[int, Any], _PushInFlight] = {}
        self._push_inflight_bytes: dict[int, int] = {}  # twid -> reserved
        # Flow control: directives queued behind a full ingress cap,
        # drained oldest-first as region_staged credits return.
        self._push_deferred: dict[int, deque] = {}
        self._push_deferred_keys: set[tuple[int, Any]] = set()
        self.pushes_deferred = c("pushes_deferred")  # directives that waited for credit
        self.pushes_dropped = c("pushes_dropped")    # deferred directives voided (death)
        self.push_inflight_peak: dict[int, int] = {}  # max reserved/target
        self._done_event = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self._stop_monitor = False
        # Serving front end (repro.serving): while a stream is open the
        # workflow is never "done" — new stage instances keep arriving
        # via submit_instances.  completion_hook (called outside the
        # lock, once per completed primary stage) lets a gateway map
        # completions back to requests.
        self._streaming = False
        self.completion_hook: Optional[Callable[[int], None]] = None
        # Count of deadline-carrying instances in the pending queue:
        # keeps the EDF insert on the serving path only (batch pushes
        # stay O(1) appends).
        self._pending_deadlines = 0

    # -- membership -------------------------------------------------------

    def register_worker(
        self,
        runtime: WorkerRuntime,
        address: Any = None,
        rack: Any = None,
    ) -> None:
        runtime.on_stage_complete = self._make_completion_cb(runtime.worker_id)
        runtime.on_stage_failed = self._make_failure_cb(runtime.worker_id)
        runtime.on_heartbeat = self._heartbeat  # per-op liveness pings
        # Region pull path: the StagingAgent prefetches completed
        # upstream outputs, and lanes re-pull inputs evicted under soft
        # tier budgets (worker._gather_inputs fallback).  fetch_regions
        # is the batched flavor: one round-trip per coalesced key batch.
        runtime.fetch_region = self._fetch_region
        runtime.fetch_regions = self._fetch_regions
        # Keep the directory honest: a region falling off the worker's
        # bottom tier is no longer a replica there (lease placement and
        # the eviction preference below both read this map).
        wid = runtime.worker_id
        runtime.store.on_drop = (
            lambda key, _wid=wid: self.directory.evict(_wid, key)
        )
        # Replication-aware eviction: under budget pressure the worker's
        # host tier sheds regions the directory shows replicated on
        # another worker before sole copies (policy knob).
        if self.cfg.placement.replication_aware_eviction:
            try:
                host = runtime.store.tier("host")
            except KeyError:
                host = None
            if host is not None:
                host.replicated = (
                    lambda key, _wid=wid: self.directory.replicated_elsewhere(
                        _wid, key
                    )
                )
        newly_q: list[int] = []
        with self._lock:
            # A relaunched worker re-registering its id must not orphan
            # the old incarnation's in-flight leases: recover them first
            # (chunk processing is idempotent), and drop the dead
            # incarnation's replicas from the directory.  Each lost
            # lease charges the dead incarnation against the chunk's
            # attempt budget — a chunk that keeps taking workers down
            # quarantines instead of cycling through the fleet.
            old = self._workers.get(wid)
            if old is not None:
                # Snapshot: crossing the attempt budget cancels leases
                # (mutates this set mid-iteration otherwise).
                for uid in list(old.leases):
                    if uid not in self._stage_done and self._charge_attempt_locked(
                        wid, uid, "worker lost mid-lease", newly_q
                    ):
                        self.recovered_leases += 1
                        self._push_pending_locked(self.cw.stage_instances[uid])
                self.directory.drop_worker(wid)
                # Pushes racing toward the dead incarnation are void:
                # release their reserved ingress bytes.
                self._abort_push_target_locked(wid)
            self._workers[wid] = _WorkerState(runtime=runtime)
            if address is not None:
                # Data-plane address: lets sibling workers dial this one
                # for region bytes instead of relaying through here.
                self.directory.set_address(wid, address)
            if rack is not None:
                # Topology identity: placement scoring can prefer
                # same-rack replicas (PlacementPolicy.rack_affinity).
                self.directory.set_rack(wid, rack)
            self._dispatch_all_locked()
            self._check_done_locked()
        self._fire_failure_hooks(newly_q)

    def _heartbeat(self, worker_id: int) -> None:
        with self._lock:
            st = self._workers.get(worker_id)
            if st is not None:
                now = time.monotonic()
                if self.cfg.health_scoring and not st.dead:
                    # Heartbeat jitter is the second gray-failure signal
                    # (a worker whose pings stretch toward the timeout
                    # is degrading even if nothing has completed yet).
                    self.health.observe_gap(worker_id, now - st.last_heartbeat)
                st.last_heartbeat = now
                if st.dead and st.runtime.alive:
                    # A fresh heartbeat after a reap proves the "dead"
                    # worker was merely slow (one op outlasted the
                    # window): rejoin it.  Its leases were already
                    # recovered; chunk processing is idempotent.  Under
                    # health scoring the slander itself is evidence of
                    # slowness, so it rejoins *as probing* — one probe
                    # lease until the score proves it healthy — never
                    # straight back to full weight.
                    st.dead = False
                    if self.cfg.health_scoring and not st.probation:
                        self._enter_probation_locked(
                            worker_id, st, self.health.score(
                                worker_id, self.cfg.heartbeat_timeout
                            ), "slander rejoin",
                        )
                    self._dispatch_all_locked()

    def deregister_worker(self, worker_id: int) -> int:
        """Elastic scale-down / drain: atomically release the worker's
        in-flight push reservations AND re-queue its outstanding leases.

        Everything happens under one lock hold so no dispatch can
        observe the half-drained state (leases gone but ingress credit
        still reserved, or vice versa).  In-flight ops on the draining
        runtime are cancelled best-effort; a completion that races past
        the cancel is dropped by ``_on_stage_complete`` (the worker is
        no longer registered), so the re-queued twin is authoritative.
        Returns the number of leases returned to the queue.
        """
        with self._lock:
            st = self._workers.pop(worker_id, None)
            if st is None:
                return 0
            requeued = 0
            for uid in sorted(st.leases):
                self._lease_t.pop((worker_id, uid), None)
                if uid not in self._stage_done:
                    try:
                        st.runtime.cancel_stage(uid)
                    except Exception:
                        pass  # runtime may already be gone
                    self.recovered_leases += 1
                    requeued += 1
                    self._push_pending_locked(self.cw.stage_instances[uid])
            st.leases.clear()
            self.directory.drop_worker(worker_id)
            # Pushes racing toward the drained worker are void: release
            # their reserved ingress bytes and drop the deferred queue,
            # else the credit leaks until the 10s expiry sweep (or
            # forever, for deferred entries that never get admitted).
            self._abort_push_target_locked(worker_id)
            self._dispatch_all_locked()
            return requeued

    # ``drain`` is the serving-facing name for graceful scale-down; it
    # is the same atomic operation as a deregistration.
    drain_worker = deregister_worker

    def _push_pending_locked(self, si: StageInstance) -> None:
        # EDF tier: deadline-carrying instances (serving requests) sort
        # earliest-first at the head of the queue, ahead of deadline-free
        # batch work.  The pending invariant is [deadlines ascending] +
        # [batch FIFO]; batch pushes keep their O(1) append.
        ctx = current_context()
        if ctx is not None and ctx.sampled:
            # First queueing wins: a recovery re-queue from the monitor
            # thread (no ambient context) must not clobber the request's
            # context, and neither must an unrelated caller's.
            self._trace_ctx.setdefault(si.uid, ctx)
        if self.tracer is not None:  # wait:lease starts (telemetry/lanes.py)
            mark_pending(si)
        if getattr(si, "deadline", None) is None:
            self._pending.append(si)
        else:
            i = 0
            for p in self._pending:
                d = getattr(p, "deadline", None)
                if d is None or d > si.deadline:
                    break
                i += 1
            self._pending.insert(i, si)
            self._pending_deadlines += 1
        svc = self._journal_svc()
        if svc is not None:
            svc.note_pending(si.uid)

    def _pop_pending_locked(self, idx: int = 0) -> StageInstance:
        si = self._pending[idx] if idx else self._pending[0]
        if idx:
            del self._pending[idx]
        else:
            self._pending.popleft()
        if getattr(si, "deadline", None) is not None:
            self._pending_deadlines -= 1
        return si

    # -- execution -----------------------------------------------------------

    def run(self, timeout: float = 120.0) -> bool:
        """Lease everything and block until the workflow completes."""
        with self._lock:
            # One membership set up front: at fig14 scale (~37k ready
            # instances) rebuilding it per stage would be O(P^2).
            queued = {p.uid for p in self._pending}
            queued.update(
                uid for w in self._workers.values() for uid in w.leases
            )
            for si in self.cw.ready_stage_instances(self._stage_done):
                if si.uid not in queued:
                    queued.add(si.uid)
                    self._push_pending_locked(si)
            self._dispatch_all_locked()
        self._stop_monitor = False
        self._monitor = threading.Thread(target=self._monitor_loop, daemon=True)
        self._monitor.start()
        ok = self._done_event.wait(timeout=timeout)
        self._stop_monitor = True
        self._monitor.join(timeout=2.0)
        return ok

    # -- streaming (serving front end) ---------------------------------------

    def open_stream(self) -> None:
        """Switch to continuous-ingestion mode: the workflow is no
        longer a fixed bag of tasks, so completion of everything
        currently known must NOT fire the done event — more requests
        may arrive.  Starts the heartbeat monitor so elastic membership
        works without a blocking :meth:`run` call."""
        with self._lock:
            self._streaming = True
            self._done_event.clear()
        if self._monitor is None or not self._monitor.is_alive():
            self._stop_monitor = False
            self._monitor = threading.Thread(
                target=self._monitor_loop, daemon=True
            )
            self._monitor.start()

    def close_stream(self, timeout: float = 120.0) -> bool:
        """End continuous ingestion: wait for everything already
        admitted to finish, then stop the monitor.  Returns False on
        timeout."""
        with self._lock:
            self._streaming = False
            self._dispatch_all_locked()
            self._check_done_locked()
        ok = self._done_event.wait(timeout=timeout)
        self._stop_monitor = True
        if self._monitor is not None:
            self._monitor.join(timeout=2.0)
        return ok

    def submit_instances(self, sis: list[StageInstance]) -> None:
        """Streamed submission: queue ready instances appended to the
        live workflow (``ConcreteWorkflow.instantiate``) and dispatch.
        Instances whose deps are not yet done unlock through the normal
        ``_on_stage_complete`` path."""
        with self._lock:
            queued = {p.uid for p in self._pending}
            queued.update(
                uid for w in self._workers.values() for uid in w.leases
            )
            for si in sis:
                if (
                    si.uid in self._stage_done
                    or si.uid in self._quarantined
                    or si.uid in queued
                ):
                    continue
                if si.deps.issubset(self._stage_done):
                    queued.add(si.uid)
                    self._push_pending_locked(si)
            self._dispatch_all_locked()

    def progress(self) -> tuple[int, int]:
        with self._lock:
            total = sum(
                1 for uid in self.cw.stage_instances if uid not in self._clone_map()
            )
            return len(self._stage_done - set(self._clone_map())), total

    def stage_outputs(self, uid: int) -> dict[str, Any]:
        with self._lock:
            return self._stage_outputs.get(uid, {})

    # -- internals ---------------------------------------------------------------

    def _clone_map(self) -> dict[int, int]:
        return getattr(self, "_clones_of", {})

    def _make_completion_cb(self, worker_id: int):
        def cb(
            si: StageInstance,
            outputs: dict[str, Any],
            exec_s: Optional[float] = None,
        ) -> None:
            self._on_stage_complete(worker_id, si, outputs, exec_s)

        return cb

    def _on_stage_complete(
        self,
        worker_id: int,
        si: StageInstance,
        outputs: dict[str, Any],
        exec_s: Optional[float] = None,
    ) -> None:
        completed: Optional[int] = None
        with self._lock:
            st = self._workers.get(worker_id)
            if st is None:
                # Completion racing past a drain/deregister: the lease
                # was already re-queued and the worker's store is gone.
                # Recording its outputs would point dependents at a
                # holder nobody can dial; the re-leased twin wins.
                return
            now = time.monotonic()
            st.last_heartbeat = now
            clones_of = self._clone_map()
            primary_uid = clones_of.get(si.uid, si.uid)
            lease_t0 = self._lease_t.pop((worker_id, si.uid), None)
            if primary_uid in self._stage_done:
                return  # a backup twin already completed this lease
            if primary_uid in self._quarantined:
                # Completion racing past a quarantine decision: the
                # stage is already terminally accounted as failed —
                # recording it done too would double-count the tile.
                return
            # Gray-failure signal: this worker's observed stage latency
            # against the cross-worker distribution.  The histogram is
            # per stage name so heterogeneous stages don't pollute each
            # other's p99 (hedging) or median (health ratio).
            if lease_t0 is not None:
                elapsed = now - lease_t0
                hist = self._stage_hist(si.stage.name)
                # Health prefers the worker-reported execution seconds:
                # lease latency includes queueing, so a probe lease
                # (empty queue) judged against queue-inflated medians
                # exits probation on a coin flip.  Fall back to lease
                # latency for runtimes that don't report exec time.
                if exec_s is not None:
                    eh = self._exec_hist(si.stage.name)
                    expected = eh.percentile(0.5)
                    sample = exec_s
                else:
                    expected = hist.percentile(0.5)
                    sample = elapsed
                # Suspects don't write the baselines: one benched
                # worker's 8x latencies would drag the stage p99 up to
                # *its* speed, raising the hedge trigger exactly when
                # hedges are most needed (observed: a stuck probe aged
                # 5s before hedging because p99 had absorbed the
                # straggler's own queue-inflated samples).
                if not st.probation:
                    hist.observe(elapsed)
                    if exec_s is not None:
                        self._exec_hist(si.stage.name).observe(exec_s)
                if (
                    self.cfg.health_scoring
                    and expected is not None
                    and expected > 0.0
                ):
                    self.health.observe(worker_id, sample / expected)
                    self._update_probation_locked(worker_id, st)
            self._stage_done.add(primary_uid)
            if si.uid != primary_uid:
                self._stage_done.add(si.uid)
            self._trace_ctx.pop(primary_uid, None)
            self._trace_ctx.pop(si.uid, None)
            self._stage_outputs[primary_uid] = outputs
            for w_wid, wst in self._workers.items():
                wst.leases.discard(si.uid)
                wst.leases.discard(primary_uid)
                self._lease_t.pop((w_wid, si.uid), None)
                self._lease_t.pop((w_wid, primary_uid), None)
                # Cancel twins on other workers.
                for c_uid, p_uid in clones_of.items():
                    if p_uid == primary_uid and c_uid in wst.leases:
                        wst.runtime.cancel_stage(c_uid)
                        wst.leases.discard(c_uid)
                        self._lease_t.pop((w_wid, c_uid), None)
            primary = self.cw.stage_instances[primary_uid]
            # The completing worker now holds this stage's sink outputs:
            # record placements so dispatch can route dependents to it.
            sinks = set(primary.stage.sinks())
            for oi in primary.op_instances:
                if oi.op.name in sinks and outputs.get(oi.op.name) is not None:
                    if si.uid != primary_uid and st is not None:
                        # A backup twin finished: its store holds the
                        # outputs under the clone's op uids.  Alias them
                        # under the primary keys (same objects, no copy)
                        # so the placement below is actually serviceable.
                        st.runtime.provide_input(oi.uid, outputs[oi.op.name])
                    self.directory.record(
                        worker_id, op_key(oi.uid), sizeof(outputs[oi.op.name])
                    )
            # Journal the completion only AFTER the sink placements: a
            # crash in between must rehydrate the stage as *incomplete*
            # (idempotent re-run) rather than as done-with-no-holders,
            # which would wedge push-mode dependents.
            svc = self._journal_svc()
            if svc is not None:
                svc.note_complete(primary_uid)
            # Unlock downstream stage instances and forward their inputs.
            for dep_uid in primary.dependents:
                dsi = self.cw.stage_instances[dep_uid]
                if dsi.deps.issubset(self._stage_done) and dep_uid not in self._stage_done:
                    already = any(
                        dep_uid in w.leases for w in self._workers.values()
                    ) or any(p.uid == dep_uid for p in self._pending)
                    if not already:
                        self._push_pending_locked(dsi)
            # Predictive push: BEFORE the dispatch below leases the
            # newly-ready dependents, predict where they will land and
            # direct the holders (push_request notify — the completing
            # worker is already a directory holder of its sinks) to push
            # the missing inputs there.  The notifies are in flight
            # while dispatch still runs, so the bytes race *ahead of*
            # the lease instead of trailing its first touch.
            if self.cfg.predictive_push:
                self._predict_pushes_locked(worker_id, primary, outputs)
            self._dispatch_all_locked()
            self._check_done_locked()
            completed = primary_uid
        # Outside the lock: the serving gateway's hook may re-enter the
        # Manager (submit more instances when a request finishes).
        if completed is not None and self.completion_hook is not None:
            self.completion_hook(completed)
        if completed is not None:  # after the hook: it sees the outputs whole
            self._release_finished(si.chunk.chunk_id, completed)

    def _release_finished(self, chunk: Any, uid: int) -> None:
        """Release the outputs of the stage instances linked to ``uid``
        (``core/release.py``) once all are done and none is pending,
        leased or twinned: each keeps only its result, and every worker
        that can release (in-process) drops its references to their op
        outputs, which leave the placement directory."""
        with self._lock:
            group = self._finished_group_locked(uid)
            if not group:
                return
            clones = [c for c, p in self._clone_map().items() if p in group]
            op_uids = [
                oi.uid
                for g in group + clones
                for oi in self.cw.stage_instances[g].op_instances
            ]
            for g in group:
                outputs = self._stage_outputs.get(g)
                if outputs is None:
                    continue
                stage = self.cw.stage_instances[g].stage
                kept = {n: result_of(stage.op(n), v) for n, v in outputs.items()}
                self._stage_outputs[g] = {
                    n: v for n, v in kept.items() if v is not None
                }
            for wid, st in self._workers.items():
                release = getattr(st.runtime, "release_ops", None)
                if release is None:
                    continue
                release(chunk, op_uids)
                for u in op_uids:
                    if wid in self.directory.holders(op_key(u)):
                        self.directory.evict(wid, op_key(u))

    def _finished_group_locked(self, uid: int) -> list[int]:
        """The stage instances linked to ``uid`` by dependencies, when
        every one is done and none (nor a twin of one) is pending or
        leased; else an empty list."""
        group, stack = {uid}, [uid]
        while stack:
            si = self.cw.stage_instances[stack.pop()]
            if si.uid not in self._stage_done:
                return []
            for u in si.deps | si.dependents:
                if u not in group:
                    group.add(u)
                    stack.append(u)
        clones_of = self._clone_map()
        busy = [p.uid for p in self._pending]
        busy += [u for w in self._workers.values() for u in w.leases]
        if any(clones_of.get(u, u) in group for u in busy):
            return []
        return sorted(group)

    # -- failure handling / poison-chunk quarantine --------------------------

    def _make_failure_cb(self, worker_id: int):
        def cb(si: Any, error: str) -> None:
            uid = si if isinstance(si, int) else si.uid
            self.stage_failed(worker_id, uid, str(error))

        return cb

    def stage_failed(self, worker_id: int, uid: int, error: str) -> None:
        """A worker reports a lease whose op raised (the worker itself
        is healthy and keeps serving).  The lease is charged against the
        chunk's attempt budget and re-queued elsewhere; a chunk that
        fails on ``cfg.quarantine_after`` distinct workers is poison —
        quarantined together with its dependents instead of being
        re-leased forever.  Idempotent per (stage, worker): retried
        ``stage_failed`` RPCs re-add the same worker to the same set."""
        newly_q: list[int] = []
        with self._lock:
            st = self._workers.get(worker_id)
            if st is not None:
                st.last_heartbeat = time.monotonic()
                st.leases.discard(uid)
                self._lease_t.pop((worker_id, uid), None)
            pu = self._clone_map().get(uid, uid)
            if pu in self._stage_done or pu in self._quarantined:
                return  # a twin completed, or already terminal
            self.stage_failures += 1
            if self._charge_attempt_locked(worker_id, uid, error, newly_q):
                # Not (yet) poison: retry elsewhere — unless a backup
                # twin of the same primary is still running or queued.
                clone_uids = {
                    c for c, p in self._clone_map().items() if p == pu
                }
                active = {pu} | clone_uids
                already = any(
                    active & w.leases for w in self._workers.values()
                ) or any(p.uid in active for p in self._pending)
                if not already:
                    self.lease_retries += 1
                    self._push_pending_locked(self.cw.stage_instances[pu])
            self._dispatch_all_locked()
            self._check_done_locked()
        self._fire_failure_hooks(newly_q)

    def _charge_attempt_locked(
        self, worker_id: int, uid: int, error: str, quarantined_out: list[int]
    ) -> bool:
        """Charge one failed attempt of ``uid`` to ``worker_id``.
        Returns True when the caller should re-queue the lease; False
        when the stage is already terminal or just crossed the budget
        (newly-quarantined primary uids are appended to
        ``quarantined_out`` for hook delivery outside the lock)."""
        pu = self._clone_map().get(uid, uid)
        if pu in self._stage_done or pu in self._quarantined:
            return False
        tried = self._attempts.setdefault(pu, set())
        tried.add(worker_id)
        # Terminal when the distinct-worker budget fills, OR when every
        # live worker has already tried the stage — re-leasing can only
        # cycle through workers that already failed it, so the budget
        # could never fill (the effective budget on a small cluster is
        # min(quarantine_after, live width)).  An empty live set (total
        # outage) does not quarantine: workers may come back.
        live = {
            w
            for w, ws in self._workers.items()
            if not ws.dead and ws.runtime.alive
        }
        if len(tried) >= max(self.cfg.quarantine_after, 1) or (
            live and live <= tried
        ):
            quarantined_out.extend(self._quarantine_locked(pu, error))
            return False
        return True

    def _quarantine_locked(self, uid: int, error: str) -> list[int]:
        """Quarantine ``uid`` and cascade over its dependents (a stage
        downstream of a quarantined input can never run).  Pending
        entries are removed, live leases (and backup twins) cancelled.
        Returns the newly-quarantined primary uids."""
        newly: list[int] = []
        stack: list[tuple[int, str]] = [(uid, error)]
        while stack:
            u, err = stack.pop()
            pu = self._clone_map().get(u, u)
            if pu in self._quarantined or pu in self._stage_done:
                continue
            self._quarantined[pu] = err
            self._trace_ctx.pop(pu, None)
            newly.append(pu)
            for i, p in enumerate(self._pending):
                if self._clone_map().get(p.uid, p.uid) == pu:
                    self._pop_pending_locked(i)
                    break
            clone_uids = {c for c, p in self._clone_map().items() if p == pu}
            active = {pu} | clone_uids
            for wst in self._workers.values():
                for cu in active & wst.leases:
                    try:
                        wst.runtime.cancel_stage(cu)
                    except Exception:
                        pass  # runtime may already be gone
                    wst.leases.discard(cu)
            si = self.cw.stage_instances.get(pu)
            if si is not None:
                stack.extend(
                    (d, f"upstream stage {pu} quarantined: {err}")
                    for d in si.dependents
                )
        return newly

    def _fire_failure_hooks(self, uids: list[int]) -> None:
        if not uids:
            return
        if self.recorder is not None:
            # A quarantine is a postmortem moment: freeze the recent
            # span/event ring before the hooks mutate downstream state.
            self.recorder.dump(
                "quarantine",
                detail={
                    "uids": list(uids),
                    "errors": {
                        u: self._quarantined.get(u, "quarantined")
                        for u in uids
                    },
                },
            )
        hook = self.failure_hook
        if hook is None:
            return
        for uid in uids:
            try:
                hook(uid, self._quarantined.get(uid, "quarantined"))
            except Exception:
                pass  # surfacing is best-effort; accounting already done

    def quarantined(self) -> dict[int, str]:
        """Snapshot of quarantined primary stage uids -> error."""
        with self._lock:
            return dict(self._quarantined)

    def stats(self) -> dict[str, Any]:
        """Wire-safe coordinator stats: a thin view over the
        ``manager.*`` registry cells plus live queue/membership gauges
        (served over the bus by the ``get_stats`` RPC)."""
        with self._lock:
            out: dict[str, Any] = {
                "recovered_leases": int(self.recovered_leases),
                "duplicated_leases": int(self.duplicated_leases),
                "stage_failures": int(self.stage_failures),
                "lease_retries": int(self.lease_retries),
                "placement_local": int(self.placement_local),
                "placement_remote": int(self.placement_remote),
                "staged_bytes_avoided": int(self.staged_bytes_avoided),
                "relay_regions": int(self.relay_regions),
                "relay_bytes": int(self.relay_bytes),
                "push_directives": int(self.push_directives),
                "pushes_inline": int(self.pushes_inline),
                "pushes_deferred": int(self.pushes_deferred),
                "pushes_dropped": int(self.pushes_dropped),
                "push_inflight_peak": dict(self.push_inflight_peak),
                "probations": int(self.probations),
                "probation_exits": int(self.probation_exits),
                "hedged_leases": int(self.hedged_leases),
                "workers_probing": sum(
                    1 for ws in self._workers.values() if ws.probation
                ),
                "workers": len(self._workers),
                "pending": len(self._pending),
                "stages_done": len(self._stage_done),
                "quarantined": len(self._quarantined),
            }
        svc = self._journal_svc()
        if svc is not None:
            out["directory"] = svc.stats()
        if self.tracer is not None:
            out["tracing"] = self.tracer.stats()
        return out

    def _dispatch_all_locked(self) -> None:
        live = {
            wid: st
            for wid, st in self._workers.items()
            if not st.dead and st.runtime.alive
        }
        if self.cfg.locality_aware:
            self._dispatch_locality_locked(live)
        else:
            for wid, st in live.items():
                while len(st.leases) < self._window_for_locked(wid, st) and self._pending:
                    idx = next(
                        (
                            i
                            for i, p in enumerate(self._pending)
                            if not self._avoid_lease_locked(wid, p.uid, live)
                        ),
                        None,
                    )
                    if idx is None:
                        break
                    self._lease_locked(wid, st, self._pop_pending_locked(idx))
        if self.cfg.backup_tasks and not self._pending:
            self._issue_backups_locked()

    def _dispatch_locality_locked(
        self, live: dict[int, _WorkerState]
    ) -> None:
        """Locality-aware lease placement over the pending deque.

        First pass may *defer* a stage whose input bytes live on another
        worker that still has window slack; the second pass is purely
        work-conserving so nothing starves (demand-driven fallback).
        """
        for allow_defer in (True, False):
            progress = True
            while progress and self._pending:
                progress = False
                slack = {
                    wid
                    for wid, st in live.items()
                    if len(st.leases) < self._window_for_locked(wid, st)
                }
                if not slack:
                    return
                for wid, st in live.items():
                    if (
                        len(st.leases) >= self._window_for_locked(wid, st)
                        or not self._pending
                    ):
                        continue
                    idx = select_lease(
                        self._pending,
                        wid,
                        self.directory,
                        self._input_keys,
                        self.cfg.placement,
                        workers_with_slack=slack,
                        allow_defer=allow_defer,
                    )
                    if idx is None:
                        continue
                    if self._avoid_lease_locked(
                        wid, self._pending[idx].uid, live
                    ):
                        continue  # an untried worker must take this one
                    si = self._pop_pending_locked(idx)
                    self._lease_locked(wid, st, si)
                    progress = True

    def _avoid_lease_locked(
        self, wid: int, uid: int, live: dict[int, _WorkerState]
    ) -> bool:
        """Soft anti-affinity for charged retries: never re-lease a
        stage to a worker that already failed it while an untried live
        worker exists.  Without this the distinct-worker quarantine
        budget can starve — a poison chunk ping-pongs on whichever
        worker frees a slot first and is re-leased forever.  When every
        live worker has tried the stage the check stands down (work
        conservation beats affinity; the budget decides from there)."""
        if not self._attempts:
            return False
        tried = self._attempts.get(self._clone_map().get(uid, uid))
        if not tried or wid not in tried:
            return False
        return any(w not in tried for w in live)

    def _window_for_locked(self, wid: int, st: _WorkerState) -> int:
        """Effective lease window for a worker: the configured window
        scaled by the health weight (capacity-weighted soft
        anti-affinity — a 4x-slow worker at window 4 gets 1 lease), and
        a single probe lease while on probation so recovery stays
        observable at bounded cost.  Probes are granted only from
        *surplus* backlog: when healthy workers have free slots for
        everything pending, handing a stage to the suspect converts a
        fast completion into a slow one — worst at the tail, where one
        probe lease can hold the whole run hostage until a hedge fires."""
        if not self.cfg.health_scoring:
            return self.cfg.window
        if st.probation:
            healthy_slack = sum(
                max(self.cfg.window - len(ws.leases), 0)
                for w2, ws in self._workers.items()
                if w2 != wid
                and not ws.dead
                and ws.runtime.alive
                and not ws.probation
            )
            return 1 if len(self._pending) > healthy_slack else 0
        w = self.health.weight(wid, self.cfg.heartbeat_timeout)
        return max(1, int(self.cfg.window * w + 1e-9))

    def _lease_locked(
        self, wid: int, st: _WorkerState, si: StageInstance
    ) -> None:
        self._lease_t[(wid, si.uid)] = time.monotonic()
        keys = self._input_keys(si)
        if keys:
            best = self.directory.best_worker(keys)
            if best is not None and best[1] > 0.0:
                if best[0] == wid:
                    self.placement_local += 1
                else:
                    self.placement_remote += 1
        st.leases.add(si.uid)
        svc = self._journal_svc()
        if svc is not None:
            svc.note_lease(si.uid, wid)
        ctx = self._trace_ctx.get(si.uid)
        if self.tracer is not None:  # wait:lease ends (telemetry/lanes.py)
            record_lease_wait(self.tracer, ctx, si, wid)
        if ctx is not None:
            # Re-install the request's context around the dispatch: the
            # submit_stage call (direct or over a TracingBus) carries it
            # to the worker, and the lease itself becomes a span.
            with use_context(ctx):
                if self.tracer is not None:
                    with self.tracer.span(
                        "stage:lease",
                        cat="sched",
                        args={"uid": si.uid, "worker": wid},
                    ):
                        self._forward_upstream_outputs(st.runtime, si)
                        st.runtime.submit_stage(si)
                else:
                    self._forward_upstream_outputs(st.runtime, si)
                    st.runtime.submit_stage(si)
        else:
            self._forward_upstream_outputs(st.runtime, si)
            st.runtime.submit_stage(si)

    def _journal_svc(self) -> Optional[DirectoryService]:
        d = self.directory
        return d if isinstance(d, DirectoryService) else None

    def _input_keys(self, si: StageInstance) -> list[RegionKey]:
        """Region keys of a stage instance's cross-stage inputs."""
        local = {oi.uid for oi in si.op_instances}
        return [
            op_key(dep_uid)
            for oi in si.op_instances
            for dep_uid in oi.deps
            if dep_uid not in local
        ]

    # -- coordinator-bypass data plane --------------------------------------

    def resolve_regions(
        self, keys: list, exclude: Optional[int] = None
    ) -> list:
        """Directory lookup for worker-to-worker transfer: for each key
        the ``(worker_id, bus_address)`` of a live holder (largest
        replica first), or None when only the Manager route can serve
        it.  This is the whole control-plane cost of a direct transfer:
        metadata out, bytes never through here."""
        out: list = []
        with self._lock:
            for key in keys:
                best = None
                holders = self.directory.holders(key)
                for wid in sorted(holders, key=lambda w: -holders[w]):
                    if wid == exclude:
                        continue
                    st = self._workers.get(wid)
                    if st is None or st.dead or not st.runtime.alive:
                        continue
                    addr = self.directory.address_of(wid)
                    if addr is None:
                        continue
                    best = (wid, addr)
                    break
                out.append(best)
        return out

    def region_staged(self, worker_id: int, key: RegionKey, nbytes: int) -> None:
        """A pushed replica landed on ``worker_id``: record it (journaled
        when a DirectoryService backs the directory) so dependents — and
        a restarted coordinator — can route to the new holder.

        This confirmation is also the flow-control **credit grant**:
        the landed bytes release their ingress-cap reservation and the
        target's deferred-push queue drains as far as the freed credit
        allows.

        A confirmation racing in after the target drained (elastic
        scale-down) must NOT resurrect the dead worker as a directory
        holder — the bytes landed in a store nobody can dial anymore.
        The reservation is still released either way so the ingress
        ledger cannot leak.
        """
        with self._lock:
            st = self._workers.get(worker_id)
            live = st is not None and not st.dead and st.runtime.alive
            if live:
                self.directory.record(worker_id, key, int(nbytes))
            self._release_push_locked((worker_id, key))
            if live:
                self._drain_push_deferred_locked(worker_id)

    def push_region_toward(self, key: RegionKey, target_wid: int) -> bool:
        """Explicitly route one region push toward ``target_wid``
        through the flow-controlled push path (the same admit / defer /
        credit accounting the predictive pusher uses).  Returns False
        when the push cannot be routed at all (unknown or dead target,
        no live holder with a data plane)."""
        with self._lock:
            now = time.monotonic()
            self._expire_pushes_locked(now)
            tst = self._workers.get(target_wid)
            if tst is None or tst.dead or not tst.runtime.alive:
                return False
            return self._push_one_locked(None, target_wid, tst, key, now)

    def _predict_pushes_locked(
        self, worker_id: int, primary: StageInstance, outputs: dict[str, Any]
    ) -> None:
        """Predictive push for ``primary``'s newly-ready dependents.

        Prediction = the same rule the dispatch below uses (pending-
        queue affinity under locality-aware placement, window-slack FIFO
        otherwise), run virtually.  EVERY input the predicted worker is
        missing gets pushed ahead of the lease: bus holders get a
        ``push_request`` notify (the completing worker is already a
        directory holder of its just-recorded sinks, so one mechanism
        covers both fresh and older regions), in-process targets are
        injected directly (zero copy).  Bytes never touch the Manager.
        """
        now = time.monotonic()
        self._expire_pushes_locked(now)
        sink_uids = {
            oi.uid
            for oi in primary.op_instances
            if oi.op.name in primary.stage.sinks()
        }
        ready: list[int] = []
        upcoming: list[int] = []
        for uid in primary.dependents:
            if uid in self._stage_done:
                continue
            dsi = self.cw.stage_instances[uid]
            (ready if dsi.deps.issubset(self._stage_done) else upcoming).append(
                uid
            )
        targets = self._predict_assignment_locked(ready)
        for uid in upcoming:
            # A dependent still waiting on other upstreams: its lease is
            # not imminent, but THIS completion's sinks can start moving
            # toward wherever its inputs are accumulating — counting
            # both recorded holders AND in-flight upstream leases (that
            # output will materialize on the leased worker).  By the
            # time the last upstream finishes, the fan-in is already
            # staged and the transfer rode under its compute.
            twid = self._predict_upcoming_locked(uid)
            if twid is not None:
                targets[uid] = twid
        pushed: set[tuple[int, RegionKey]] = set()
        for dep_uid in ready + upcoming:
            twid = targets.get(dep_uid)
            if twid is None:
                continue
            tst = self._workers.get(twid)
            if tst is None or tst.dead:
                continue
            dsi = self.cw.stage_instances[dep_uid]
            cross = self._cross_dep_uids(dsi)
            if dep_uid in upcoming:
                # Only this completion's own sinks are pushed early;
                # other inputs move when their producers complete.
                cross &= sink_uids
            for dep in sorted(cross):
                key = op_key(dep)
                if (
                    (twid, key) in pushed
                    or (twid, key) in self._push_inbound
                    or (twid, key) in self._push_deferred_keys
                ):
                    continue  # this push is already in flight / queued
                if self.directory.holders(key).get(twid):
                    continue  # the predicted worker already holds it
                if self._push_one_locked(worker_id, twid, tst, key, now):
                    pushed.add((twid, key))

    def _cross_dep_uids(self, si: StageInstance) -> set[int]:
        local = {oi.uid for oi in si.op_instances}
        return {
            u for oi in si.op_instances for u in oi.deps if u not in local
        }

    def _predict_upcoming_locked(self, dep_uid: int) -> Optional[int]:
        """Predicted worker for a dependent whose upstreams are still
        running: one vote per input already held (directory) plus one
        per input whose producer stage is currently leased there."""
        dsi = self.cw.stage_instances[dep_uid]
        lease_of = {
            uid: wid
            for wid, st in self._workers.items()
            if not st.dead
            for uid in st.leases
        }
        votes: dict[int, int] = {}
        for dep in self._cross_dep_uids(dsi):
            for wid in self.directory.holders(op_key(dep)):
                votes[wid] = votes.get(wid, 0) + 1
            dep_oi = self.cw.op_instances.get(dep)
            if dep_oi is not None:
                # Still-running producer: its output will materialize on
                # the worker holding its lease (leases are dropped at
                # completion, so this never double-counts a holder).
                wid = lease_of.get(dep_oi.stage_instance.uid)
                if wid is not None:
                    votes[wid] = votes.get(wid, 0) + 1
        live = {
            wid
            for wid, st in self._workers.items()
            if not st.dead and st.runtime.alive
        }
        votes = {w: v for w, v in votes.items() if w in live}
        if not votes:
            return None
        return max(votes, key=lambda w: (votes[w], -w))

    def _push_one_locked(
        self,
        worker_id: Optional[int],
        twid: int,
        tst: "_WorkerState",
        key: RegionKey,
        now: float,
    ) -> bool:
        """Route one region push toward predicted worker ``twid``,
        subject to the per-target in-flight byte cap: a push that would
        overflow the target's ingress credit is queued on its deferred
        list and re-issued when ``region_staged`` credits return."""
        if (
            (twid, key) in self._push_inbound
            or (twid, key) in self._push_deferred_keys
        ):
            # Already racing / queued toward this target: a duplicate
            # request (caller retry) must not double-reserve its bytes.
            return True
        trt = tst.runtime
        if callable(getattr(trt, "ingest_push", None)):
            # In-process target: the Manager holds the output copy —
            # the "push" is a reference hand-over, done right here
            # (zero copy, no ingress queue, so no flow control either).
            dep = key[1] if isinstance(key, tuple) and len(key) == 2 else None
            dep_oi = self.cw.op_instances.get(dep)
            if dep_oi is None:
                return False
            up = self._stage_outputs.get(dep_oi.stage_instance.uid, {})
            value = up.get(dep_oi.op.name)
            if value is None:
                return False
            trt.ingest_push(key, value)
            self.directory.record(twid, key, sizeof(value))
            self.pushes_inline += 1
            return True
        if self.directory.address_of(twid) is None:
            return False  # target has no data plane: pull remains
        est = max(self.directory.holders(key).values(), default=0)
        if not self._push_admit_locked(twid, est):
            self._push_deferred.setdefault(twid, deque()).append(
                (worker_id, key)
            )
            self._push_deferred_keys.add((twid, key))
            self.pushes_deferred += 1
            return True  # queued: the push is owed, not abandoned
        return self._issue_push_locked(worker_id, twid, tst, key, now, est)

    def _issue_push_locked(
        self,
        worker_id: Optional[int],
        twid: int,
        tst: "_WorkerState",
        key: RegionKey,
        now: float,
        est: int,
    ) -> bool:
        """Send one admitted push directive and reserve its bytes."""
        addr = self.directory.address_of(twid)
        if addr is None:
            return False
        # Ask a live holder to push (prefer the completing worker: its
        # copy is freshest and its notify is already racing the lease).
        holders = self.directory.holders(key)
        order = sorted(holders, key=lambda w: (w != worker_id, -holders[w]))
        for hwid in order:
            hst = self._workers.get(hwid)
            if (
                hwid == twid
                or hst is None
                or hst.dead
                or not hst.runtime.alive
            ):
                continue
            req = getattr(hst.runtime, "push_region_to", None)
            if req is None:
                continue
            req(key, addr)
            self.push_directives += 1
            self._push_inbound[(twid, key)] = _PushInFlight(now, est)
            total = self._push_inflight_bytes.get(twid, 0) + est
            self._push_inflight_bytes[twid] = total
            if total > self.push_inflight_peak.get(twid, 0):
                self.push_inflight_peak[twid] = total
            return True
        return False

    # -- data-plane flow control --------------------------------------------

    def _push_admit_locked(self, twid: int, nbytes: int) -> bool:
        """Ingress-cap admit rule (mirrored by the simulator's
        ``_push_admit``): admit while the target's reserved bytes stay
        within the cap; with nothing in flight one push always goes."""
        cap = self.cfg.push_inflight_cap_bytes
        if cap is None:
            return True
        inflight = self._push_inflight_bytes.get(twid, 0)
        return inflight == 0 or inflight + nbytes <= cap

    def _release_push_locked(self, lkey: tuple[int, Any]) -> None:
        ent = self._push_inbound.pop(lkey, None)
        if ent is None:
            return
        twid = lkey[0]
        left = self._push_inflight_bytes.get(twid, 0) - ent.nbytes
        if left > 0:
            self._push_inflight_bytes[twid] = left
        else:
            self._push_inflight_bytes.pop(twid, None)

    def _expire_pushes_locked(self, now: float) -> None:
        """Reclaim ledger entries whose push evidently never landed
        (holder died mid-send, frame lost): their reserved bytes return
        so the ingress cap cannot leak shut, and the affected targets'
        deferred queues get a drain chance."""
        stale = [
            lkey
            for lkey, ent in self._push_inbound.items()
            if now - ent.t >= 10.0
        ]
        for lkey in stale:
            self._release_push_locked(lkey)
        for twid in {lkey[0] for lkey in stale}:
            self._drain_push_deferred_locked(twid)

    def _drain_push_deferred_locked(self, twid: int) -> None:
        """Re-issue deferred pushes toward ``twid`` as credits allow."""
        q = self._push_deferred.get(twid)
        if not q:
            return
        tst = self._workers.get(twid)
        if tst is None or tst.dead or not tst.runtime.alive:
            self._abort_push_target_locked(twid)
            return
        now = time.monotonic()
        while q:
            src_wid, key = q[0]
            holders = self.directory.holders(key)
            if holders.get(twid):
                # Landed through another route (pull backstop) while
                # queued: the push is moot.
                q.popleft()
                self._push_deferred_keys.discard((twid, key))
                continue
            est = max(holders.values(), default=0)
            if not self._push_admit_locked(twid, est):
                break
            q.popleft()
            self._push_deferred_keys.discard((twid, key))
            if not self._issue_push_locked(src_wid, twid, tst, key, now, est):
                # Every holder died (or lost its data plane) while the
                # directive waited: the push is abandoned — counted, and
                # served by the dependent's pull backstop.
                self.pushes_dropped += 1
        if not q:
            self._push_deferred.pop(twid, None)

    def _abort_push_target_locked(self, twid: int) -> None:
        """Target worker died or left: every reserved or queued push
        toward it is void — release the ledger so the ingress cap can
        never deadlock on a corpse (its dependents re-pull from the
        surviving holders instead)."""
        q = self._push_deferred.pop(twid, None)
        if q:
            self.pushes_dropped += len(q)
            for _, key in q:
                self._push_deferred_keys.discard((twid, key))
        for lkey in [k for k in self._push_inbound if k[0] == twid]:
            self._release_push_locked(lkey)
        # Belt and braces: no ledger entry may outlive the target, so
        # the raw byte counter must not either.
        self._push_inflight_bytes.pop(twid, None)

    def _predict_assignment_locked(self, uids: list) -> dict[int, int]:
        """Which worker will the imminent dispatch lease each of
        ``uids`` to?  Mirrors ``_dispatch_all_locked`` virtually (no
        side effects): locality-aware placement scores pending-queue
        affinity per slack worker; demand-driven mode replays the
        window-filling FIFO walk over the current pending order."""
        live = {
            wid: st
            for wid, st in self._workers.items()
            if not st.dead and st.runtime.alive
        }
        slots = {
            wid: max(self.cfg.window - len(st.leases), 0)
            for wid, st in live.items()
        }
        out: dict[int, int] = {}
        if self.cfg.locality_aware:
            for uid in uids:
                keys = self._input_keys(self.cw.stage_instances[uid])
                best, best_f = None, -1.0
                for wid in live:
                    if slots.get(wid, 0) <= 0:
                        continue
                    f = (
                        self.directory.placement_score(
                            wid, keys, self.cfg.placement.rack_affinity
                        )
                        if keys
                        else 0.0
                    )
                    if f > best_f:
                        best, best_f = wid, f
                if best is not None:
                    out[uid] = best
                    slots[best] -= 1
            return out
        assign: dict[int, int] = {}
        queue = iter([si.uid for si in self._pending])
        for wid in live:
            n = slots.get(wid, 0)
            while n > 0:
                uid = next(queue, None)
                if uid is None:
                    return {u: assign[u] for u in uids if u in assign}
                assign[uid] = wid
                n -= 1
        return {u: assign[u] for u in uids if u in assign}

    def _fetch_region(self, key: RegionKey) -> Any:
        """Region pull: output of a completed upstream op, or None.

        This is the *relay* route — the bytes cross the coordinator —
        kept as the fallback when the holder is dead or unknown; the
        happy path resolves holders (``resolve_regions``) and dials the
        sibling directly.  The Manager's own output copy is tried
        first; after a failover rehydration that copy is gone, so the
        pull falls back to a worker the placement directory records as
        a holder (region-pull RPC via the worker handle).  The holder
        RPCs run *outside* the Manager lock: a slow or hung holder must
        not stall heartbeats and dispatch for every other worker.
        """
        if not (isinstance(key, tuple) and len(key) == 2 and key[0] == "op"):
            return None
        with self._lock:
            oi = self.cw.op_instances.get(key[1])
            if oi is None:
                return None
            outputs = self._stage_outputs.get(oi.stage_instance.uid)
            if outputs and oi.op.name in outputs:
                value = outputs.get(oi.op.name)
                self.relay_regions += 1
                self.relay_bytes += sizeof(value)
                return value
            holders = self._holder_runtimes_locked(key)
        for rt in holders:
            value = rt.pull_region(key)
            if value is not None:
                self.relay_regions += 1
                self.relay_bytes += sizeof(value)
                return value
        return None

    def _fetch_regions(self, keys: list) -> list:
        """Batched region pull: one round-trip serves a whole key batch
        (StagingAgent coalescing / SocketBus ``fetch_regions`` RPC)."""
        return [self._fetch_region(key) for key in keys]

    def _holder_runtimes_locked(
        self, key: RegionKey, exclude: Optional[int] = None
    ) -> list:
        """Live worker handles the directory names as holders of ``key``."""
        out = []
        for wid in self.directory.holders(key):
            if wid == exclude:
                continue
            st = self._workers.get(wid)
            if st is not None and not st.dead and st.runtime.alive:
                out.append(st.runtime)
        return out

    def _pull_from_holder_locked(
        self, key: RegionKey, exclude: Optional[int] = None
    ) -> Any:
        """Synchronous holder pull for the (rare) rehydration push path.

        Runs under the Manager lock — only reached when forwarding to an
        agent-less worker after a failover; proxies cap the RPC timeout
        so a hung holder bounds, not wedges, the control plane.
        """
        for rt in self._holder_runtimes_locked(key, exclude=exclude):
            value = rt.pull_region(key)
            if value is not None:
                return value
        return None

    def _forward_upstream_outputs(self, rt: WorkerRuntime, si: StageInstance) -> None:
        """Provide cross-stage inputs (sink op outputs of upstream stages).

        Workers running a StagingAgent get the *pull* flavor: inputs not
        already staged are left for the agent to prefetch asynchronously
        (submit_stage enqueues the requests), overlapping the copy with
        whatever the lanes are executing.  Agent-less workers get the
        classic synchronous push.

        Delivery is one batched ``forward_inputs`` round-trip per lease:
        the worker marks inputs already staged there (skip-copy; the
        savings are accounted here) and ingests the pushed values —
        on a SocketBus that is a single frame instead of a per-
        dependency mark/provide conversation.
        """
        lazy = getattr(rt, "agent", None) is not None
        items: list[tuple[int, Any, bool, bool]] = []
        sizes: dict[int, int] = {}
        for oi in si.op_instances:
            for dep_uid in oi.deps:
                if dep_uid not in self.cw.op_instances:
                    continue
                dep_oi = self.cw.op_instances[dep_uid]
                if dep_oi.stage_instance.uid == si.uid:
                    continue
                up_uid = dep_oi.stage_instance.uid
                up_outputs = self._stage_outputs.get(up_uid, {})
                if dep_oi.op.name in up_outputs:
                    value = up_outputs[dep_oi.op.name]
                elif up_uid in self._stage_done:
                    # Rehydrated Manager: the output payload died with
                    # the old coordinator.  Lazy workers pull it through
                    # the data plane / fetch_region (both consult the
                    # directory's sibling holders); push-mode workers
                    # need it refetched right now.
                    key = op_key(dep_uid)
                    value = (
                        None
                        if lazy
                        else self._pull_from_holder_locked(
                            key, exclude=rt.worker_id
                        )
                    )
                else:
                    continue  # upstream genuinely not finished yet
                sizes[dep_uid] = (
                    sizeof(value)
                    if value is not None
                    else max(
                        self.directory.holders(op_key(dep_uid)).values(),
                        default=0,
                    )
                )
                push = not lazy and value is not None
                # A predicted push is racing toward this worker for this
                # key: tell it, so its agent defers the duplicate pull.
                # The ledger entry stays until the region_staged credit
                # (or expiry) retires it — the reserved ingress bytes
                # are still on the wire; ``leased`` just stops a
                # re-lease from double-arming the agent's deferral.
                ent = self._push_inbound.get(
                    (rt.worker_id, op_key(dep_uid))
                )
                inbound = lazy and ent is not None and not ent.leased
                if ent is not None:
                    ent.leased = True
                items.append((dep_uid, value if push else None, push, inbound))
        if not items:
            return
        for uid in rt.forward_inputs(items):
            # Already staged on that worker (it ran the upstream, or its
            # agent prefetched it): the copy was skipped — account it.
            self.staged_bytes_avoided += sizes.get(uid, 0)

    def _issue_backups_locked(self) -> None:
        clones_of = getattr(self, "_clones_of", None)
        if clones_of is None:
            clones_of = self._clones_of = {}
        # A probationed worker is excluded: it is the suspected
        # straggler — duplicating tail work onto it defeats the backup.
        idle = [
            (wid, st)
            for wid, st in self._workers.items()
            if not st.dead
            and st.runtime.alive
            and not st.probation
            and not st.leases
        ]
        if not idle:
            return
        outstanding: list[StageInstance] = []
        for st in self._workers.values():
            for uid in st.leases:
                if (
                    uid not in self._stage_done
                    and uid not in self._dup_issued
                    and uid not in clones_of
                ):
                    outstanding.append(self.cw.stage_instances[uid])
        for (wid, st), si in zip(idle, outstanding):
            self._dup_issued.add(si.uid)
            self.duplicated_leases += 1
            self._clone_lease_locked(wid, st, si)

    def _clone_lease_locked(
        self, wid: int, st: _WorkerState, si: StageInstance
    ) -> None:
        """Duplicate ``si`` onto worker ``wid`` as a backup/hedge twin.

        The clone mirrors the original's cross-stage input edges so the
        twin computes on the same upstream outputs (a bare re-instance
        would run its source ops on the raw chunk payload); first
        completion wins through ``_on_stage_complete``'s twin-cancel.
        """
        clones_of = getattr(self, "_clones_of", None)
        if clones_of is None:
            clones_of = self._clones_of = {}
        clone = self.cw._new_stage_instance(si.chunk, si.stage)  # noqa: SLF001
        local = {o.uid for o in si.op_instances}
        orig_by_name = {o.op.name: o for o in si.op_instances}
        for c_oi in clone.op_instances:
            orig = orig_by_name[c_oi.op.name]
            c_oi.deps |= orig.deps - local
            c_oi.dep_names.update(
                {u: n for u, n in orig.dep_names.items() if u not in local}
            )
        clones_of[clone.uid] = si.uid
        st.leases.add(clone.uid)
        self._lease_t[(wid, clone.uid)] = time.monotonic()
        self._forward_upstream_outputs(st.runtime, clone)
        st.runtime.submit_stage(clone)

    # -- gray-failure resilience ----------------------------------------------

    def _stage_hist(self, stage_name: str):
        """Manager-side stage-latency histogram (lease to completion),
        one per stage name — the distribution the hedge p99 trigger
        reads (queueing included: a hedge covers the whole wait)."""
        return self.metrics.histogram(f"manager.stage_latency_s.{stage_name}")

    def _exec_hist(self, stage_name: str):
        """Worker-reported stage *execution* seconds (queueing
        excluded), one per stage name — the health ratio's expected
        baseline.  Separate from ``_stage_hist``: judging a probe
        lease (empty queue) against queue-inflated latencies made
        probation exit a coin flip."""
        return self.metrics.histogram(f"manager.stage_exec_s.{stage_name}")

    def _update_probation_locked(self, wid: int, st: _WorkerState) -> None:
        """Probation state machine, advanced on each health observation:
        a clean worker whose score crosses the entry threshold (with
        enough samples to be credible) gets benched; a probing worker
        whose score recovers — judged on its own probe completions, at
        least two — rejoins at full weight."""
        s = self.health.score(wid, self.cfg.heartbeat_timeout)
        if not st.probation:
            if (
                self.health.samples(wid) >= self.cfg.probation_min_samples
                and s >= self.cfg.probation_ratio
            ):
                self._enter_probation_locked(wid, st, s, "runtime ratio")
            return
        st.probe_completions += 1
        if (
            st.probe_completions >= 2
            and s <= self.cfg.probation_recover_ratio
        ):
            st.probation = False
            st.hedged_against = 0
            self.probation_exits += 1
            self.health.reset(wid)
            if self.recorder is not None:
                self.recorder.note(
                    "probation_exit", worker=wid, score=round(s, 3),
                    probes=st.probe_completions,
                )

    def _enter_probation_locked(
        self, wid: int, st: _WorkerState, score: float, reason: str
    ) -> None:
        """Bench a gray-failing worker: its outstanding leases re-queue
        to healthy workers (the same atomic recovery a drain performs)
        but the worker stays *registered* with a single probe lease —
        recovery is observable and rejoin automatic, distinct from
        heartbeat death which assumes the work is lost."""
        if st.probation:
            return
        st.probation = True
        st.probe_completions = 0
        st.hedged_against = 0
        st.last_heartbeat = time.monotonic()
        self.probations += 1
        if self.recorder is not None:
            self.recorder.note(
                "probation_enter", worker=wid, score=round(score, 3),
                reason=reason,
            )
        for uid in sorted(st.leases):
            self._lease_t.pop((wid, uid), None)
            if uid in self._stage_done:
                continue
            try:
                st.runtime.cancel_stage(uid)
            except Exception:
                pass  # runtime may already be gone
            # A twin of the same primary already live elsewhere (or
            # queued) covers this lease — re-queueing would make a
            # third runner for no added protection.
            pu = self._clone_map().get(uid, uid)
            clone_uids = {c for c, p in self._clone_map().items() if p == pu}
            active = ({pu} | clone_uids) - {uid}
            covered = any(
                active & ws.leases
                for ws in self._workers.values()
                if ws is not st
            ) or any(p.uid in active for p in self._pending)
            if not covered:
                self.recovered_leases += 1
                self._push_pending_locked(self.cw.stage_instances[pu])
        st.leases.clear()

    def _issue_hedges_locked(self, now: float) -> None:
        """Percentile hedging: a running lease whose age exceeds its
        stage's measured latency p99 × ``hedge_slack`` gets a twin on
        the healthiest worker with window slack — first completion wins
        through the existing twin-cancel/exactly-once path.  This
        generalizes tail-only backup tasks: hedges fire mid-run,
        triggered by the latency histogram instead of queue drain, and
        are health-routed away from suspects."""
        slack = self.cfg.hedge_slack
        if slack is None:
            return
        candidates: list[tuple[int, _WorkerState, StageInstance, float, float, float]] = []
        for wid, st in self._workers.items():
            if st.dead or not st.runtime.alive:
                continue
            for uid in st.leases:
                if (
                    uid in self._stage_done
                    or uid in self._dup_issued
                    or uid in self._clone_map()
                ):
                    continue
                t0 = self._lease_t.get((wid, uid))
                if t0 is None:
                    continue
                si = self.cw.stage_instances[uid]
                hist = self._stage_hist(si.stage.name)
                if hist.count < self.cfg.hedge_min_samples:
                    continue
                p99 = hist.percentile(0.99)
                if p99 is None or now - t0 <= p99 * slack:
                    continue
                p50 = hist.percentile(0.5)
                candidates.append((wid, st, si, now - t0, p99, p50 or 0.0))
        for wid, st, si, age, p99, p50 in candidates:
            if si.uid not in st.leases or si.uid in self._dup_issued:
                continue  # probation entry below re-queued it already
            target = self._pick_hedge_target_locked(exclude=wid)
            if target is None:
                return  # nobody has slack: retry next monitor tick
            twid, tst = target
            self._dup_issued.add(si.uid)
            self.duplicated_leases += 1
            self.hedged_leases += 1
            self._clone_lease_locked(twid, tst, si)
            if self.recorder is not None:
                self.recorder.note(
                    "hedge", uid=si.uid, slow_worker=wid, target=twid,
                    age_s=round(age, 4), p99_s=round(p99, 4),
                )
            # A lease blowing p99 × slack is itself a health
            # observation — it arrives *before* the slow completion
            # would, which is exactly when detection matters.
            if self.cfg.health_scoring:
                st.hedged_against += 1
                if p50 > 0.0:
                    self.health.observe(wid, age / p50)
                if (
                    not st.probation
                    and st.hedged_against >= self.cfg.probation_after_hedges
                ):
                    self._enter_probation_locked(
                        wid, st,
                        self.health.score(wid, self.cfg.heartbeat_timeout),
                        "hedged leases",
                    )

    def _pick_hedge_target_locked(
        self, exclude: int
    ) -> Optional[tuple[int, _WorkerState]]:
        """Healthiest live worker with window slack, excluding the
        suspect itself and anything on probation."""
        best: Optional[tuple[tuple, int, _WorkerState]] = None
        for twid, tst in self._workers.items():
            if (
                twid == exclude
                or tst.dead
                or not tst.runtime.alive
                or tst.probation
            ):
                continue
            # One overflow slot past the window: under saturation every
            # healthy window is full, and a hedge that must wait for a
            # free slot defeats its purpose (first completion wins and
            # the twin is cancelled, so the overflow is transient).
            cap = self._window_for_locked(twid, tst) + 1
            free = cap - len(tst.leases)
            if free <= 0:
                continue
            w = (
                self.health.weight(twid, self.cfg.heartbeat_timeout)
                if self.cfg.health_scoring
                else 1.0
            )
            key = (w, free, -twid)
            if best is None or key > best[0]:
                best = (key, twid, tst)
        if best is None:
            return None
        return best[1], best[2]

    def _check_done_locked(self) -> None:
        if self._streaming:
            return  # open stream: more requests may still arrive
        clones = set(self._clone_map())
        for uid in self.cw.stage_instances:
            if uid in clones:
                continue
            # A quarantined stage is terminally accounted: completed-or-
            # quarantined is the exactly-once invariant, and a poison
            # chunk must not wedge the run.
            if uid not in self._stage_done and uid not in self._quarantined:
                return
        self._done_event.set()

    def _monitor_loop(self) -> None:
        """Heartbeat watchdog: reap dead workers, re-lease their work."""
        while not self._stop_monitor and not self._done_event.is_set():
            time.sleep(self.cfg.poll_interval)
            now = time.monotonic()
            newly_q: list[int] = []
            with self._lock:
                # Reclaim lost-push reservations even when no further
                # stage completion would run the predictor's sweep.
                self._expire_pushes_locked(now)
                any_live = any(
                    not st.dead and st.runtime.alive
                    for st in self._workers.values()
                )
                for wid, st in self._workers.items():
                    if st.dead:
                        # Last-resort rejoin: every worker has been
                        # reaped yet this one's runtime reports alive.
                        # Without it a cluster whose every (healthy but
                        # slow) worker was slandered wedges with work
                        # pending and nobody to run it.  With other
                        # live workers, exclusion stands — a genuinely
                        # wedged worker must not be re-leased work; it
                        # rejoins only via a fresh heartbeat
                        # (_heartbeat), which proves progress.
                        if not any_live and st.runtime.alive:
                            st.dead = False
                            st.last_heartbeat = now
                            any_live = True
                        continue
                    inflight = bool(st.leases)
                    # A probationed worker is already contained (one
                    # probe lease, hedging covers it): reaping it again
                    # would double-drain work the probation entry just
                    # re-queued.  It keeps a long-grace backstop so a
                    # probe that wedges outright still gets reaped.
                    grace = self.cfg.heartbeat_timeout * (
                        4.0 if st.probation else 1.0
                    )
                    expired = now - st.last_heartbeat > grace
                    if not st.runtime.alive or (inflight and expired):
                        st.dead = True
                        self.directory.drop_worker(wid)
                        # Pushes toward the corpse are void: release
                        # their credits, drop its deferred queue.
                        self._abort_push_target_locked(wid)
                        # Each lost lease charges the dead worker against
                        # the chunk's attempt budget: a chunk that keeps
                        # killing workers quarantines instead of being
                        # re-leased forever.  Snapshot: crossing the
                        # budget cancels leases (mutates this set).
                        for uid in list(st.leases):
                            self._lease_t.pop((wid, uid), None)
                            if uid not in self._stage_done and (
                                self._charge_attempt_locked(
                                    wid, uid, "worker lost mid-lease",
                                    newly_q,
                                )
                            ):
                                self.recovered_leases += 1
                                self._push_pending_locked(
                                    self.cw.stage_instances[uid]
                                )
                        st.leases.clear()
                self._issue_hedges_locked(now)
                self._dispatch_all_locked()
                self._check_done_locked()
            self._fire_failure_hooks(newly_q)
