"""Threaded Worker runtime — the WRM of paper Fig 5, executing for real.

A Worker is a multi-thread process.  One lane thread per compute device
(CPU core / accelerator); every lane pulls ``(data chunk, operation)``
tuples from the shared :class:`~repro.core.scheduling.ReadyScheduler`
under the configured policy and executes the operation's *function
variant* for its device kind.

Accelerator lanes model the discrete-memory hierarchy of the paper:
inputs are *uploaded* into a per-lane :class:`DeviceMemory` (LRU),
outputs are *downloaded* back to host memory unless the data-locality
scheduler keeps them resident for a dependent operation, and with
``prefetch=True`` the upload of the next selected tuple overlaps the
ongoing computation via a per-lane copy thread (§IV-D's
upload/process/download pipeline).

Two device-resident fast paths extend the basic model:

* ``chaining=True`` — when consecutive ops of one pipeline instance
  land on the same accelerator lane (DL reuse), the intermediate state
  stays in that lane's DeviceMemory and the host write-back is
  *deferred*: a chained output only materializes to the host tier when
  a host-side consumer (sibling lane, stage-completion read, Manager
  pull) actually needs the bytes, or when the device LRU spills it.
  Host lanes get the same dependent-affinity: a CPU-resident chain's
  intermediates skip the region-store round-trip and are served by
  reference until stage completion (``host_chain_*`` stats).
* ``micro_batch=B`` — an idle accelerator lane pops up to ``B`` ready
  instances of the same *batchable* op (``FunctionVariant.batchable``)
  and executes them as one batched call, amortizing per-op dispatch
  and launch overheads over the batch.

On a single-process deployment (this container) lanes are plain
threads; on a hybrid cluster the same class drives host cores plus one
control thread per accelerator — the WCC/Manager protocol is identical
(``core/manager.py``) and crosses process boundaries through a
:mod:`repro.transport` ``WorkerClient`` (``submit/forward/pull`` RPCs
in, ``complete/heartbeat/drop`` notifies out).
"""

from __future__ import annotations

import queue
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from .cost_model import TPU_V5E, op_cost_from_seconds, optimal_micro_batch
from .release import tensor_bytes
from .scheduling import HOST_KIND, ReadyScheduler
from .variants import VariantRegistry, registry as global_registry
from .workflow import OperationInstance, StageInstance
from ..staging import RegionStore, StagingAgent, StagingConfig, op_key
from ..staging.tiers import HostTier
from ..telemetry.metrics import MetricsRegistry
from ..telemetry.tracing import SpanContext, current_context, use_context
from ..telemetry.lanes import LaneTrace, record_release

__all__ = ["DeviceMemory", "LaneSpec", "OpContext", "WorkerRuntime"]


class DeviceMemory:
    """LRU store emulating an accelerator's discrete memory.

    ``put`` returns the entries it evicted (oldest-first, never the
    entry just inserted) so the owner can write device-only values back
    to the host tier instead of losing them — slot budgets stay a soft
    cap under device-resident chaining, never a correctness hazard.
    """

    def __init__(self, slots: int = 64):
        self.slots = slots
        self._store: "OrderedDict[int, Any]" = OrderedDict()
        self.uploads = 0
        self.downloads = 0
        self.evictions = 0

    def put(self, uid: int, value: Any) -> list[tuple[int, Any]]:
        self._store[uid] = value
        self._store.move_to_end(uid)
        evicted: list[tuple[int, Any]] = []
        while len(self._store) > self.slots:
            victim = next(k for k in self._store if k != uid)
            evicted.append((victim, self._store.pop(victim)))
            self.evictions += 1
        return evicted

    def get(self, uid: int) -> Any:
        value = self._store[uid]
        self._store.move_to_end(uid)
        return value

    def __contains__(self, uid: int) -> bool:
        return uid in self._store

    def discard(self, uid: int) -> Any:
        """Remove ``uid``'s entry, not an eviction: its value, or None."""
        return self._store.pop(uid, None)

    def resident_uids(self) -> set[int]:
        return set(self._store)


@dataclass(frozen=True)
class LaneSpec:
    kind: str = HOST_KIND
    index: int = 0
    memory_slots: int = 64


@dataclass
class OpContext:
    """What an operation implementation receives."""

    chunk: Any                       # DataChunk (payload = tile, request, ...)
    inputs: dict[str, Any]           # dep op name -> output value
    lane_kind: str = HOST_KIND

    def sole_input(self) -> Any:
        if len(self.inputs) == 1:
            return next(iter(self.inputs.values()))
        if not self.inputs:
            return self.chunk.payload
        raise ValueError(f"expected one input, have {sorted(self.inputs)}")


@dataclass
class _LaneState:
    spec: LaneSpec
    thread: Optional[threading.Thread] = None
    memory: Optional[DeviceMemory] = None
    busy_seconds: float = 0.0
    executed: int = 0
    busy: bool = False  # currently executing (work-conserving batching)
    # Prefetch double-buffer: next tuple whose inputs are being uploaded.
    staged: "queue.Queue[tuple[OperationInstance, threading.Event]]" = field(
        default_factory=lambda: queue.Queue(maxsize=1)
    )


class WorkerRuntime:
    """Executes stage instances over heterogeneous lanes."""

    def __init__(
        self,
        worker_id: int = 0,
        lanes: tuple[LaneSpec, ...] = (LaneSpec(HOST_KIND, 0),),
        *,
        policy: str = "fcfs",
        locality: bool = False,
        prefetch: bool = False,
        chaining: bool = False,
        micro_batch: int = 1,
        batch_budget: float | None = None,
        speedups_known: bool = True,
        staging: StagingConfig | None = None,
        variant_registry: VariantRegistry | None = None,
        on_stage_complete: Callable[..., None] | None = None,
        observe_runtimes: bool = True,
        on_heartbeat=None,
        registry: MetricsRegistry | None = None,
        tracer=None,
        recorder=None,
    ) -> None:
        self.worker_id = worker_id
        self.on_heartbeat = on_heartbeat
        self.registry = variant_registry or global_registry
        # One metrics registry per worker process: the scheduler, region
        # store, staging agent, and this runtime's own counters all
        # register into it, so ``stats()`` (and the ``get_stats`` RPC)
        # are thin views over a single place.
        self.metrics = registry or MetricsRegistry(f"worker{worker_id}")
        self.tracer = tracer          # telemetry.Tracer (optional)
        self.recorder = recorder      # telemetry.FlightRecorder (optional)
        # Device-resident chaining needs the DL pop (residency-aware) to
        # actually route dependents onto the holding lane.
        self.chaining = chaining
        self.locality = locality or chaining
        self.micro_batch = max(int(micro_batch), 1)
        # Adaptive micro-batch sizing: with a latency budget (seconds
        # one batched launch may take), per-op batch depth comes from
        # cost_model.optimal_micro_batch over the variant's observed
        # runtime instead of the static max_batch cap.
        self.batch_budget = batch_budget
        self.scheduler = ReadyScheduler(
            policy=policy,
            locality=self.locality,
            speedups_known=speedups_known,
            chain_affinity=1.0 if chaining else 0.0,
            registry=self.metrics,
        )
        self.prefetch = prefetch
        self.observe_runtimes = observe_runtimes
        self.on_stage_complete = on_stage_complete

        self._lanes = [
            _LaneState(
                spec=s,
                memory=DeviceMemory(s.memory_slots) if s.kind != HOST_KIND else None,
            )
            for s in lanes
        ]
        self._lock = threading.RLock()
        self._work_ready = threading.Condition(self._lock)
        self._stop = False
        self._failed = False

        # Hierarchical region store: the host tier replaces the old
        # ad-hoc output dict; disk/global tiers come from ``staging``.
        self.staging = staging
        self.store: RegionStore = (
            staging.build_store(registry=self.metrics)
            if staging is not None
            else RegionStore([HostTier()], registry=self.metrics)
        )
        # Cross-worker pull hooks, wired by the Manager (direct mode) or
        # a transport WorkerClient (bus mode).  ``fetch_regions`` is the
        # batched flavor: ordered keys in, same-length values out, one
        # round-trip for the lot.
        self.fetch_region: Callable[[Any], Any] | None = None
        self.fetch_regions: Callable[[list], list] | None = None
        self.agent: StagingAgent | None = None
        if staging is not None and staging.prefetch:
            self.agent = StagingAgent(
                self.store,
                worker_id=worker_id,
                fetch=self._fetch_region,
                fetch_batch=self._fetch_regions,
                on_staged=self._input_staged,
                watermark=staging.watermark,
                registry=self.metrics,
            )

        # Execution state.  ``_op_claimed`` marks ops a lane has popped
        # for execution: a revoked cancellation re-pushes its ops, and
        # the claim keeps the stale queue entry from running the op a
        # second time on another lane.
        self._op_done: set[int] = set()
        self._cancelled: set[int] = set()
        self._op_claimed: set[int] = set()
        self._stages: dict[int, StageInstance] = {}
        self.completion_order: list[int] = []
        self.errors: list[tuple[int, BaseException]] = []
        # Failure reporting: a stage whose op raised is reported upstream
        # exactly once (remaining ops cancelled), via the same callback
        # seam as completions.  ``on_op_start`` is a generic
        # instrumentation hook called as ``hook(runtime, op_instance)``
        # right before an op executes; raising from it routes into the
        # normal per-op failure path (fault harnesses plug in here — no
        # production code branches on "testing").
        self.on_stage_failed: Callable[[StageInstance, str], None] | None = None
        self.on_op_start: (
            Callable[["WorkerRuntime", OperationInstance], None] | None
        ) = None
        self._failed_stages: set[int] = set()
        # Device-resident chaining: op uid -> lane whose DeviceMemory
        # holds the *only* copy of its output (host write-back deferred
        # until a host-side consumer actually needs the bytes).
        self._device_only: dict[int, _LaneState] = {}
        c = lambda name: self.metrics.counter(f"worker.{name}")  # noqa: E731
        self.chain_hits = c("chain_hits")              # inputs served device-resident
        self.chain_deferred = c("chain_deferred")      # host copies skipped
        self.chain_writebacks = c("chain_writebacks")  # lazy downloads forced
        # Host-lane chaining: a CPU-produced intermediate whose consumers
        # are all known locally skips the region-store round-trip (lock +
        # tier accounting + pin/unpin churn) and is served by reference.
        self._host_chained: dict[int, Any] = {}
        self.host_chain_hits = c("host_chain_hits")             # served by reference
        self.host_chain_deferred = c("host_chain_deferred")     # store puts skipped
        self.host_chain_writebacks = c("host_chain_writebacks") # puts forced after all
        # Last speedup estimate a queue reorder was based on, per
        # variant: reestimate (O(queue)) only runs when the online EMA
        # actually moved an estimate, not on every completion.
        self._reorder_est: dict[str, float] = {}
        # Coordinator-bypass data plane: regions pushed here by siblings
        # (predictive push of sink outputs) before the lease's own pull.
        self.push_ingested = c("push_ingested")
        self.push_ingested_bytes = c("push_ingested_bytes")
        # Finished chunks' op outputs dropped (release_ops), and the
        # tensor bytes they held.
        self.released_chunks = c("released_chunks")
        self.released_bytes = c("released_bytes")
        # Trace context per leased stage: captured at submit time (the
        # TracingBus installs the sender's context around the handler)
        # and re-installed around op execution and the completion
        # callback, so a request's spans chain across the lane threads.
        self._stage_ctx: dict[int, SpanContext] = {}
        # Async-pull attribution: region key -> (ctx, perf t0, wall t0)
        # seeded when a traced lease requests prefetch, consumed when
        # the StagingAgent lands the region — the pull's true latency
        # shows up as a ``region:pull`` span on the request's trace
        # even though the transfer ran on the agent thread.
        self._pull_ctx: dict[Any, tuple[SpanContext, float, float]] = {}
        # Gray-failure signals (PR 9): per-worker op-runtime and
        # region-pull-latency distributions in the shared registry.
        # Unlike the tracer-gated _pull_ctx above, _pull_t0 is always
        # on — the health plane must see latency whether or not the
        # request was sampled (same 4096-entry bound).
        self.op_runtime_hist = self.metrics.histogram("worker.op_runtime_s")
        self.pull_latency_hist = self.metrics.histogram(
            "worker.pull_latency_s"
        )
        self._pull_t0: dict[Any, float] = {}
        # Per-stage *execution* seconds (sum of its ops' lane time,
        # queueing excluded) — reported with the completion so the
        # Manager's health ratio is not confounded by queue depth: a
        # probe lease on an empty queue and a lease behind a full
        # window must be judged on the same signal.
        self._stage_exec: dict[int, float] = {}
        # Lane tracing (telemetry/lanes.py): queue waits, the lanes
        # between ops, gc pauses; built only with a tracer.
        self._lanes_trace = LaneTrace(self) if tracer is not None else None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self.agent is not None:
            self.agent.start()
        for lane in self._lanes:
            t = threading.Thread(
                target=self._lane_loop, args=(lane,), daemon=True,
                name=f"worker{self.worker_id}-{lane.spec.kind}{lane.spec.index}",
            )
            lane.thread = t
            t.start()

    def stop(self) -> None:
        with self._lock:
            self._stop = True
            self._work_ready.notify_all()
        for lane in self._lanes:
            if lane.thread is not None:
                lane.thread.join(timeout=5.0)
        if self._lanes_trace is not None:
            self._lanes_trace.close()
        if self.agent is not None:
            self.agent.stop()

    def kill(self) -> None:
        """Simulate a node failure: lanes stop, state is lost."""
        with self._lock:
            self._failed = True
            self._stop = True
            self._work_ready.notify_all()
        if self.recorder is not None:
            # Postmortem: freeze the last N spans/events before the
            # process (or harness) tears the worker down.
            self.recorder.dump(
                "worker_crash", detail={"worker_id": self.worker_id}
            )
        if self.agent is not None:
            # A dead node must not keep pulling regions or mutating
            # execution state behind the Manager's back.
            self.agent.stop()

    @property
    def alive(self) -> bool:
        return not self._failed

    # -- submission -----------------------------------------------------------

    def submit_stage(self, si: StageInstance) -> None:
        """Lease received from the Manager: export fine-grain ops.

        Idempotent per stage instance: a re-lease of a stage this
        worker already holds (heartbeat-slander rejoin re-dispatches
        recovered leases) must not push duplicate op instances next to
        the queued/in-flight originals.
        """
        ctx = current_context()
        with self._lock:
            known = si.uid in self._stages
            self._stages[si.uid] = si
            if ctx is not None and ctx.sampled:
                sctx = self._stage_ctx.setdefault(si.uid, ctx)
                # Tag each op with its stage's context here, under the
                # lock, so the lane thread can read it without taking
                # the (contended) worker lock on the batch hot path.
                for oi in si.op_instances:
                    oi._trace_ctx = sctx  # type: ignore[attr-defined]
            local = {o.uid for o in si.op_instances}
            revoked = [
                oi for oi in si.op_instances if oi.uid in self._cancelled
            ]
            if revoked:
                # A re-lease of a stage this worker cancelled earlier
                # (probation entry or a drain re-queued it, and the
                # Manager handed it back — e.g. as a probe lease): the
                # cancellation is revoked and the ops requeue, else the
                # lease wedges with idle lanes until a hedge covers it.
                for oi in revoked:
                    self._cancelled.discard(oi.uid)
                    self._op_claimed.discard(oi.uid)
                    self._maybe_estimate(oi)
                    if (
                        oi.deps.issubset(self._op_done)
                        and oi.uid not in self._op_done
                    ):
                        self.scheduler.push(oi)
            if not known:
                for oi in si.op_instances:
                    self._maybe_estimate(oi)
                    if oi.deps.issubset(self._op_done) and oi.uid not in self._op_done:
                        self.scheduler.push(oi)
            self._work_ready.notify_all()
            missing = [
                op_key(dep)
                for oi in si.op_instances
                for dep in oi.deps
                if dep not in self._op_done and dep not in local
            ]
            if (
                missing
                and ctx is not None
                and ctx.sampled
                and self.tracer is not None
                and len(self._pull_ctx) < 4096
            ):
                now_p, now_w = time.perf_counter(), time.time()
                for key in missing:
                    self._pull_ctx.setdefault(key, (ctx, now_p, now_w))
            if missing and len(self._pull_t0) < 4096:
                t0 = time.perf_counter()
                for key in missing:
                    self._pull_t0.setdefault(key, t0)
        # Leased but not started: ask the staging agent to pull the
        # cross-stage inputs into the host tier ahead of execution.
        if self.agent is not None and missing:
            self.agent.request_prefetch(missing)

    def provide_input(self, uid: int, value: Any) -> None:
        """Host-side injection of upstream outputs (cross-worker flow)."""
        with self._lock:
            self.store.put(op_key(uid), value)
            self._op_done.add(uid)

    def forward_inputs(
        self, items: list[tuple]
    ) -> list[int]:
        """Batched input delivery: one control-plane round-trip for a
        whole lease's cross-stage inputs.

        Each item is ``(uid, value, push[, inbound])``: inputs already
        staged here are marked available (returned, so the Manager can
        account the bytes it did not re-send); the rest are injected
        when ``push`` is set, or left for the StagingAgent to pull when
        not.  ``inbound`` flags a key the Manager predicted a sibling
        will *push* here — the agent defers its pull for a grace period
        so the push and the prefetch don't cross the wire twice.
        """
        staged: list[int] = []
        expected: list[Any] = []
        for item in items:
            uid, value, push = item[0], item[1], item[2]
            inbound = bool(item[3]) if len(item) > 3 else False
            if self.mark_staged_input(uid):
                staged.append(uid)
            elif push:
                self.provide_input(uid, value)
            elif inbound:
                expected.append(op_key(uid))
        if expected and self.agent is not None:
            self.agent.expect_push(expected)
        return staged

    def ingest_push(self, key: Any, value: Any) -> int:
        """A sibling pushed a predicted input (data plane, coordinator
        bypassed): land it in the host tier and unlock any waiting ops.
        Returns the bytes landed (0 = rejected)."""
        if value is None:
            return 0
        nbytes = self.store.put(key, value)
        if isinstance(key, tuple) and len(key) == 2 and key[0] == "op":
            with self._lock:
                uid = key[1]
                if uid not in self._op_done:
                    self._op_done.add(uid)
                    self._release_dependents_locked(uid)
        self.push_ingested += 1
        self.push_ingested_bytes += nbytes
        return nbytes

    def invalidate_region(self, key: Any, worker_id: int | None = None) -> None:
        """Manager broadcast: ``worker_id`` no longer holds ``key`` —
        keep the staging agent's holder cache honest."""
        if self.agent is not None:
            self.agent.invalidate_holder(key, worker_id)

    def has_region(self, key: Any) -> bool:
        """True when ``key`` is resident in any tier of this worker
        (including device-only / host-chained outputs)."""
        if key in self.store:
            return True
        if isinstance(key, tuple) and len(key) == 2 and key[0] == "op":
            with self._lock:
                return key[1] in self._device_only or key[1] in self._host_chained
        return False

    def pull_region(self, key: Any) -> Any:
        """Serve a region to a remote peer (Manager failover refetch /
        directory-routed pull), materializing chained outputs."""
        with self._lock:
            value = self.store.get(key)
            if value is None and isinstance(key, tuple) and len(key) == 2 \
                    and key[0] == "op":
                value = self._materialize_locked(key[1])
            return value

    def mark_staged_input(self, uid: int) -> bool:
        """Skip-copy path: if op ``uid``'s output is already resident in
        a tier here, mark it available (and unlock waiting ops) so the
        Manager need not re-send the bytes.  False => caller must
        ``provide_input``."""
        with self._lock:
            if (
                op_key(uid) not in self.store
                and uid not in self._device_only
                and uid not in self._host_chained
            ):
                return False
            if uid not in self._op_done:
                self._op_done.add(uid)
                self._release_dependents_locked(uid)
            return True

    def _fetch_region(self, key: Any) -> Any:
        fetch = self.fetch_region
        return fetch(key) if fetch is not None else None

    def _fetch_regions(self, keys: list) -> Optional[list]:
        """Batched pull used by the StagingAgent; None => unwired, the
        agent falls back to per-key ``fetch`` round-trips."""
        fetch = self.fetch_regions
        return fetch(list(keys)) if fetch is not None else None

    def _input_staged(self, key: Any, nbytes: int = 0) -> None:
        """StagingAgent landed/promoted a region: unlock waiting ops."""
        if not (isinstance(key, tuple) and len(key) == 2 and key[0] == "op"):
            return
        uid = key[1]
        with self._lock:
            pulled = self._pull_ctx.pop(key, None)
            pull_t0 = self._pull_t0.pop(key, None)
            if uid in self._op_done:
                pulled = None  # duplicate landing: already accounted
                pull_t0 = None
            else:
                self._op_done.add(uid)
                self._release_dependents_locked(uid)
        if pull_t0 is not None:
            self.pull_latency_hist.observe(time.perf_counter() - pull_t0)
        if pulled is not None and self.tracer is not None:
            ctx, t0_perf, t0_wall = pulled
            sub = self.tracer.child(ctx)
            self.tracer.record_span(
                "region:pull",
                ctx=sub,
                parent=ctx.span_id,
                cat="region",
                ts=t0_wall,
                dur=time.perf_counter() - t0_perf,
                tid="staging",
                args={"key": uid, "bytes": int(nbytes)},
            )

    def _release_dependents_locked(self, produced_uid: int) -> None:
        for s in self._stages.values():
            for d in s.op_instances:
                if (
                    produced_uid in d.deps
                    and d.deps.issubset(self._op_done)
                    and d.uid not in self._op_done
                    and d.uid not in self._cancelled
                ):
                    self._maybe_estimate(d)
                    self.scheduler.push(d)
        self._work_ready.notify_all()

    def cancel_stage(self, si_uid: int) -> None:
        with self._lock:
            si = self._stages.get(si_uid)
            if si is None:
                return
            for oi in si.op_instances:
                if oi.uid not in self._op_done:
                    self._cancelled.add(oi.uid)
            self._stage_exec.pop(si_uid, None)

    def _accel_kind(self) -> str:
        accel_kinds = {l.spec.kind for l in self._lanes} - {HOST_KIND}
        return next(iter(accel_kinds)) if accel_kinds else HOST_KIND

    def _maybe_estimate(self, oi: OperationInstance) -> None:
        try:
            var = self.registry.get(oi.op.variant_name)
        except KeyError:
            return
        oi.speedup = var.estimate_speedup(self._accel_kind(), oi.chunk.meta)
        oi.transfer_impact = var.transfer_impact

    def _estimate_of(self, oi: OperationInstance) -> float:
        """Current speedup estimate (for ReadyScheduler.reestimate)."""
        try:
            var = self.registry.get(oi.op.variant_name)
        except KeyError:
            return oi.speedup
        return var.estimate_speedup(self._accel_kind(), oi.chunk.meta)

    # -- idle / completion tracking -----------------------------------------

    def drain(self, timeout: float = 60.0) -> bool:
        """Block until all submitted work completed (or timeout)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                pending = any(
                    oi.uid not in self._op_done and oi.uid not in self._cancelled
                    for si in self._stages.values()
                    for oi in si.op_instances
                )
                if self.errors:
                    return False
                if not pending:
                    return True
            time.sleep(0.002)
        return False

    def stats(self) -> dict[str, Any]:
        return {
            "profile": self.scheduler.stats.profile(),
            "reuse_hits": int(self.scheduler.stats.reuse_hits),
            "reuse_misses": int(self.scheduler.stats.reuse_misses),
            "lane_busy": {
                f"{l.spec.kind}{l.spec.index}": l.busy_seconds for l in self._lanes
            },
            "executed": sum(l.executed for l in self._lanes),
            "uploads": sum(
                l.memory.uploads for l in self._lanes if l.memory is not None
            ),
            "downloads": sum(
                l.memory.downloads for l in self._lanes if l.memory is not None
            ),
            "device_evictions": sum(
                l.memory.evictions for l in self._lanes if l.memory is not None
            ),
            "chain_hits": int(self.chain_hits),
            "chain_deferred": int(self.chain_deferred),
            "chain_writebacks": int(self.chain_writebacks),
            "host_chain_hits": int(self.host_chain_hits),
            "host_chain_deferred": int(self.host_chain_deferred),
            "host_chain_writebacks": int(self.host_chain_writebacks),
            "batches": int(self.scheduler.stats.batches),
            "batched_ops": int(self.scheduler.stats.batched_ops),
            "push_ingested": int(self.push_ingested),
            "push_ingested_bytes": int(self.push_ingested_bytes),
            "released_chunks": int(self.released_chunks),
            "released_bytes": int(self.released_bytes),
            "staging": self.store.stats(),
            "prefetch": self.agent.stats() if self.agent is not None else {},
        }

    def output_of(self, oi_uid: int) -> Any:
        with self._lock:
            value = self.store.get(op_key(oi_uid))
            if value is None:
                value = self._materialize_locked(oi_uid)
            return value

    def release_ops(self, chunk: Any, uids: list[int]) -> int:
        """Drop every reference this runtime holds to the outputs of op
        instances ``uids``, whose chunk the Manager saw finish (no lease
        can read them again; ``core/release.py``): host tier, lanes'
        device memory, the chained maps.  Returns the tensor bytes
        dropped; a ``release`` span where traced."""
        ts, t0 = time.time(), time.perf_counter()
        held: list[Any] = []
        with self._lock:
            for uid in uids:
                key = op_key(uid)
                if key in self.store:
                    held.append(self.store.get(key))
                    self.store.unpin(key)
                    self.store.discard(key)
                for lane in self._lanes:
                    if lane.memory is not None and uid in lane.memory:
                        held.append(lane.memory.discard(uid))
                self._device_only.pop(uid, None)
                held.append(self._host_chained.pop(uid, None))
            released = any(v is not None for v in held)
            nbytes = tensor_bytes(held)
            if released:
                self.released_chunks += 1
                self.released_bytes += nbytes
        del held
        if released and self.tracer is not None:
            record_release(self.tracer, ts, time.perf_counter() - t0, chunk, nbytes)
        return nbytes

    # -- lane main loop -----------------------------------------------------------

    def _lane_loop(self, lane: _LaneState) -> None:
        while True:
            with self._lock:
                lane.busy = False
                while not self._stop and not self.scheduler:
                    self._work_ready.wait(timeout=0.25)
                if self._stop:
                    return
                resident = (
                    lane.memory.resident_uids()
                    if lane.memory is not None and self.locality
                    else None
                )
                if self.micro_batch > 1 and lane.memory is not None:
                    idle = sum(
                        1
                        for l in self._lanes
                        if l.memory is not None and not l.busy
                    )
                    limit = self.scheduler.batch_limit(self.micro_batch, idle)
                    ois = self.scheduler.pop_batch(
                        lane.spec.kind,
                        resident,
                        limit=limit,
                        batchable=self._batch_limit,
                    )
                else:
                    oi = self.scheduler.pop(lane.spec.kind, resident)
                    ois = [oi] if oi is not None else []
                ois = [
                    oi
                    for oi in ois
                    if oi is not None
                    and oi.uid not in self._cancelled
                    and oi.uid not in self._op_done
                    and oi.uid not in self._op_claimed
                ]
                for oi in ois:
                    self._op_claimed.add(oi.uid)
                if ois:
                    lane.busy = True
            if not ois:
                continue
            if self._lanes_trace is not None:
                self._lanes_trace.started(lane, ois)
            try:
                self._run_batch(lane, ois)
            except BaseException as exc:  # noqa: BLE001 - recorded, not raised
                self._record_failures([(oi, exc) for oi in ois])

    def _batch_limit(self, oi: OperationInstance) -> int:
        """pop_batch cap: the variant's declared max batch (1 = scalar).

        With a ``batch_budget`` the cap adapts per op: the largest batch
        whose single-launch latency (observed per-instance runtime x B)
        still fits the budget — ``cost_model.optimal_micro_batch`` —
        so fast ops batch deep and slow ops stay responsive, instead of
        one config constant serving both.
        """
        try:
            var = self.registry.get(oi.op.variant_name)
        except KeyError:
            return 1
        cap = var.max_batch if var.batchable else 1
        if cap <= 1 or self.batch_budget is None:
            return cap
        per_item = var.expected_runtime(self._accel_kind())
        if per_item is None:
            return cap  # nothing observed yet: static cap until then
        return max(
            1,
            optimal_micro_batch(
                op_cost_from_seconds(per_item),
                TPU_V5E,
                launch_overhead=0.0,
                latency_budget=self.batch_budget,
                max_batch=cap,
            ),
        )

    def _run_batch(self, lane: _LaneState, ois: list[OperationInstance]) -> None:
        """Execute one dispatch decision: a single op or a micro-batch
        of same-op instances (one batched call, amortized launch)."""
        var = self.registry.get(ois[0].op.variant_name)
        ts_wall = time.time()
        t0 = time.perf_counter()
        ctxs = [
            OpContext(
                chunk=oi.chunk,
                inputs=self._gather_inputs(lane, oi),
                lane_kind=lane.spec.kind,
            )
            for oi in ois
        ]
        batch_fn = (
            var.batch_implementation(lane.spec.kind) if len(ois) > 1 else None
        )
        failures: list[tuple[OperationInstance, BaseException]] = []
        if batch_fn is not None:
            for oi in ois:
                self._hook_op_start(oi)
            outs = batch_fn(ctxs)
            if len(outs) != len(ctxs):
                raise RuntimeError(
                    f"batch implementation of {var.name!r} returned "
                    f"{len(outs)} outputs for {len(ctxs)} contexts"
                )
            pairs = list(zip(ois, outs))
        else:
            # Scalar loop: isolate failures to the failing chunk so one
            # malformed tile cannot poison its batch-mates' results.
            impl = var.implementation(lane.spec.kind)
            pairs = []
            for oi, ctx in zip(ois, ctxs):
                try:
                    self._hook_op_start(oi)
                    pairs.append((oi, impl(ctx)))
                except BaseException as exc:  # noqa: BLE001 - recorded
                    failures.append((oi, exc))
        elapsed = time.perf_counter() - t0
        if self._lanes_trace is not None:
            self._lanes_trace.ended(ts_wall + elapsed, t0 + elapsed)
        lane.busy_seconds += elapsed
        lane.executed += len(ois)
        self.op_runtime_hist.observe(elapsed / len(ois))
        with self._lock:
            per_op = elapsed / len(ois)
            for oi in ois:
                suid = oi.stage_instance.uid
                self._stage_exec[suid] = (
                    self._stage_exec.get(suid, 0.0) + per_op
                )
        if self.tracer is not None:
            # One span per op instance (batch-mates share ts/dur): each
            # chains under its own stage's context so a request timeline
            # shows exactly which lane ran which op, and when.  The ctx
            # tag was written by submit_stage under the worker lock
            # before the op could queue, so the lock-free read here is
            # safe; unsampled ops carry no tag and cost one getattr.
            tid = None
            for oi in ois:
                sctx = getattr(oi, "_trace_ctx", None)
                if sctx is None:
                    continue
                if tid is None:
                    tid = f"{lane.spec.kind}{lane.spec.index}"
                sub = self.tracer.child(sctx)
                self.tracer.record_span(
                    f"op:{oi.op.name}",
                    ctx=sub,
                    parent=sctx.span_id,
                    cat="op",
                    ts=ts_wall,
                    dur=elapsed,
                    tid=tid,
                    args={"uid": oi.uid, "batch": len(ois)},
                )
        if self.observe_runtimes:
            var.observe_runtime(lane.spec.kind, elapsed / len(ois))
            if self.scheduler.policy == "pats":
                # Keep the ready queue consistent with the shifted EMA —
                # but only pay the O(queue) re-sort when the estimate
                # materially moved (PATS only needs relative order).
                est = var.estimate_speedup(
                    self._accel_kind(), ois[0].chunk.meta
                )
                last = self._reorder_est.get(var.name)
                if last is None or abs(est - last) > 0.1 * max(last, 1e-9):
                    self._reorder_est[var.name] = est
                    with self._lock:
                        self.scheduler.reestimate(self._estimate_of)
        for oi, out in pairs:
            self._commit(lane, oi, out)
        self._record_failures(failures)

    def _hook_op_start(self, oi: OperationInstance) -> None:
        hook = self.on_op_start
        if hook is not None:
            hook(self, oi)

    def _record_failures(
        self, failures: list[tuple[OperationInstance, BaseException]]
    ) -> None:
        """Record op failures and report each newly-failed stage upstream
        exactly once.  The stage's remaining ops are cancelled — a failed
        stage can never complete, so leaving them queued only wastes
        lanes — and ``on_stage_failed`` fires with the worker lock
        released (lock order is manager -> worker).  A killed worker does
        not report: death attribution is the Manager's job."""
        if not failures:
            return
        report: list[tuple[StageInstance, BaseException]] = []
        with self._lock:
            for oi, exc in failures:
                self.errors.append((oi.uid, exc))
                si = oi.stage_instance
                if si.uid in self._failed_stages:
                    continue
                self._failed_stages.add(si.uid)
                for o in si.op_instances:
                    if o.uid not in self._op_done:
                        self._cancelled.add(o.uid)
                report.append((si, exc))
            self._work_ready.notify_all()
        if not self.alive or self.on_stage_failed is None:
            return
        for si, exc in report:
            try:
                self.on_stage_failed(si, f"{type(exc).__name__}: {exc}")
            except Exception:  # noqa: BLE001 - reporting is best-effort
                pass

    def _gather_inputs(self, lane: _LaneState, oi: OperationInstance) -> dict[str, Any]:
        """Upload phase: pull dep outputs into this lane's memory.

        Deps already resident in *this* lane's DeviceMemory take the
        chained fast path: no host-tier read, no re-upload.  Deps held
        device-only by a sibling lane are downloaded (materialized to
        the host tier) first — the classic cross-device route.
        """
        fetch_uids: list[int] = []
        with self._lock:
            dep_objs: list[tuple[int, Any]] = []
            for uid in sorted(oi.deps):
                if lane.memory is not None and uid in lane.memory:
                    # Device-resident fast path: skip host materialization.
                    # (Counter gated on chaining: plain-DL residency
                    # reuse must not contaminate the chaining stats.)
                    if self.chaining:
                        self.chain_hits += 1
                    dep_objs.append((uid, lane.memory.get(uid)))
                    continue
                if self.chaining and uid in self._host_chained:
                    # Host-resident chained fast path: the producer ran
                    # on a host lane and deferred the region-store write;
                    # serve the value by reference, no tier churn.
                    self.host_chain_hits += 1
                    dep_objs.append((uid, self._host_chained[uid]))
                    continue
                # Host-side read through the region store (promotes from
                # a slow tier if the StagingAgent has not gotten there
                # yet), falling back to a sibling lane's device memory.
                value = self.store.get(op_key(uid), promote=True)
                if value is None:
                    value = self._materialize_locked(uid)
                if value is None:
                    fetch_uids.append(uid)
                dep_objs.append((uid, value))
        # An input marked available but since evicted (soft tier budgets)
        # is re-pulled from the Manager synchronously.  Deliberately
        # outside self._lock: the fetch takes the Manager's lock, and the
        # Manager calls into this worker while holding it (lock order is
        # always manager -> worker).
        if fetch_uids:
            sctx = None
            if self.tracer is not None:
                with self._lock:
                    sctx = self._stage_ctx.get(oi.stage_instance.uid)
            ts_wall = time.time()
            t_fetch = time.perf_counter()
            fetched = {uid: self._fetch_region(op_key(uid)) for uid in fetch_uids}
            self.pull_latency_hist.observe(time.perf_counter() - t_fetch)
            if sctx is not None:
                sub = self.tracer.child(sctx)
                self.tracer.record_span(
                    "region:pull",
                    ctx=sub,
                    parent=sctx.span_id,
                    cat="region",
                    ts=ts_wall,
                    dur=time.perf_counter() - t_fetch,
                    tid=f"{lane.spec.kind}{lane.spec.index}",
                    args={"keys": len(fetch_uids)},
                )
            dep_objs = [
                (uid, v if v is not None else fetched.get(uid))
                for uid, v in dep_objs
            ]
            with self._lock:
                # Resolved synchronously: retire any async-pull
                # attribution so the agent's later landing (if any)
                # does not double-count the transfer.
                for uid in fetch_uids:
                    self._pull_ctx.pop(op_key(uid), None)
                    self._pull_t0.pop(op_key(uid), None)
        inputs: dict[str, Any] = {}
        with self._lock:
            for uid, value in dep_objs:
                if value is None:
                    continue
                name = self._dep_name(oi, uid)
                if lane.memory is not None:
                    if uid not in lane.memory:
                        lane.memory.uploads += 1
                        self._device_put_locked(lane, uid, value)
                    inputs[name] = lane.memory.get(uid)
                else:
                    inputs[name] = value
        return inputs

    def _device_put_locked(self, lane: _LaneState, uid: int, value: Any) -> None:
        """Insert into a lane's device memory, writing any evicted
        device-only outputs back to the host tier (slot budgets are a
        soft cap, never a correctness hazard)."""
        for e_uid, e_val in lane.memory.put(uid, value):
            if self._device_only.pop(e_uid, None) is not None:
                lane.memory.downloads += 1
                self.chain_writebacks += 1
                self.store.put(op_key(e_uid), e_val)
                # Same invariant as _commit/_materialize: keep the only
                # host copy resident until its consumers ran.
                self.store.pin(op_key(e_uid))

    def _materialize_locked(self, uid: int) -> Any:
        """Move a chained output (device-only or host-chained) into the
        host tier so host-side consumers and remote pulls can read it."""
        if uid in self._host_chained:
            value = self._host_chained.pop(uid)
            self.host_chain_writebacks += 1
            self.store.put(op_key(uid), value)
            self.store.pin(op_key(uid))
            return value
        holder = self._device_only.get(uid)
        if holder is None or holder.memory is None or uid not in holder.memory:
            return None
        value = holder.memory.get(uid)
        del self._device_only[uid]
        holder.memory.downloads += 1
        self.chain_writebacks += 1
        self.store.put(op_key(uid), value)
        self.store.pin(op_key(uid))
        return value

    def _dep_name(self, oi: OperationInstance, dep_uid: int) -> str:
        # Wiring-time name map: correct even when this worker never saw
        # the producing stage (data-plane pull / predictive push).
        name = oi.dep_names.get(dep_uid)
        if name is not None:
            return name
        si = oi.stage_instance
        for other in si.op_instances:
            if other.uid == dep_uid:
                return other.op.name
        # Cross-stage dep: find in any known stage.
        for s in self._stages.values():
            for other in s.op_instances:
                if other.uid == dep_uid:
                    return other.op.name
        return f"dep_{dep_uid}"

    def _chainable_locked(self, oi: OperationInstance) -> bool:
        """Defer the host write-back?  Only when every consumer of this
        output is known locally — a chained intermediate is then served
        straight from device memory (or lazily downloaded on a sibling
        lane / stage-completion read)."""
        if not self.chaining or not oi.dependents:
            return False
        for dep_uid in oi.dependents:
            if dep_uid in self._cancelled:
                return False
            if self._find_op(dep_uid) is None:
                return False
        return True

    def _commit(self, lane: _LaneState, oi: OperationInstance, out: Any) -> None:
        with self._lock:
            chained = False
            host_chained = False
            if lane.memory is not None:
                self._device_put_locked(lane, oi.uid, out)
                chained = self._chainable_locked(oi)
                if not chained and not self.locality:
                    lane.memory.downloads += 1  # basic mode: always download
            elif self.chaining and self._chainable_locked(oi):
                # Chained CPU lane: every consumer is known locally, so
                # the intermediate skips the region-store round-trip
                # (lock + tier accounting + pin churn) entirely.
                host_chained = True
            if chained:
                # Resident fast path: the intermediate never touches the
                # host tier unless a host-side consumer materializes it.
                self._device_only[oi.uid] = lane
                self.chain_deferred += 1
            elif host_chained:
                self._host_chained[oi.uid] = out
                self.host_chain_deferred += 1
            else:
                self.store.put(op_key(oi.uid), out)  # host write-back (download)
                # Keep the output resident until its consumers (and the
                # stage-completion read below) ran: tier budgets are a
                # soft cap for the live working set, never a correctness
                # hazard.
                self.store.pin(op_key(oi.uid))
            self._op_done.add(oi.uid)
            self.completion_order.append(oi.uid)
            si = oi.stage_instance
            for dep_uid in sorted(oi.dependents):
                d = self._find_op(dep_uid)
                if (
                    d is not None
                    and d.deps.issubset(self._op_done)
                    and dep_uid not in self._op_done
                    and dep_uid not in self._cancelled
                ):
                    self._maybe_estimate(d)
                    self.scheduler.push(d)
            # A producer whose local consumers all finished may be
            # evicted again (cross-worker consumers are re-fed by the
            # Manager from its own output copy if needed).
            for dep_uid in oi.deps:
                self._maybe_unpin_locked(dep_uid)
            stage_done = all(
                o.uid in self._op_done or o.uid in self._cancelled
                for o in si.op_instances
            )
            sctx = self._stage_ctx.pop(si.uid, None) if stage_done else None
            exec_s = self._stage_exec.pop(si.uid, None) if stage_done else None
            self._work_ready.notify_all()
        # Callbacks into the Manager happen with the worker lock
        # released: lock order is always manager -> worker, never the
        # reverse (the Manager calls submit/provide/mark under its own
        # lock, so calling it while holding ours would deadlock).
        if self.on_heartbeat is not None:
            self.on_heartbeat(self.worker_id)
        if stage_done and self.on_stage_complete is not None:
            with self._lock:
                # Only sink outputs cross the host boundary (the
                # Manager forwards them to dependents / other workers):
                # those are downloaded for real.  Chained intermediates
                # never touch the host tier — the callback still
                # carries the in-process reference (this runtime holds
                # device values in host RAM anyway), but no download is
                # modeled and tracking ends so the device LRU can age
                # them out without a write-back.
                sinks = set(si.stage.sinks())
                outputs: dict[str, Any] = {}
                for o in si.op_instances:
                    holder = self._device_only.get(o.uid)
                    if holder is None and o.uid in self._host_chained:
                        if o.op.name in sinks:
                            # Sinks cross the worker boundary: land them
                            # in the host tier for directory pulls.
                            outputs[o.op.name] = self._materialize_locked(o.uid)
                        else:
                            # Intermediate: consumers all ran; hand the
                            # reference over and end tracking.
                            outputs[o.op.name] = self._host_chained.pop(o.uid)
                    elif holder is None:
                        outputs[o.op.name] = self.store.get(op_key(o.uid))
                    elif o.op.name in sinks:
                        outputs[o.op.name] = self._materialize_locked(o.uid)
                    else:
                        del self._device_only[o.uid]
                        mem = holder.memory
                        outputs[o.op.name] = (
                            mem.get(o.uid)
                            if mem is not None and o.uid in mem
                            else None
                        )
                for o in si.op_instances:
                    self._maybe_unpin_locked(o.uid)
            # Re-install the stage's trace context around the completion
            # callback: the stage_complete RPC (and any pushes the
            # Manager derives from it) then carries the request's trace.
            with use_context(sctx):
                self.on_stage_complete(si, outputs, exec_s)

    def _maybe_unpin_locked(self, uid: int) -> None:
        """Unpin ``uid``'s output once no locally-known op still needs it."""
        oi = self._find_op(uid)
        if oi is None:
            return
        if all(
            u in self._op_done or u in self._cancelled or self._find_op(u) is None
            for u in oi.dependents
        ):
            self.store.unpin(op_key(uid))

    def _find_op(self, uid: int) -> Optional[OperationInstance]:
        for s in self._stages.values():
            for oi in s.op_instances:
                if oi.uid == uid:
                    return oi
        return None
