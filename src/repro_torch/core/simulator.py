"""Deterministic discrete-event simulator of the middleware on a cluster.

The container has one CPU core; the paper's experiments use 100 nodes
with 12 cores + 3 GPUs each.  To evaluate the *scheduling* behaviour at
that scale we simulate time while making every scheduling decision with
the production scheduler code (:mod:`repro.core.scheduling`) and the
production workflow graphs (:mod:`repro.core.workflow`).  Operation
durations come from the calibrated workload model
(:mod:`repro.core.calibration`), with deterministic per-chunk
variability.

Modeled effects (paper section in parens):

* demand-driven Manager with per-worker window (III-B, V-F),
* FCFS / PATS queues, DL locality, function variants (IV-B, IV-C),
* upload/process/download phases, prefetch & async copy (IV-D),
* Closest vs OS control-thread placement (IV-A, V-C),
* multi-core memory-bandwidth contention (V-D: 12 cores -> ~9x),
* shared parallel filesystem with aggregate bandwidth cap (V-H),
* node failures (heartbeat + re-lease) and stragglers (backup tasks)
  — beyond-paper fault-tolerance features of this framework.
"""

from __future__ import annotations

import bisect
import heapq
import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np

from . import calibration as cal
from .cost_model import TPU_V5E, op_cost_from_seconds, optimal_micro_batch
from .network import FluidNetwork, build_network
from .scheduling import HOST_KIND, ReadyScheduler
from ..staging import PlacementDirectory
from .workflow import (
    AbstractWorkflow,
    ConcreteWorkflow,
    DataChunk,
    Operation,
    OperationInstance,
    Stage,
    StageInstance,
)

__all__ = [
    "SimConfig",
    "SimResult",
    "ClusterSim",
    "segmentation_feature_workflow",
    "monolithic_workflow",
    "make_tiles",
    "run_simulation",
]

ACCEL_KIND = "gpu"


# --------------------------------------------------------------------------
# Workflow builders for the flagship application
# --------------------------------------------------------------------------


def segmentation_feature_workflow(fused: bool = False) -> AbstractWorkflow:
    """Two-level hierarchical pipeline of Fig 1/2 (pipelined version).

    With ``fused=True`` the feature fan-out substitutes the fused
    megakernel op for color_deconv + pixel_stats + gradient_stats
    (one HBM read; see ``kernels/feature_fused``), keeping the
    remaining feature ops downstream of it.
    """
    seg_ops = [
        Operation(name, inputs=("tile",), outputs=(name,))
        for name in cal.PIPELINE_ORDER
        if cal.OP_PROFILES[name].stage == "segmentation"
    ]
    if fused:
        rest = tuple(
            n for n in cal.PARALLEL_FEATURE_OPS if n not in cal.FUSED_FEATURE_OPS
        )
        feat_ops = [
            Operation("feature_fused", inputs=("mask",), outputs=("deconv",))
        ] + [
            Operation(name, inputs=("deconv",), outputs=(name,))
            for name in rest
        ]
        feat_edges = tuple(("feature_fused", name) for name in rest)
    else:
        feat_ops = [
            Operation("color_deconv", inputs=("mask",), outputs=("deconv",))
        ] + [
            Operation(name, inputs=("deconv",), outputs=(name,))
            for name in cal.PARALLEL_FEATURE_OPS
        ]
        feat_edges = tuple(
            ("color_deconv", name) for name in cal.PARALLEL_FEATURE_OPS
        )
    return AbstractWorkflow.chain(
        "wsi-analysis",
        [
            Stage.chain("segmentation", seg_ops),
            Stage("features", tuple(feat_ops), feat_edges),
        ],
    )


def monolithic_workflow() -> AbstractWorkflow:
    """Non-pipelined version: the whole tile is one task (§V-D)."""
    op = Operation("monolithic", inputs=("tile",), outputs=("features",))
    return AbstractWorkflow.chain("wsi-monolithic", [Stage.single(op)])


def make_tiles(n: int, seed: int = 0) -> list[DataChunk]:
    """Synthetic tile descriptors with deterministic workload variability."""
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.8, 1.2, size=n)  # foreground-density proxy
    return [
        DataChunk(chunk_id=i, meta={"work_scale": float(scale[i])})
        for i in range(n)
    ]


# --------------------------------------------------------------------------
# Configuration / results
# --------------------------------------------------------------------------


@dataclass
class SimConfig:
    n_nodes: int = 1
    node: cal.NodeConfig = field(default_factory=lambda: cal.KEENELAND_NODE)
    n_gpus: int | None = None          # override node.n_gpus
    n_cpu_cores: int | None = None     # override compute cores (excl. ctrl)
    policy: str = "pats"               # "fcfs" | "pats"
    locality: bool = False             # DL (§IV-C)
    prefetch: bool = False             # §IV-D
    # Device-resident chaining: implies locality and gives resident
    # dependents the chain-affinity bonus in the DL rule.
    chaining: bool = False
    # Micro-batched dispatch: an idle accelerator lane pops up to this
    # many ready instances of the same batchable op per decision and
    # executes them as one launch (cost_model.batched_runtime).
    micro_batch: int = 1
    # Adaptive micro-batch sizing: per-op batch depth from the cost
    # model's latency-budget curve (cost_model.optimal_micro_batch) —
    # the largest batch whose single-launch latency fits the budget —
    # with ``micro_batch`` as the hard cap.  Fast ops batch deep, slow
    # ops stay responsive, instead of one constant serving both.
    adaptive_batch: bool = False
    batch_latency_budget: float = 0.5
    # Fixed per-dispatch cost of an accelerator kernel launch (driver /
    # JIT dispatch / MPI control round).  Paid once per (batched) call.
    launch_overhead: float = 0.0
    # Substitute the fused feature megakernel op for the fused group.
    fused_features: bool = False
    placement: str = "closest"         # "closest" | "os" (§IV-A)
    window: int = 15                   # stage instances per worker (§V-F)
    pipelined: bool = True             # False => monolithic tasks
    speedups_known: bool = True
    speedup_error: float = 0.0         # §V-G protocol, 0..1
    include_io: bool = True
    gpu_memory_slots: int = 48         # LRU residency capacity per GPU
    dispatch_latency: float = 0.002    # Manager round-trip (MPI)
    seed: int = 0
    # Fault tolerance / stragglers (beyond-paper features).
    fail_node_at: Optional[tuple[int, float]] = None  # (node_id, time)
    heartbeat_timeout: float = 5.0
    straggler_factor: dict[int, float] = field(default_factory=dict)
    backup_tasks: bool = False         # duplicate tail leases
    # -- gray-failure resilience mirror (repro.core.manager) --------------
    # Windowed degradation that onsets AND heals: node_id -> (t0, t1,
    # factor) multiplies that node's op cpu time while t0 <= now < t1
    # (composes with straggler_factor) — the sim twin of
    # FaultPlan.op_hook(slow_between=...).
    slow_between: dict[int, tuple[float, float, float]] = field(
        default_factory=dict
    )
    # Health-scored dispatch: per-node EMA of observed/expected stage
    # runtime scales the node's lease window; persistently slow nodes
    # enter probation (window 1) and rejoin at full weight once probe
    # completions land near the expected runtime again.
    health_scoring: bool = False
    health_alpha: float = 0.35
    probation_ratio: float = 3.0
    probation_recover_ratio: float = 2.0
    probation_min_samples: int = 3
    probation_after_hedges: int = 2
    # Percentile hedging: a lease whose age exceeds its stage's p99
    # completed duration x this slack gets a hedge twin on the
    # healthiest node with window headroom — first completion wins via
    # the backup-task twin-cancel path.  None = off.
    hedge_slack: Optional[float] = None
    hedge_min_samples: int = 8
    # Feasibility-aware overload shedding (serving mode): shed exactly
    # the arrivals whose deadline fails an EDF schedulability test
    # against the measured service-time percentile and the backlog of
    # equal-or-earlier deadlines ahead — instead of (or on top of) the
    # blind admission_queue_cap depth shed.
    shed_feasibility: bool = False
    feasibility_pct: float = 0.99
    feasibility_min_samples: int = 8
    # Slack-aware EDF band in every node's ReadyScheduler: strict EDF
    # preempts locality order only for deadlines within this many
    # seconds of the sim clock; unhurried deadline work falls through
    # to the locality/PATS tier.  None = strict EDF (seed behaviour).
    edf_slack_band: Optional[float] = None
    # -- fault-injection mirror (repro.faults) ----------------------------
    # The same knobs the runtime's FaultPlan exposes, so a schedule
    # validated in simulation transfers to the threaded runtime.
    # ``crash_at`` is the runtime-named alias of ``fail_node_at``.
    crash_at: Optional[tuple[int, float]] = None
    # Probability a control-plane message is lost in flight; the sender
    # retransmits after a RetryPolicy-style backoff (counted in
    # SimResult.msg_retries, latency charged to rpc_wait).
    msg_drop_rate: float = 0.0
    # Probability a cross-node region copy lands corrupted; the CRC
    # check catches it and the copy is re-issued once (counted in
    # SimResult.corrupt_detected, latency doubles for that transfer).
    corrupt_rate: float = 0.0
    # Control-plane partition: ``(node_ids, t_start, t_end)`` — the
    # named nodes receive no new leases while the window is open (their
    # running work continues; heals at ``t_end``).
    partition: Optional[tuple[tuple[int, ...], float, float]] = None
    # Hierarchical data staging (repro.staging): model inter-node tier
    # copy costs; optionally consult the placement directory so leases
    # go where the input bytes already live.  Off by default (the seed
    # model treats cross-node staging as free).
    staging: bool = False              # charge cross-node staging copies
    staging_locality: bool = True      # directory-driven lease placement
    stage_output_mb: float = 48.0      # inter-stage region per tile (MB)
    interconnect_gb_s: float = 6.0     # per-NIC link bandwidth (GB/s)
    # Per-link network topology (repro.core.network).  "flat" is the
    # non-blocking single tier; "fat_tree" groups nodes into racks of
    # ``rack_size`` behind shared uplinks of
    # ``rack_size * interconnect_gb_s / oversubscription`` capacity.
    # Every transfer serializes on its source NIC, any uplinks on the
    # path, and the destination NIC — so link contention, not just
    # destination ingress, shapes staging delays.
    network: str = "flat"              # "flat" | "fat_tree"
    rack_size: Optional[int] = None    # nodes per rack (default: node.rack_size)
    oversubscription: float = 4.0      # uplink tier oversubscription ratio
    # Transfer engine for cross-node region traffic (cfg.staging):
    # "event" (default) moves bytes as fluid flows on first-class
    # NetworkLink objects — every active flow gets its max-min fair
    # share and is re-rated on any flow start/finish, so fat-tree
    # uplink contention is honest (progressive filling).  "tick" keeps
    # the legacy store-and-forward reservation model (each transfer
    # holds whole links back-to-back) for differential testing.
    engine: str = "event"              # "event" | "tick"
    # Rack-locality placement bonus: when scoring a pending stage for a
    # node, bytes held by same-rack siblings count at this weight on
    # top of the node-local fraction (0 = rack-blind placement).  Only
    # meaningful with staging_locality on a racked network.  The string
    # "auto" derives the bonus online from measured uplink vs NIC busy
    # time (congested uplinks -> strong rack preference; idle fabric ->
    # none), closing the loop the way adaptive_batch does for batching.
    rack_affinity: float | str = 0.0
    # Data-plane flow control mirror: cap on predictive-push bytes in
    # flight toward any single node's ingress.  A push that would
    # overflow the target's cap is skipped (counted in pushes_capped;
    # the dependent's own pull remains the backstop) — the same knob
    # ManagerConfig.push_inflight_cap_bytes applies on the wire.
    push_inflight_cap_bytes: Optional[int] = None
    # Coordinator-bypass data plane (PR4).  With direct_transfer,
    # inter-node region copies flow worker-to-worker (the runtime's
    # peer-dial path) and serialize only on the destination NIC;
    # without it every byte relays through the coordinator, whose NIC
    # carries it twice (in + out) and is shared by ALL nodes — the
    # per-PR3 wire reality, and the bottleneck at scale.
    direct_transfer: bool = True
    # Predictive push: at stage completion the predicted next holder's
    # copy starts immediately (agent-driven push), so the dependent's
    # first-touch transfer is hidden behind the lease round-trip.
    predictive_push: bool = False
    # Control-plane cost model (repro.transport): every Manager/Worker
    # message — lease dispatch, completion notify, staging pull request
    # — pays one bus round-trip of this latency.  0 (default) keeps the
    # seed behavior where coordination is structurally free; set it to
    # a measured SocketBus round-trip to re-read locality/chaining
    # results with non-zero coordination cost.
    rpc_latency_us: float = 0.0
    # Batched staging fetches: a stage's missing inputs are pulled as
    # one coalesced request (one rpc latency per batch) instead of one
    # request per key — the transport-level analog of micro-batching.
    batch_prefetch: bool = True
    # -- serving mode (mirror of repro.serving) ---------------------------
    # With arrival_rate set the sim runs open-loop: requests arrive on a
    # Poisson clock (per tenant) over Zipf-popular tiles, flow through a
    # simulated gateway (admission + weighted fair queueing) and are
    # instantiated into the live workflow on dispatch — the batch
    # seeding of ``run()`` is skipped.  Latency percentiles come out in
    # SimResult.  ``None`` (default) keeps the batch behaviour.
    arrival_rate: Optional[float] = None   # requests/second PER TENANT
    serve_duration_s: float = 1.0          # arrival window length
    tenants: dict[str, float] = field(default_factory=dict)  # name -> weight
    # Relative deadline per request: one float for all tenants, or a
    # ``{tenant: ms}`` dict for mixed deadline classes (urgent vs lax —
    # the regime where EDF visibly beats FIFO).
    deadline_ms: Optional[float | dict[str, float]] = None
    zipf_alpha: float = 1.1
    n_hot_tiles: int = 64
    # Gateway admission: max queued (not yet dispatched) requests; None
    # = uncontrolled ingestion (the queueing-collapse baseline).
    admission_queue_cap: Optional[int] = None
    # Requests concurrently released into the cluster (WFQ window).
    gateway_inflight: int = 8
    # Deadline-aware scheduling: EDF tier in the Manager's pending
    # queue AND in every node's ReadyScheduler.  False = FIFO baseline
    # (deadlines still measured, never enforced).
    edf: bool = True
    # Elastic membership under load: drain node ``(nid, t)`` gracefully
    # (leases re-queued at once — no heartbeat wait, unlike
    # fail_node_at), and/or have one extra node join at time ``t``.
    drain_node_at: Optional[tuple[int, float]] = None
    join_node_at: Optional[float] = None
    # -- telemetry mirror (repro.telemetry) -------------------------------
    # Emit the runtime's span schema from the simulated seams — gateway
    # admission, stage lease, per-lane op execution, region pull/push,
    # request completion — with sim-clock timestamps, so trace tooling
    # (Chrome trace export, tests) works identically on both engines.
    telemetry: bool = False
    trace_sample_rate: float = 1.0
    # Record a ``(time, kind)`` log of every event the core pops (for
    # the invariant suite's monotonicity checks); off by default — a
    # fleet-scale run pops tens of millions of events.
    record_event_log: bool = False

    def __post_init__(self) -> None:
        if self.crash_at is not None and self.fail_node_at is None:
            self.fail_node_at = self.crash_at
        if self.engine not in ("event", "tick"):
            raise ValueError(
                f"SimConfig.engine must be 'event' or 'tick', got {self.engine!r}"
            )
        if isinstance(self.rack_affinity, str) and self.rack_affinity != "auto":
            raise ValueError(
                "SimConfig.rack_affinity must be a float or 'auto', "
                f"got {self.rack_affinity!r}"
            )

    @property
    def dl(self) -> bool:
        """Effective data-locality flag (chaining implies DL)."""
        return self.locality or self.chaining

    @property
    def gpus(self) -> int:
        return self.n_gpus if self.n_gpus is not None else self.node.n_gpus

    @property
    def cpu_cores(self) -> int:
        if self.n_cpu_cores is not None:
            return self.n_cpu_cores
        # One control thread pinned per GPU (paper §V-D).
        return self.node.n_cpu_cores - self.gpus


@dataclass
class SimResult:
    makespan: float
    tiles: int
    tiles_per_second: float
    profile: dict[str, dict[str, int]]     # op -> lane kind -> count
    lane_busy: dict[str, float]            # lane kind -> busy seconds
    io_wait: float
    n_events: int
    reuse_hits: int
    reuse_misses: int
    completed_ok: bool
    recovered_leases: int = 0
    duplicated_leases: int = 0
    # Staging accounting (cfg.staging): bytes of stage inputs served
    # from node-local tiers vs copied across the interconnect.
    staged_bytes_avoided: int = 0
    cross_node_bytes: int = 0
    transfer_wait: float = 0.0
    # Data-plane accounting: cross-node bytes relayed through the
    # coordinator vs moved worker-to-worker, and predictive pushes.
    relay_region_bytes: int = 0
    direct_region_bytes: int = 0
    pushes: int = 0
    pushed_bytes: int = 0
    # Network topology accounting (cfg.network): where the cross-node
    # bytes flowed and how long the shared uplink tier serialized.
    rack_local_bytes: int = 0
    cross_rack_bytes: int = 0
    uplink_busy_s: float = 0.0
    # Flow-control mirror (cfg.push_inflight_cap_bytes): predictive
    # pushes skipped because the target's ingress cap was full.
    pushes_capped: int = 0
    # Micro-batched dispatch accounting (cfg.micro_batch > 1).
    batches: int = 0
    batched_ops: int = 0
    # Control-plane accounting (cfg.rpc_latency_us): messages that
    # crossed the Manager/Worker bus and the latency they exposed.
    control_messages: int = 0
    rpc_wait: float = 0.0
    # Fault-injection accounting (cfg.msg_drop_rate / corrupt_rate):
    # control messages retransmitted after an injected loss, and region
    # copies re-issued after an injected CRC mismatch.
    msg_retries: int = 0
    corrupt_detected: int = 0
    # Gray-failure mirror accounting (cfg.health_scoring / hedge_slack /
    # shed_feasibility / edf_slack_band).
    hedged_leases: int = 0
    probations: int = 0
    probation_exits: int = 0
    shed_infeasible: int = 0
    slack_deferrals: int = 0
    # Serving-mode accounting (cfg.arrival_rate): open-loop request
    # stream through the simulated gateway.
    requests: int = 0
    completed_requests: int = 0
    shed_requests: int = 0
    # Latency/tardiness percentiles are None when the run completed
    # zero requests (shed-everything or all-infeasible configs) — a
    # percentile of an empty sample is undefined, not 0.0.
    latency_p50: Optional[float] = None
    latency_p99: Optional[float] = None
    deadline_misses: int = 0
    tardiness_p99: Optional[float] = None
    tenant_completed: dict[str, int] = field(default_factory=dict)
    tenant_misses: dict[str, int] = field(default_factory=dict)
    # Telemetry mirror (cfg.telemetry): spans in the runtime Tracer's
    # schema, timestamped on the sim clock (seconds, not epoch).
    spans: list = field(default_factory=list)

    @property
    def miss_rate(self) -> float:
        """Deadline-miss fraction of completed requests; 0.0 (not a
        ZeroDivisionError) when the run completed zero requests."""
        if self.completed_requests <= 0:
            return 0.0
        return self.deadline_misses / self.completed_requests

    def utilization(self, cfg: SimConfig) -> dict[str, float]:
        denom = {
            HOST_KIND: cfg.cpu_cores * cfg.n_nodes * max(self.makespan, 1e-9),
            ACCEL_KIND: cfg.gpus * cfg.n_nodes * max(self.makespan, 1e-9),
        }
        return {
            k: self.lane_busy.get(k, 0.0) / denom[k]
            for k in denom
            if denom[k] > 1e-6
        }

    def gpu_fraction_by_op(self) -> dict[str, float]:
        return {
            op: kinds.get(ACCEL_KIND, 0) / max(sum(kinds.values()), 1)
            for op, kinds in self.profile.items()
        }


# --------------------------------------------------------------------------
# Simulator internals
# --------------------------------------------------------------------------


@dataclass
class _Lane:
    node_id: int
    kind: str            # "cpu" | "gpu"
    lane_id: int
    busy: bool = False
    busy_total: float = 0.0
    executed: int = 0
    # Accelerator lanes: LRU of producer op-instance uids resident in
    # device memory (dict preserves insertion order).
    resident: dict[int, None] = field(default_factory=dict)
    transfer_penalty: float = 1.0  # placement-dependent (§IV-A)


def _pct(sorted_vals: list[float], q: float) -> float:
    """Percentile of an ascending list (nearest-rank); 0.0 when empty."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[i]


class _PendingQueue:
    """The Manager's ready-unassigned queue at fleet scale.

    Semantically the FIFO list the placement scans index into
    (``_pick_for_node`` pops arbitrary positions), backed by a deque so
    the overwhelmingly common head pop is O(1) instead of ``pop(0)``'s
    O(n).  Two membership counters let callers skip whole-queue scans
    outright: ``has_deps`` (no queued stage carries deps => the
    locality/placement scans cannot beat FIFO) and ``has_deadlines``
    (no queued deadline => the EDF scan cannot fire).
    """

    __slots__ = ("_q", "_with_deps", "_with_deadlines")

    def __init__(self) -> None:
        self._q: deque[StageInstance] = deque()
        self._with_deps = 0
        self._with_deadlines = 0

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)

    def __iter__(self):
        return iter(self._q)

    @property
    def has_deps(self) -> bool:
        return self._with_deps > 0

    @property
    def has_deadlines(self) -> bool:
        return self._with_deadlines > 0

    def _count(self, si: StageInstance, sign: int) -> None:
        if si.deps:
            self._with_deps += sign
        if si.deadline is not None:
            self._with_deadlines += sign

    def append(self, si: StageInstance) -> None:
        self._q.append(si)
        self._count(si, +1)

    def extend(self, sis) -> None:
        for si in sis:
            self.append(si)

    def popleft(self) -> StageInstance:
        si = self._q.popleft()
        self._count(si, -1)
        return si

    def pop_at(self, i: int) -> StageInstance:
        """Positional pop (the scans' ``pending.pop(i)``); O(min(i, n-i))
        via deque rotation instead of a list's O(n) shift."""
        if i == 0:
            return self.popleft()
        q = self._q
        q.rotate(-i)
        si = q.popleft()
        q.rotate(i)
        self._count(si, -1)
        return si

    def remove_uid(self, uid: int) -> None:
        """Purge every queued copy of stage ``uid`` (exactly-once path,
        only reachable when a duplicate can exist)."""
        if not any(p.uid == uid for p in self._q):
            return
        kept = [p for p in self._q if p.uid != uid]
        self._q.clear()
        self._with_deps = 0
        self._with_deadlines = 0
        for p in kept:
            self.append(p)


@dataclass
class _SimRequest:
    """One open-loop serving request inside the sim gateway."""

    req_id: int
    tenant: str
    tile: int
    arrival: float
    deadline: Optional[float]        # absolute sim time, None = best effort
    finish_tag: float = 0.0          # SFQ virtual finish (WFQ ordering)
    start_tag: float = 0.0
    remaining: int = 0               # terminal stages still outstanding
    t_dispatch: Optional[float] = None
    t_done: Optional[float] = None
    shed: bool = False


@dataclass
class _Node:
    node_id: int
    lanes: list[_Lane]
    scheduler: ReadyScheduler
    leased: set[int] = field(default_factory=set)   # stage-instance uids
    inflight_ops: int = 0
    slow: float = 1.0
    alive: bool = True
    # chunk_id -> io-ready time (tile read from the filesystem)
    io_ready: dict[int, float] = field(default_factory=dict)


class ClusterSim:
    def __init__(self, workflow: ConcreteWorkflow, cfg: SimConfig):
        self.cw = workflow
        self.cfg = cfg
        self.now = 0.0
        self._events: list[tuple[float, int, Callable[[], None]]] = []
        self._seq = itertools.count()
        self.n_events = 0
        self.io_wait_total = 0.0
        self._io_pipe_free = 0.0
        self.recovered = 0
        self.duplicated = 0
        # Hierarchical staging state (cfg.staging).
        self.staging_dir = PlacementDirectory()
        self.staged_bytes_avoided = 0
        self.cross_node_bytes = 0
        self.transfer_wait = 0.0
        # Data plane: per-link network topology (NICs, uplinks, the
        # relay route's coordinator NIC) and byte accounting.
        # An elastic joiner is one extra node, built up front (the net
        # topology is static) but dead until its join event fires.
        self._n_total_nodes = cfg.n_nodes + (
            1 if cfg.join_node_at is not None else 0
        )
        self.net = build_network(
            cfg.network,
            self._n_total_nodes,
            cfg.interconnect_gb_s,
            rack_size=cfg.rack_size or cfg.node.rack_size,
            oversubscription=cfg.oversubscription,
        )
        # Topology identity flows into the placement directory so the
        # dispatch scoring can apply the rack-locality bonus.
        for nid in range(self._n_total_nodes):
            self.staging_dir.set_rack(nid, self.net.rack_of(nid))
        self.relay_region_bytes = 0
        self.direct_region_bytes = 0
        self.pushes = 0
        self.pushed_bytes = 0
        # Flow-control mirror: per-target predictive-push bytes still in
        # flight (list of (land time, bytes); landed entries return
        # their credits on the next admit check).
        self._push_inflight: dict[int, list[tuple[float, int]]] = {}
        self.pushes_capped = 0
        # Control-plane cost model (repro.transport).
        self.control_messages = 0
        self.rpc_wait = 0.0
        self._rpc_s = cfg.rpc_latency_us * 1e-6
        # Fault-injection mirror: dedicated seeded stream so fault
        # decisions never perturb the workload RNG draws.
        self._fault_rng = np.random.default_rng(cfg.seed + 1009)
        self.msg_retries = 0
        self.corrupt_detected = 0
        self._retry_backoff_s = 0.05  # mirror of RetryPolicy.base_delay
        self._stage_bytes = int(cfg.stage_output_mb * 2**20)
        # (node_id, stage uid) -> time its replica finishes landing; a
        # replica recorded in the directory may still be in flight.
        # (tick engine only — the event engine gates on waiter lists.)
        self._region_ready: dict[tuple[int, int], float] = {}
        # Event engine (cfg.engine="event"): cross-node region bytes
        # move as fluid flows with max-min fair bandwidth sharing; the
        # network posts itself transfer_progress events on the sim heap.
        self.fluid: Optional[FluidNetwork] = None
        if cfg.engine == "event":
            self.fluid = FluidNetwork(
                self.net,
                now=lambda: self.now,
                post=lambda t, fn: self._post(t, fn, "transfer_progress"),
            )
        # (node_id, stage uid) -> callbacks waiting on an in-flight
        # replica's landing (the fluid engine's gate — completion times
        # are unknowable at issue under progressive filling).
        self._region_waiters: dict[tuple[int, int], list[Callable[[], None]]] = {}
        # Fluid push-credit ledger: bytes in flight toward each target;
        # credits return in the landing callback and the ledger reads
        # zero at quiesce (an invariant the property suite pins).
        self._push_inflight_bytes: dict[int, int] = {}
        # rack_affinity="auto" cache: (last recompute time, bonus).
        self._rack_bonus_cache: tuple[float, float] = (-1.0, 0.25)
        # Event-core bookkeeping: per-kind pop counts, optional
        # (time, kind) log, and events posted into the past (must stay
        # 0 — the monotonicity invariant).
        self.event_counts: dict[str, int] = {}
        self.event_log: list[tuple[float, str]] = []
        self.posted_in_past = 0

        self.nodes: list[_Node] = []
        for nid in range(self._n_total_nodes):
            # Accelerator lanes first: when several lanes idle, the GPU
            # control threads win the race to the queue head.
            lanes = [_Lane(nid, ACCEL_KIND, i) for i in range(cfg.gpus)]
            lanes += [_Lane(nid, HOST_KIND, i) for i in range(cfg.cpu_cores)]
            for lane in lanes:
                if lane.kind == ACCEL_KIND:
                    lane.transfer_penalty = self._placement_penalty(lane.lane_id)
            sched = ReadyScheduler(
                policy=cfg.policy,
                locality=cfg.dl,
                chain_affinity=1.0 if cfg.chaining else 0.0,
                speedups_known=cfg.speedups_known,
                deadline_aware=cfg.edf,
                edf_slack_band=cfg.edf_slack_band,
                clock=lambda: self.now,
            )
            node = _Node(nid, lanes, sched)
            node.slow = cfg.straggler_factor.get(nid, 1.0)
            if nid >= cfg.n_nodes:
                node.alive = False  # elastic joiner, dead until its event
            self.nodes.append(node)

        # Manager state.
        self.pending = _PendingQueue()           # ready, unassigned (FIFO)
        # Min-heap of node ids believed to have lease-window headroom
        # (validity re-checked at pop): new pending work is offered to
        # these instead of sweeping all N nodes per dispatch — the
        # difference between O(1) and O(nodes) per request at fleet
        # scale.  Min-id pop order preserves the ascending sweep order.
        self._room_heap: list[int] = []
        self._room_set: set[int] = set()
        # True once any path that can duplicate a lease has run (hedge/
        # backup clones, probation or drain re-queues): gates the
        # O(nodes) exactly-once purge sweeps in _finish_stage.
        self._dup_possible = False
        self.stage_done: set[int] = set()
        self.op_done: set[int] = set()
        self.cancelled_ops: set[int] = set()
        self.op_location: dict[int, tuple[int, str, int]] = {}
        self.stage_node: dict[int, int] = {}      # stage uid -> node
        self.completion_order: list[int] = []
        # Backup-task bookkeeping: clone uid <-> original uid.
        self._clone_of: dict[int, int] = {}
        self._clones: dict[int, list[int]] = {}
        self._dup_issued: set[int] = set()
        self._n_primary_stages = len(self.cw.stage_instances)

        # Gray-failure mirror state: per-node health EMA (observed /
        # expected stage runtime), probation flags, lease timestamps
        # and per-stage-name completed-duration lists (ascending) for
        # the percentile hedging test.
        self.hedged = 0
        self.probations = 0
        self.probation_exits = 0
        self.shed_infeasible = 0
        self._health_ratio: dict[int, float] = {}
        self._health_n: dict[int, int] = {}
        self._node_probation: dict[int, bool] = {}
        self._node_probes: dict[int, int] = {}
        self._node_hedged: dict[int, int] = {}
        self._lease_t0: dict[int, float] = {}
        self._stage_durations: dict[str, list[float]] = {}
        # Per-op-name completed durations (the sim twin of the workers'
        # op_runtime_s histograms) — queue-free, so the health ratio
        # measures the node, not its backlog.
        self._op_durations: dict[str, list[float]] = {}
        self._op_dur: dict[int, float] = {}     # inflight op uid -> duration
        self._hedge_interval = max(0.05, cfg.heartbeat_timeout / 10.0)
        self._serve_service: list[float] = []   # completed request service times
        self._serve_svc_ema = 0.0

        # Error-injected speedup estimates (§V-G protocol).
        self._est = self._make_estimates()

        # Serving mode: the simulated gateway's state (mirrors
        # repro.serving.RequestGateway — SFQ virtual time, per-tenant
        # queues, admission, inflight window).
        self.serving = cfg.arrival_rate is not None
        self._serve_tenants = dict(cfg.tenants) or {"t0": 1.0}
        self._serve_queues: dict[str, deque[_SimRequest]] = {
            t: deque() for t in self._serve_tenants
        }
        self._serve_last_finish: dict[str, float] = {
            t: 0.0 for t in self._serve_tenants
        }
        self._serve_vtime = 0.0
        self._serve_queued = 0
        self._serve_inflight = 0
        self._serve_terminal: dict[int, _SimRequest] = {}
        self._serve_reqs: list[_SimRequest] = []
        self._serve_chunk_seq = itertools.count(10**7)  # clear of batch ids
        self._tile_scale = (
            np.random.default_rng(cfg.seed).uniform(0.8, 1.2, cfg.n_hot_tiles)
            if self.serving
            else None
        )

        # Telemetry mirror (cfg.telemetry): the runtime Tracer with
        # sim-clock timestamps.  Stage uid -> trace context (the
        # request's root in serving mode; a per-tile root in batch
        # mode), so one request's lease/op/pull/push spans stitch under
        # one trace exactly like the threaded runtime's.
        self.tracer = None
        self._trace_ctx: dict[int, Any] = {}
        self._chunk_ctx: dict[int, Any] = {}
        self._req_ctx: dict[int, Any] = {}
        if cfg.telemetry:
            from ..telemetry.tracing import Tracer

            self.tracer = Tracer(
                "sim",
                sample_rate=cfg.trace_sample_rate,
                capacity=1 << 16,
                seed=cfg.seed,
            )

    # -- calibrated cost model -------------------------------------------------

    def _make_estimates(self) -> dict[str, float]:
        e = self.cfg.speedup_error
        agg = cal.aggregate_gpu_speedup()

        def with_error(s: float) -> float:
            if e <= 0:
                return s
            if e >= 1.0:  # adversarial: invert the ordering entirely
                return 0.0 if s > agg * 0.5 else 2.0 * s
            if s <= agg * 0.5:
                return s * (1.0 + e)  # low-speedup ops inflated
            return s * (1.0 - e)  # high-speedup ops deflated

        est = {
            name: with_error(p.gpu_speedup)
            for name, p in cal.OP_PROFILES.items()
        }
        est["monolithic"] = cal.aggregate_gpu_speedup(include_transfer=False)
        # The fused op obeys the same §V-G error protocol as its parts.
        est["feature_fused"] = with_error(
            cal.fused_feature_profile().gpu_speedup
        )
        return est

    def _profile(self, op_name: str) -> cal.OpProfile:
        if op_name == "monolithic":
            return cal.OpProfile(
                "monolithic", 1.0,
                cal.aggregate_gpu_speedup(), cal.TRANSFER_IMPACT, "all",
            )
        if op_name == "feature_fused":
            return cal.fused_feature_profile()
        return cal.OP_PROFILES[op_name]

    def _cpu_seconds(self, oi: OperationInstance) -> float:
        p = self._profile(oi.op.name)
        return (
            cal.TILE_CPU_SECONDS
            * p.cpu_fraction
            * float(oi.chunk.meta.get("work_scale", 1.0))
        )

    def _placement_penalty(self, gpu_id: int) -> float:
        """Closest: 1.0.  OS: control threads packed on socket 0, so
        GPUs 2/3 (attached to the second I/O hub, Fig 6) pay extra QPI
        traversals; GPU 1 pays a mild migration penalty."""
        if self.cfg.placement == "closest":
            return 1.0
        return 1.25 if gpu_id == 0 else 1.75

    # -- event engine -----------------------------------------------------------

    def _post(self, t: float, fn: Callable[[], None], kind: str = "ctrl") -> None:
        if t < self.now - 1e-9:
            self.posted_in_past += 1  # invariant breach (never clamped)
        heapq.heappush(self._events, (t, next(self._seq), fn, kind))

    def run(self, max_time: float = 10**9) -> SimResult:
        if self.serving:
            # Seed the room heap: every live node starts with window
            # headroom (the joiner registers itself at its join event).
            for node in self.nodes:
                self._note_room(node)
            self._schedule_arrivals()
        else:
            self.pending.extend(self.cw.ready_stage_instances(self.stage_done))
            for node in self.nodes:
                self._fill_window(node)
        if self.cfg.fail_node_at is not None:
            nid, t = self.cfg.fail_node_at
            self._post(t, lambda: self._kill_node(nid), "fault")
        if self.cfg.drain_node_at is not None:
            nid, t = self.cfg.drain_node_at
            self._post(t, lambda: self._drain_node(nid), "drain")
        if self.cfg.join_node_at is not None:
            self._post(self.cfg.join_node_at, self._join_node, "join")
        if self.cfg.hedge_slack is not None:
            self._post(self._hedge_interval, self._hedge_tick, "heartbeat")
        if self.cfg.partition is not None:
            # Heal event: partitioned nodes resume pulling leases.
            _, _, t_end = self.cfg.partition
            self._post(
                t_end,
                lambda: [self._fill_window(n) for n in self.nodes],
                "fault",
            )
        record = self.cfg.record_event_log
        counts = self.event_counts
        while self._events:
            t, _, fn, kind = heapq.heappop(self._events)
            if t > max_time:
                break
            self.now = t
            self.n_events += 1
            counts[kind] = counts.get(kind, 0) + 1
            if record:
                self.event_log.append((t, kind))
            fn()
        return self._result()

    def _result(self) -> SimResult:
        done_primary = sum(
            1 for uid in self.stage_done if uid not in self._clone_of
        )
        completed = done_primary >= self._n_primary_stages
        n_tiles = len(
            {
                si.chunk.chunk_id
                for uid, si in self.cw.stage_instances.items()
                if uid not in self._clone_of
            }
        )
        profile: dict[str, dict[str, int]] = {}
        hits = misses = batches = batched_ops = slack_defers = 0
        lane_busy: dict[str, float] = {}
        for node in self.nodes:
            for (op, kind), n in node.scheduler.stats.assigned.items():
                profile.setdefault(op, {}).setdefault(kind, 0)
                profile[op][kind] += n
            hits += node.scheduler.stats.reuse_hits
            misses += node.scheduler.stats.reuse_misses
            batches += node.scheduler.stats.batches
            batched_ops += node.scheduler.stats.batched_ops
            slack_defers += node.scheduler.stats.slack_deferrals
            for lane in node.lanes:
                lane_busy[lane.kind] = (
                    lane_busy.get(lane.kind, 0.0) + lane.busy_total
                )
        serve_kwargs: dict = {}
        if self.serving:
            done_reqs = [
                r for r in self._serve_reqs if not r.shed and r.t_done is not None
            ]
            lats = sorted(r.t_done - r.arrival for r in done_reqs)
            tardy = sorted(
                max(0.0, r.t_done - r.deadline)
                for r in done_reqs
                if r.deadline is not None
            )
            tenant_done: dict[str, int] = {}
            tenant_miss: dict[str, int] = {}
            for r in done_reqs:
                tenant_done[r.tenant] = tenant_done.get(r.tenant, 0) + 1
                if r.deadline is not None and r.t_done > r.deadline:
                    tenant_miss[r.tenant] = tenant_miss.get(r.tenant, 0) + 1
            completed = all(
                r.shed or r.t_done is not None for r in self._serve_reqs
            )
            serve_kwargs = dict(
                requests=len(self._serve_reqs),
                completed_requests=len(done_reqs),
                shed_requests=sum(1 for r in self._serve_reqs if r.shed),
                latency_p50=_pct(lats, 0.50) if lats else None,
                latency_p99=_pct(lats, 0.99) if lats else None,
                deadline_misses=sum(1 for t in tardy if t > 0),
                tardiness_p99=_pct(tardy, 0.99) if tardy else None,
                tenant_completed=tenant_done,
                tenant_misses=tenant_miss,
            )
        return SimResult(
            makespan=self.now,
            tiles=n_tiles,
            tiles_per_second=n_tiles / max(self.now, 1e-9),
            profile=profile,
            lane_busy=lane_busy,
            io_wait=self.io_wait_total,
            n_events=self.n_events,
            reuse_hits=hits,
            reuse_misses=misses,
            completed_ok=completed,
            recovered_leases=self.recovered,
            duplicated_leases=self.duplicated,
            staged_bytes_avoided=self.staged_bytes_avoided,
            cross_node_bytes=self.cross_node_bytes,
            transfer_wait=self.transfer_wait,
            relay_region_bytes=self.relay_region_bytes,
            direct_region_bytes=self.direct_region_bytes,
            pushes=self.pushes,
            pushed_bytes=self.pushed_bytes,
            rack_local_bytes=self.net.rack_local_bytes,
            cross_rack_bytes=self.net.cross_rack_bytes,
            uplink_busy_s=self.net.uplink_busy_s(),
            pushes_capped=self.pushes_capped,
            batches=batches,
            batched_ops=batched_ops,
            control_messages=self.control_messages,
            rpc_wait=self.rpc_wait,
            msg_retries=self.msg_retries,
            corrupt_detected=self.corrupt_detected,
            hedged_leases=self.hedged,
            probations=self.probations,
            probation_exits=self.probation_exits,
            shed_infeasible=self.shed_infeasible,
            slack_deferrals=slack_defers,
            spans=self.tracer.spans() if self.tracer is not None else [],
            **serve_kwargs,
        )

    # -- serving mode: open-loop gateway -----------------------------------------

    def _schedule_arrivals(self) -> None:
        from ..serving.workload import WorkloadConfig, generate_arrivals

        dl = self.cfg.deadline_ms
        dl_map = dl if isinstance(dl, dict) else None
        arrivals = generate_arrivals(
            WorkloadConfig(
                arrival_rate=float(self.cfg.arrival_rate),
                duration_s=self.cfg.serve_duration_s,
                tenants=self._serve_tenants,
                zipf_alpha=self.cfg.zipf_alpha,
                n_tiles=self.cfg.n_hot_tiles,
                deadline_ms=None if dl_map is not None else dl,
                seed=self.cfg.seed,
            )
        )
        for a in arrivals:
            if dl_map is not None:
                d_ms = dl_map.get(a.tenant)
                deadline = a.t + d_ms / 1000.0 if d_ms else None
            else:
                deadline = (a.t + a.deadline_s) if a.deadline_s else None
            req = _SimRequest(
                req_id=len(self._serve_reqs),
                tenant=a.tenant,
                tile=a.tile,
                arrival=a.t,
                deadline=deadline,
            )
            self._serve_reqs.append(req)
            self._post(a.t, lambda req=req: self._serve_arrival(req), "arrival")

    def _serve_arrival(self, req: _SimRequest) -> None:
        """Gateway ingest: admit-or-shed, stamp SFQ tags, dispatch."""
        cap = self.cfg.admission_queue_cap
        if cap is not None and self._serve_queued >= cap:
            req.shed = True
            return
        if (
            self.cfg.shed_feasibility
            and req.deadline is not None
            and not self._serve_feasible(req)
        ):
            # EDF schedulability failure: no completion order meets this
            # deadline given the measured service percentile and the
            # backlog ahead — shed now rather than miss later.
            req.shed = True
            self.shed_infeasible += 1
            return
        ts_w = self._serve_tenants.get(req.tenant, 1.0)
        start = max(
            self._serve_vtime, self._serve_last_finish.get(req.tenant, 0.0)
        )
        cost = 1.0  # uniform estimated cost: weights alone set the split
        req.start_tag = start
        req.finish_tag = start + cost / max(ts_w, 1e-9)
        self._serve_last_finish[req.tenant] = req.finish_tag
        self._serve_queues.setdefault(req.tenant, deque()).append(req)
        self._serve_queued += 1
        if self.tracer is not None:
            root = self.tracer.start_trace()
            self._req_ctx[req.req_id] = root
            self._t_span(
                "gateway:admit",
                root,
                cat="request",
                tid="gateway",
                args={"req_id": req.req_id, "tenant": req.tenant},
            )
        self._serve_dispatch()

    def _serve_dispatch(self) -> None:
        """WFQ release into the cluster: smallest head-of-line finish
        tag wins, up to the gateway's inflight window."""
        while self._serve_inflight < self.cfg.gateway_inflight:
            best: Optional[str] = None
            for tenant, q in self._serve_queues.items():
                if q and (
                    best is None
                    or q[0].finish_tag
                    < self._serve_queues[best][0].finish_tag
                ):
                    best = tenant
            if best is None:
                return
            req = self._serve_queues[best].popleft()
            self._serve_vtime = max(self._serve_vtime, req.start_tag)
            self._serve_queued -= 1
            self._serve_inflight += 1
            req.t_dispatch = self.now
            chunk = DataChunk(
                chunk_id=next(self._serve_chunk_seq),
                meta={
                    "work_scale": float(self._tile_scale[req.tile]),
                    "tile": req.tile,
                },
            )
            # Deadline inheritance request -> stages (EDF plumbing);
            # the FIFO baseline still *measures* deadlines but never
            # stamps them into the schedulers.
            deadline = req.deadline if self.cfg.edf else None
            sis = self.cw.instantiate(chunk, deadline=deadline)
            uids = {si.uid for si in sis}
            terminals = [
                si for si in sis if not (si.dependents & uids)
            ] or sis[-1:]
            req.remaining = len(terminals)
            for si in terminals:
                self._serve_terminal[si.uid] = req
            root = self._req_ctx.get(req.req_id)
            if root is not None:
                for si in sis:
                    self._trace_ctx[si.uid] = root
            self._n_primary_stages += len(sis)
            for si in sis:
                if si.deps.issubset(self.stage_done):
                    self.pending.append(si)
            self._offer_pending()

    def _serve_complete_stage(self, uid: int) -> None:
        req = self._serve_terminal.pop(uid, None)
        if req is None:
            return
        req.remaining -= 1
        if req.remaining > 0:
            return
        req.t_done = self.now
        svc = req.t_done - (
            req.t_dispatch if req.t_dispatch is not None else req.arrival
        )
        bisect.insort(self._serve_service, svc)
        self._serve_svc_ema = (
            svc
            if self._serve_svc_ema == 0.0
            else 0.7 * self._serve_svc_ema + 0.3 * svc
        )
        root = self._req_ctx.pop(req.req_id, None)
        if root is not None and root.sampled and self.tracer is not None:
            missed = req.deadline is not None and req.t_done > req.deadline
            self.tracer.record_span(
                "request",
                ctx=root,
                cat="request",
                ts=req.arrival,
                dur=req.t_done - req.arrival,
                tid="gateway",
                args={
                    "req_id": req.req_id,
                    "tenant": req.tenant,
                    "deadline_miss": missed,
                },
            )
        self._serve_inflight -= 1
        self._serve_dispatch()

    def _serve_feasible(self, req: _SimRequest) -> bool:
        """EDF schedulability test for one arrival (mirror of
        RequestGateway._feasible_locked): estimate this request's
        completion as now + service_pct x (backlog of equal-or-earlier
        deadlines + 1) / inflight window, and admit only when that
        lands inside the deadline."""
        svc = self._serve_service
        if len(svc) >= self.cfg.feasibility_min_samples:
            service = _pct(svc, self.cfg.feasibility_pct)
        else:
            service = self._serve_svc_ema
        if service <= 0.0:
            return True  # no signal yet: admit (measurement warm-up)
        ahead = self._serve_inflight + sum(
            1
            for q in self._serve_queues.values()
            for r in q
            if r.deadline is None or r.deadline <= req.deadline
        )
        est_done = self.now + service * (ahead + 1) / max(
            self.cfg.gateway_inflight, 1
        )
        return est_done <= req.deadline

    # -- elastic membership -------------------------------------------------------

    def _drain_node(self, nid: int) -> None:
        """Graceful scale-down under load: unlike a crash (heartbeat
        timeout, work on the node lost), a drain re-queues the node's
        outstanding leases immediately and keeps completed op outputs
        — zero lost requests is the contract."""
        node = self.nodes[nid]
        if not node.alive:
            return
        node.alive = False
        self._dup_possible = True  # re-queues can double-lease a stage
        self.staging_dir.drop_worker(nid)
        for uid in sorted(node.leased):
            if uid in self.stage_done:
                continue
            si = self.cw.stage_instances[uid]
            # In-flight (incomplete) op work on the drained node is
            # abandoned; finished ops re-run with the re-lease.
            for oi in si.op_instances:
                if (
                    oi.uid in self.op_done
                    and self.op_location.get(oi.uid, (None,))[0] == nid
                ):
                    self.op_done.discard(oi.uid)
            self.recovered += 1
            self.pending.append(si)
        node.leased.clear()
        for other in self.nodes:
            self._fill_window(other)

    def _join_node(self) -> None:
        """Elastic scale-up: the pre-built extra node comes alive and
        immediately pulls from the pending queue."""
        node = self.nodes[-1]
        node.alive = True
        self._fill_window(node)

    # -- telemetry mirror ---------------------------------------------------------

    def _t_ctx(self, si: StageInstance):
        """Trace context for a stage: the owning request's root
        (serving), else a lazily-rooted per-tile trace (batch)."""
        if self.tracer is None:
            return None
        ctx = self._trace_ctx.get(si.uid)
        if ctx is not None:
            return ctx
        cid = si.chunk.chunk_id
        ctx = self._chunk_ctx.get(cid)
        if ctx is None:
            ctx = self.tracer.start_trace()
            self._chunk_ctx[cid] = ctx
        self._trace_ctx[si.uid] = ctx
        return ctx

    def _t_span(
        self,
        name: str,
        ctx,
        *,
        cat: str,
        dur: float = 0.0,
        tid: str = "manager",
        args: Optional[dict] = None,
        ts: Optional[float] = None,
    ) -> None:
        """Record one child span under ``ctx`` at sim time (no wall
        clock ever leaks into a simulated trace)."""
        if self.tracer is None or ctx is None or not ctx.sampled:
            return
        sub = self.tracer.child(ctx)
        self.tracer.record_span(
            name,
            ctx=sub,
            parent=ctx.span_id,
            cat=cat,
            ts=self.now if ts is None else ts,
            dur=dur,
            tid=tid,
            args=args,
        )

    # -- Manager: demand-driven assignment --------------------------------------

    def _partitioned(self, nid: int) -> bool:
        p = self.cfg.partition
        if p is None:
            return False
        nids, t0, t1 = p
        return nid in nids and t0 <= self.now < t1

    def _control_rtt(self) -> float:
        """One control-plane round-trip's exposed latency, with
        injected message loss: each lost copy is retransmitted after a
        backoff (the sim mirror of RetryPolicy over BusTimeoutError)."""
        self.control_messages += 1
        t = self._rpc_s
        rate = self.cfg.msg_drop_rate
        while rate > 0.0 and self._fault_rng.random() < rate:
            self.msg_retries += 1
            t += self._retry_backoff_s + self._rpc_s
        return t

    def _fill_window(self, node: _Node) -> None:
        if not node.alive or self._partitioned(node.node_id):
            return
        while len(node.leased) < self._window_for(node) and self.pending:
            si = self._pick_for_node(node)
            node.leased.add(si.uid)
            self.stage_node[si.uid] = node.node_id
            self._lease_t0[si.uid] = self.now
            # A lease is one Manager->Worker message: the dispatch pays
            # the bus round-trip (plus any injected-loss retransmits)
            # on top of the protocol latency.
            rtt = self._control_rtt()
            self.rpc_wait += rtt
            self._t_span(
                "stage:lease",
                self._t_ctx(si),
                cat="sched",
                dur=self.cfg.dispatch_latency + rtt,
                args={"uid": si.uid, "worker": node.node_id},
            )
            self._post(
                self.now + self.cfg.dispatch_latency + rtt,
                lambda si=si, node=node: self._start_stage(node, si),
                "lease",
            )
        self._maybe_backup_tasks()
        if node.alive and len(node.leased) < self._window_for(node):
            self._note_room(node)

    def _note_room(self, node: _Node) -> None:
        """Register ``node`` as having lease-window headroom; validity
        is re-checked when _offer_pending pops it."""
        nid = node.node_id
        if nid in self._room_set or not node.alive:
            return
        self._room_set.add(nid)
        heapq.heappush(self._room_heap, nid)

    def _offer_pending(self) -> None:
        """Offer queued work to the nodes known to have window headroom
        — O(log nodes) per offer instead of the O(nodes) sweep.  With
        health scoring a probation node's window opens and closes with
        the *global* backlog size, which room tracking can't see, so
        those (small-fleet) configs keep the full sweep."""
        if not self.pending:
            return
        if self.cfg.health_scoring:
            for node in self.nodes:
                self._fill_window(node)
            return
        while self.pending and self._room_heap:
            nid = heapq.heappop(self._room_heap)
            self._room_set.discard(nid)
            self._fill_window(self.nodes[nid])

    def _pick_for_node(self, node: _Node) -> StageInstance:
        """FIFO, with a locality preference: a stage whose upstream ran
        on this node keeps its data local (files / in-memory store)."""
        if self.cfg.edf and self.pending.has_deadlines:
            # EDF tier above the placement policies: the earliest
            # deadline anywhere in the queue outranks locality and FIFO
            # order — urgency first, affinity among the unhurried rest.
            best_i, best_d = -1, None
            for i, si in enumerate(self.pending):
                d = si.deadline
                if d is not None and (best_d is None or d < best_d):
                    best_i, best_d = i, d
            if best_i >= 0:
                return self.pending.pop_at(best_i)
        if not self.pending.has_deps:
            # Every queued stage is dep-less: no locality/placement
            # scan can beat FIFO order, so skip them outright (the
            # common serving-mode state — O(1) per lease at any scale).
            return self.pending.popleft()
        if self.cfg.staging:
            if not self.cfg.staging_locality:
                return self.pending.popleft()  # pure demand-driven baseline
            # Directory-driven: lease the instance with the largest
            # fraction of its input bytes already staged on this node
            # (plus the rack-locality bonus: same-rack replicas avoid
            # the oversubscribed uplinks, so they count at
            # cfg.rack_affinity weight).
            best_i, best_f = 0, 0.0
            bonus = self._rack_bonus()
            for i, si in enumerate(self.pending):
                if not si.deps:
                    continue
                keys = [("stage", d) for d in si.deps]
                f = self.staging_dir.placement_score(
                    node.node_id, keys, bonus
                )
                if f > best_f:
                    best_i, best_f = i, f
            return self.pending.pop_at(best_i)
        for i, si in enumerate(self.pending):
            if si.deps and all(
                self.stage_node.get(d) == node.node_id for d in si.deps
            ):
                return self.pending.pop_at(i)
        return self.pending.popleft()

    def _rack_bonus(self) -> float:
        """Effective rack-locality placement bonus.

        A numeric ``cfg.rack_affinity`` is used as-is.  ``"auto"``
        derives it online from the fabric itself: the ratio of per-link
        uplink busy time to per-link NIC busy time — congested uplinks
        push the bonus toward 1 (strongly prefer same-rack replicas),
        an idle or flat fabric pushes it to ~0.  Before any traffic has
        flowed the warm-up default is a mild 0.25.
        """
        ra = self.cfg.rack_affinity
        if ra != "auto":
            return ra
        n_up = self.net.n_uplinks()
        if n_up == 0:
            return 0.0  # flat fabric: rack preference is meaningless
        t_cached, bonus = self._rack_bonus_cache
        # nic_busy_s() walks all 2N NIC links — refresh at most once
        # per 50 simulated ms so fleet-scale scans stay O(1) amortized.
        if self.now < t_cached + 0.05 and t_cached >= 0.0:
            return bonus
        up = self.net.uplink_busy_s() / n_up
        nic = self.net.nic_busy_s() / max(2 * self._n_total_nodes, 1)
        total = up + nic
        bonus = 0.25 if total <= 0.0 else up / total
        self._rack_bonus_cache = (self.now, bonus)
        return bonus

    def _dep_satisfied(self, deps: set[int]) -> bool:
        # A cancelled op's stage was completed by a backup twin, so its
        # output exists: cancelled counts as satisfied.
        return all(
            d in self.op_done or d in self.cancelled_ops for d in deps
        )

    def _start_stage(self, node: _Node, si: StageInstance) -> None:
        if not node.alive or si.uid in self.stage_done:
            return
        if self.fluid is not None and self.cfg.staging and si.deps:
            self._start_stage_fluid(node, si)
            return
        delay = self._staging_delay(node, si)
        if delay > 0.0:
            # Upstream regions must be copied into this node's tiers
            # before the stage's source ops can run (async with respect
            # to the node's lanes — only this stage waits).
            self.transfer_wait += delay
            self._t_span(
                "region:pull",
                self._t_ctx(si),
                cat="region",
                dur=delay,
                tid=f"n{node.node_id}",
                args={"uid": si.uid, "deps": len(si.deps)},
            )
            self._post(
                self.now + delay,
                lambda node=node, si=si: self._start_stage_ops(node, si),
                "transfer_progress",
            )
            return
        self._start_stage_ops(node, si)

    def _start_stage_fluid(self, node: _Node, si: StageInstance) -> None:
        """Event-engine input staging: the stage's missing inputs move
        as fluid flows and the stage's source ops are gated on the last
        landing callback instead of an analytic completion time (under
        progressive filling a flow's finish time is unknowable at issue
        — every later flow start/finish re-rates it)."""
        state = {"waiting": 1, "t0": self.now}  # 1 = the issuing token

        def arm() -> None:
            state["waiting"] -= 1
            if state["waiting"]:
                return
            delay = self.now - state["t0"]
            if delay > 0.0:
                self.transfer_wait += delay
                self._t_span(
                    "region:pull",
                    self._t_ctx(si),
                    cat="region",
                    dur=delay,
                    tid=f"n{node.node_id}",
                    args={"uid": si.uid, "deps": len(si.deps)},
                    ts=state["t0"],
                )
            self._start_stage_ops(node, si)

        remote: list[int] = []
        for d in sorted(si.deps):
            if self.staging_dir.holders(("stage", d)).get(node.node_id):
                self.staged_bytes_avoided += self._stage_bytes
                # The replica may still be landing from an earlier copy
                # (pull or push): subscribe to its waiter list.
                w = self._region_waiters.get((node.node_id, d))
                if w is not None:
                    state["waiting"] += 1
                    w.append(arm)
            else:
                remote.append(d)
        if remote:
            # One coalesced pull request (or one per key without
            # batch_prefetch) pays the control round-trip before the
            # copies can start — same rule as the tick path.
            n_msgs = 1 if self.cfg.batch_prefetch else len(remote)
            rtt = sum(self._control_rtt() for _ in range(n_msgs))
            self.rpc_wait += rtt
            for d in remote:
                state["waiting"] += 1
                self._fluid_region_copy(node, d, rtt, arm)
        arm()  # consume the issuing token

    def _fluid_region_copy(
        self,
        node: _Node,
        dep_uid: int,
        delay: float,
        on_land: Optional[Callable[[], None]],
    ) -> None:
        """Start one cross-node region copy as a fluid flow toward
        ``node`` after ``delay`` (the pull request's control latency).
        The directory learns of the replica at issue time (the tick
        engine's rule): later consumers find it and gate on the waiter
        list this method registers."""
        key = ("stage", dep_uid)
        n = self._stage_bytes
        self.cross_node_bytes += n
        src = self._pick_holder(node.node_id, key)
        self.staging_dir.record(node.node_id, key, n)
        waiters = self._region_waiters.setdefault(
            (node.node_id, dep_uid), []
        )
        if on_land is not None:
            waiters.append(on_land)

        def land(t: float, retried: bool = False) -> None:
            if (
                not retried
                and self.cfg.corrupt_rate > 0.0
                and self._fault_rng.random() < self.cfg.corrupt_rate
            ):
                # CRC mismatch on landing: re-issue once (waiters stay
                # subscribed until the clean copy lands).
                self.corrupt_detected += 1
                self.cross_node_bytes += n
                self._fluid_start(
                    src, node.node_id, n, lambda t2: land(t2, True)
                )
                return
            for w in self._region_waiters.pop((node.node_id, dep_uid), ()):
                w()

        if delay > 0.0:
            self._post(
                self.now + delay,
                lambda: self._fluid_start(src, node.node_id, n, land),
                "transfer_progress",
            )
        else:
            self._fluid_start(src, node.node_id, n, land)

    def _fluid_start(
        self,
        src: Optional[int],
        dst: int,
        n: int,
        on_done: Callable[[float], None],
    ) -> None:
        """Inject one flow, booking the same relay/direct byte counters
        the tick engine's _raw_transfer does."""
        if self.cfg.direct_transfer:
            self.direct_region_bytes += n
            self.fluid.start(src, dst, n, on_done)
        else:
            self.relay_region_bytes += n
            self.fluid.start(src, dst, n, on_done, relay=True)

    def _staging_delay(self, node: _Node, si: StageInstance) -> float:
        """Seconds until ``si``'s missing inputs are staged onto ``node``.

        Copies serialize on the node's ingress link (its NIC is a shared
        resource, like the Lustre pipe for tile reads), so a node that
        keeps leasing remote-affine stages pays compounding delays —
        which is exactly what locality-aware placement avoids.
        """
        if not self.cfg.staging or not si.deps:
            return 0.0
        ready = self.now
        local: list[int] = []
        remote: list[int] = []
        for d in si.deps:
            if self.staging_dir.holders(("stage", d)).get(node.node_id):
                local.append(d)
            else:
                remote.append(d)
        for d in local:
            self.staged_bytes_avoided += self._stage_bytes
            # The replica may still be landing from an earlier copy
            # (or from local production: ready time 0 = resident).
            ready = max(
                ready, self._region_ready.get((node.node_id, d), 0.0)
            )
        if remote:
            # Each pull request is a control-plane round-trip; with
            # batch_prefetch the missing keys coalesce into ONE request
            # (one rpc latency per batch — transport-level batching),
            # otherwise every key pays its own round-trip before its
            # copy can start.
            n_msgs = 1 if self.cfg.batch_prefetch else len(remote)
            rtt = sum(self._control_rtt() for _ in range(n_msgs))
            self.rpc_wait += rtt
            copies_start = self.now + rtt
            for d in remote:
                key = ("stage", d)
                n = self._stage_bytes
                self.cross_node_bytes += n
                src = self._pick_holder(node.node_id, key)
                done_t = self._transfer_into(node, copies_start, n, src=src)
                ready = max(ready, done_t)
                # The directory learns of the replica now; consumers
                # scheduled before it lands gate on _region_ready.
                self.staging_dir.record(node.node_id, key, n)
                self._region_ready[(node.node_id, d)] = done_t
        return ready - self.now

    def _pick_holder(self, dst_nid: int, key) -> Optional[int]:
        """Source node of a region copy toward ``dst_nid``: prefer a
        same-rack holder (the copy then bypasses the uplink tier),
        then the largest replica; None when no holder is recorded (the
        conservative destination-NIC-only fallback)."""
        holders = self.staging_dir.holders(key)
        if not holders:
            return None
        return min(
            holders,
            key=lambda nid: (
                not self.net.same_rack(nid, dst_nid),
                -holders[nid],
                nid,
            ),
        )

    def _transfer_into(
        self, node: _Node, earliest: float, n: int, src: Optional[int] = None
    ) -> float:
        """Time at which ``n`` region bytes land on ``node``.

        Direct mode: the copy serializes on every link of the
        ``src -> node`` path (source NIC, any shared uplinks, the
        destination NIC — see ``core/network.py``).  Relay mode: the
        bytes additionally pass through the coordinator's NIC twice
        (in + out), a single link shared by EVERY node's cross-node
        traffic — the structural bottleneck the coordinator-bypass
        removes.
        """
        done = self._raw_transfer(node, earliest, n, src)
        if (
            self.cfg.corrupt_rate > 0.0
            and self._fault_rng.random() < self.cfg.corrupt_rate
        ):
            # CRC mismatch on landing: the copy is re-issued once (the
            # sim mirror of the runtime's alternate-holder re-fetch).
            self.corrupt_detected += 1
            self.cross_node_bytes += n
            done = self._raw_transfer(node, done, n, src)
        return done

    def _raw_transfer(
        self, node: _Node, earliest: float, n: int, src: Optional[int]
    ) -> float:
        if self.cfg.direct_transfer:
            self.direct_region_bytes += n
            return self.net.transfer(src, node.node_id, n, earliest)
        self.relay_region_bytes += n
        return self.net.relay(src, node.node_id, n, earliest)

    def _start_stage_ops(self, node: _Node, si: StageInstance) -> None:
        if not node.alive or si.uid in self.stage_done:
            return
        # Tile read from the shared filesystem gates the source ops.
        if self.cfg.include_io and not si.deps:
            self._issue_io(node, si)
        for oi in si.op_instances:
            if oi.uid in self.op_done or oi.uid in self.cancelled_ops:
                continue
            if self._dep_satisfied(oi.deps):
                self._prepare_op(oi)
                self._enqueue_op(node, oi)
        self._dispatch_idle_lanes(node)

    def _prepare_op(self, oi: OperationInstance) -> None:
        oi.speedup = self._est[oi.op.name]
        oi.transfer_impact = self._profile(oi.op.name).transfer_impact

    def _issue_io(self, node: _Node, si: StageInstance) -> None:
        start = max(self.now, self._io_pipe_free)
        self._io_pipe_free = start + 1.0 / cal.LUSTRE_AGGREGATE_BW_TILES
        ready = start + cal.IO_SECONDS_PER_TILE
        self.io_wait_total += ready - self.now
        node.io_ready[si.chunk.chunk_id] = ready

    def _enqueue_op(self, node: _Node, oi: OperationInstance) -> None:
        gate = node.io_ready.get(oi.chunk.chunk_id, 0.0)
        if not oi.deps and gate > self.now:
            self._post(gate, lambda: self._enqueue_op_now(node, oi), "io")
        else:
            self._enqueue_op_now(node, oi)

    def _enqueue_op_now(self, node: _Node, oi: OperationInstance) -> None:
        if not node.alive or oi.uid in self.cancelled_ops:
            return
        node.scheduler.push(oi)
        self._dispatch_idle_lanes(node)

    # -- Worker Resource Manager: lane dispatch ---------------------------------

    def _dispatch_idle_lanes(self, node: _Node) -> None:
        if not node.alive:
            return
        for lane in node.lanes:
            while not lane.busy and node.scheduler:
                resident = set(lane.resident) if lane.kind == ACCEL_KIND else None
                if lane.kind == ACCEL_KIND and self.cfg.micro_batch > 1:
                    idle = sum(
                        1
                        for ln in node.lanes
                        if ln.kind == ACCEL_KIND and not ln.busy
                    )
                    limit = node.scheduler.batch_limit(
                        self.cfg.micro_batch, idle
                    )
                    ois = node.scheduler.pop_batch(
                        lane.kind,
                        resident,
                        limit=limit,
                        batchable=self._op_batchable,
                    )
                else:
                    oi = node.scheduler.pop(lane.kind, resident)
                    ois = [oi] if oi is not None else []
                if not ois:
                    break
                live = [
                    oi
                    for oi in ois
                    if oi.uid not in self.cancelled_ops
                    and oi.uid not in self.op_done
                ]
                if not live:
                    continue  # stale (backup twin already completed)
                self._execute(node, lane, live)

    def _op_batchable(self, oi: OperationInstance) -> int:
        """pop_batch cap for the simulated op.

        Static mode uses the config constant; adaptive mode asks the
        cost model for the largest batch whose single-launch latency
        (calibrated per-instance runtime, launch overhead) still fits
        ``batch_latency_budget`` — per-op ``B``, capped by the config.
        """
        p = self._profile(oi.op.name)
        if not p.batchable:
            return 1
        if not self.cfg.adaptive_batch:
            return self.cfg.micro_batch
        accel_s = self._cpu_seconds(oi) / max(p.gpu_speedup, 1e-9)
        return max(
            1,
            optimal_micro_batch(
                op_cost_from_seconds(accel_s),
                TPU_V5E,
                self.cfg.launch_overhead,
                self.cfg.batch_latency_budget,
                max_batch=self.cfg.micro_batch,
            ),
        )

    def _execute(
        self, node: _Node, lane: _Lane, ois: list[OperationInstance]
    ) -> None:
        """One dispatch decision: a single op or a micro-batch of
        same-op instances.  The launch overhead is paid once per call —
        the amortization curve of ``cost_model.batched_runtime``."""
        durs = [self._duration(node, lane, oi) for oi in ois]
        duration = sum(durs)
        if self.cfg.health_scoring:
            for oi, d in zip(ois, durs):
                self._op_dur[oi.uid] = d
        if lane.kind == ACCEL_KIND:
            duration += self.cfg.launch_overhead
        lane.busy = True
        lane.busy_total += duration
        node.inflight_ops += len(ois)
        if self.tracer is not None:
            tid = f"n{node.node_id}/{lane.kind}{lane.lane_id}"
            for oi in ois:
                self._t_span(
                    f"op:{oi.op.name}",
                    self._t_ctx(oi.stage_instance),
                    cat="op",
                    dur=duration,
                    tid=tid,
                    args={"uid": oi.uid, "batch": len(ois)},
                )

        def finish() -> None:
            # The lane is released only with the batch's last member, so
            # a dependent dispatched from an earlier member's completion
            # cannot double-book it.
            for oi in ois[:-1]:
                self._finish_op(node, lane, oi, release_lane=False)
            self._finish_op(node, lane, ois[-1])

        self._post(self.now + duration, finish, "op_done")

    def _duration(self, node: _Node, lane: _Lane, oi: OperationInstance) -> float:
        cpu_s = self._cpu_seconds(oi) * node.slow
        win = self.cfg.slow_between.get(node.node_id)
        if win is not None and win[0] <= self.now < win[1]:
            cpu_s *= win[2]  # windowed gray failure: onsets, then heals
        p = self._profile(oi.op.name)
        if lane.kind == HOST_KIND:
            active = sum(
                1 for ln in node.lanes if ln.kind == HOST_KIND and ln.busy
            ) + 1
            t = cpu_s / self.cfg.node.cpu_core_efficiency(active)
            # Input resident on some GPU => pay the download half.
            if self.cfg.dl and self._inputs_on_accel(oi):
                gpu_compute = cpu_s / max(p.gpu_speedup, 1e-9)
                t += self._half_transfer(gpu_compute, p, 1.0)
            return t
        # Accelerator lane: upload / process / download phases (§IV-D).
        compute = cpu_s / max(p.gpu_speedup, 1e-9)
        up = down = self._half_transfer(compute, p, lane.transfer_penalty)
        if self.cfg.dl:
            if oi.deps and oi.deps & set(lane.resident):
                up = 0.0  # inputs already resident (DL hit)
            down = 0.0    # outputs stay resident; consumer pays if needed
        if self.cfg.prefetch and lane.executed > 0:
            # Async copy overlaps ongoing compute; only the pipeline
            # fill/drain of this lane remains exposed.
            up *= 0.1
            down *= 0.1
        return compute + up + down

    @staticmethod
    def _half_transfer(gpu_compute: float, p: cal.OpProfile, pen: float) -> float:
        total_tx = gpu_compute / (1.0 - p.transfer_impact) - gpu_compute
        return pen * total_tx / 2.0

    def _inputs_on_accel(self, oi: OperationInstance) -> bool:
        return any(
            self.op_location.get(d, (0, HOST_KIND, 0))[1] == ACCEL_KIND
            for d in oi.deps
        )

    # -- completion & bookkeeping ------------------------------------------------

    def _finish_op(
        self,
        node: _Node,
        lane: _Lane,
        oi: OperationInstance,
        release_lane: bool = True,
    ) -> None:
        if release_lane:
            lane.busy = False
        lane.executed += 1
        node.inflight_ops -= 1
        if not node.alive:
            return
        if oi.uid in self.op_done or oi.uid in self.cancelled_ops:
            self._op_dur.pop(oi.uid, None)
            self._dispatch_idle_lanes(node)
            return
        self.op_done.add(oi.uid)
        self.completion_order.append(oi.uid)
        d = self._op_dur.pop(oi.uid, None)
        if d is not None:
            # Health scoring on queue-free op runtime: this op vs the
            # fleet-median runtime of the same op (the mirror of the
            # workers' op_runtime_s histograms).  A probationed node is
            # judged against the baseline but doesn't write it — its
            # slow samples would drag the fleet median toward its own
            # speed.
            durs = self._op_durations.setdefault(oi.op.name, [])
            expected = _pct(durs, 0.50) if durs else 0.0
            if not self._node_probation.get(node.node_id):
                bisect.insort(durs, d)
            if expected > 0.0:
                self._observe_health(node.node_id, d / expected)
                self._update_probation(node)
        self.op_location[oi.uid] = (node.node_id, lane.kind, lane.lane_id)
        if lane.kind == ACCEL_KIND and self.cfg.dl:
            lane.resident[oi.uid] = None
            while len(lane.resident) > self.cfg.gpu_memory_slots:
                lane.resident.pop(next(iter(lane.resident)))
        # Release fine-grain dependents on this node.
        si = oi.stage_instance
        for dep_uid in sorted(oi.dependents):
            d = self.cw.op_instances[dep_uid]
            local = d.stage_instance.uid in node.leased or d.stage_instance is si
            if (
                local
                and self._dep_satisfied(d.deps)
                and dep_uid not in self.op_done
                and dep_uid not in self.cancelled_ops
            ):
                self._prepare_op(d)
                self._enqueue_op(node, d)
        # Stage completion => notify the Manager (WCC callback).
        if all(
            o.uid in self.op_done or o.uid in self.cancelled_ops
            for o in si.op_instances
        ):
            self._finish_stage(node, si)
        self._dispatch_idle_lanes(node)

    def _finish_stage(self, node: _Node, si: StageInstance) -> None:
        if si.uid in self.stage_done:
            return
        self.stage_done.add(si.uid)
        node.leased.discard(si.uid)
        # A probation re-queue can leave a second copy of this stage
        # leased elsewhere or still pending; first completion wins, so
        # purge every other copy (exactly-once, no leaked lease slots).
        # No duplicating path has run => the O(nodes) sweep is skipped
        # (the fleet-scale fast path: completions are the hot event).
        if self._dup_possible:
            for n in self.nodes:
                n.leased.discard(si.uid)
            self.pending.remove_uid(si.uid)
        t0 = self._lease_t0.pop(si.uid, None)
        if t0 is not None:
            # Completed stage durations feed the hedging percentile
            # (lease age vs p99, queueing included — the right hedge
            # trigger); node health is scored on op runtimes instead.
            # Probationed nodes don't write the percentile: one benched
            # straggler would raise the stage p99 — and thereby the
            # hedge trigger — to its own latency.
            elapsed = self.now - t0
            if not self._node_probation.get(node.node_id):
                bisect.insort(
                    self._stage_durations.setdefault(si.stage.name, []),
                    elapsed,
                )
        # Completion notification: one Worker->Manager message (its
        # latency overlaps the next lease's dispatch round-trip, so it
        # is counted — retransmits included — but not serialized onto
        # the critical path).
        self._control_rtt()
        if self.cfg.staging:
            # This node now holds the stage's output region (host tier).
            primary_uid = self._clone_of.get(si.uid, si.uid)
            self.staging_dir.record(
                node.node_id, ("stage", primary_uid), self._stage_bytes
            )
            if self.cfg.predictive_push:
                self._predict_push(node, self.cw.stage_instances.get(
                    primary_uid, si
                ))
        # A backup clone finishing completes the original, and vice versa.
        orig_uid = self._clone_of.get(si.uid)
        effective = (
            self.cw.stage_instances.get(orig_uid, si)
            if orig_uid is not None
            else si
        )
        if orig_uid is not None and orig_uid not in self.stage_done:
            self.stage_done.add(orig_uid)
            for n in self.nodes:
                n.leased.discard(orig_uid)
            self._cancel_ops(self.cw.stage_instances[orig_uid])
        for twin_uid in self._clones.get(effective.uid, ()):  # cancel twins
            if twin_uid not in self.stage_done and twin_uid != si.uid:
                self.stage_done.add(twin_uid)
                for n in self.nodes:
                    n.leased.discard(twin_uid)
                self._cancel_ops(self.cw.stage_instances[twin_uid])
        # Unlock downstream stage instances (set builds skipped when
        # the stage has none — the serving-monolithic hot path).
        if effective.dependents:
            leased_now = {u for n in self.nodes for u in n.leased}
            pending_now = {p.uid for p in self.pending}
            for dep_uid in sorted(effective.dependents):
                dsi = self.cw.stage_instances[dep_uid]
                if (
                    dsi.deps.issubset(self.stage_done)
                    and dep_uid not in self.stage_done
                    and dep_uid not in leased_now
                    and dep_uid not in pending_now
                ):
                    self.pending.append(dsi)
        if self.serving:
            self._serve_complete_stage(effective.uid)
        self._fill_window(node)

    def _cancel_ops(self, si: StageInstance) -> None:
        for oi in si.op_instances:
            if oi.uid not in self.op_done:
                self.cancelled_ops.add(oi.uid)

    def _predict_push(self, src: _Node, si: StageInstance) -> None:
        """Agent-driven predictive push: at ``si``'s completion, predict
        the node each newly-ready dependent will be leased to (the same
        pending-queue-affinity rule ``_pick_for_node`` uses) and start
        copying EVERY input region it is missing NOW — from whichever
        node holds it (completing node or an earlier holder, the
        runtime's directive/push_request split) — so the first-touch
        transfer overlaps the lease dispatch instead of gating the
        dependent's source ops.  A wrong prediction wastes link time
        (counted in pushed_bytes) but never correctness: the dependent's
        own ``_staging_delay`` pull remains the backstop.
        """
        for dep_uid in sorted(si.dependents):
            dsi = self.cw.stage_instances[dep_uid]
            if dep_uid in self.stage_done:
                continue
            is_ready = dsi.deps.issubset(self.stage_done)
            keys = [("stage", d) for d in dsi.deps]
            target = None
            if is_ready:
                best_f = -1.0
                bonus = self._rack_bonus()
                for cand in self.nodes:
                    if not cand.alive or len(cand.leased) >= self.cfg.window:
                        continue
                    f = self.staging_dir.placement_score(
                        cand.node_id, keys, bonus
                    )
                    if f > best_f:
                        target, best_f = cand, f
            else:
                # Upstreams still running: vote with recorded holders
                # plus in-flight upstream leases — this stage's fresh
                # region starts moving while the siblings compute, so
                # the fan-in's first touch hides under their runtime.
                votes: dict[int, int] = {}
                for d in dsi.deps:
                    for nid in self.staging_dir.holders(("stage", d)):
                        votes[nid] = votes.get(nid, 0) + 1
                    nid = self.stage_node.get(d)
                    if nid is not None and d not in self.stage_done:
                        votes[nid] = votes.get(nid, 0) + 1
                votes = {
                    nid: v for nid, v in votes.items() if self.nodes[nid].alive
                }
                if votes:
                    target = self.nodes[
                        max(votes, key=lambda nid: (votes[nid], -nid))
                    ]
            if target is None:
                continue
            pushable = (
                dsi.deps
                if is_ready
                else dsi.deps & {self._clone_of.get(si.uid, si.uid)}
            )
            for d in pushable:
                holders = self.staging_dir.holders(("stage", d))
                if holders.get(target.node_id) or not holders:
                    continue  # already resident there / nothing staged
                n = self._stage_bytes
                if not self._push_admit(target.node_id, n):
                    # Flow control: the target's ingress already carries
                    # a cap's worth of in-flight pushed bytes — skip
                    # (the dependent's own pull is the backstop).
                    self.pushes_capped += 1
                    continue
                if self.fluid is not None:
                    self._fluid_push(si, target, d)
                    continue
                src = self._pick_holder(target.node_id, ("stage", d))
                self.cross_node_bytes += n
                done_t = self._transfer_into(target, self.now, n, src=src)
                self.staging_dir.record(target.node_id, ("stage", d), n)
                self._region_ready[(target.node_id, d)] = done_t
                if self.cfg.push_inflight_cap_bytes is not None:
                    self._push_inflight.setdefault(
                        target.node_id, []
                    ).append((done_t, n))
                self.pushes += 1
                self.pushed_bytes += n
                self._t_span(
                    "region:push",
                    self._t_ctx(si),
                    cat="region",
                    dur=done_t - self.now,
                    tid=f"n{src}" if src is not None else "manager",
                    args={"key": d, "target": target.node_id, "bytes": n},
                )

    def _fluid_push(self, si: StageInstance, target: _Node, dep_uid: int) -> None:
        """Event-engine predictive push: the region flows toward the
        predicted holder under fair sharing; the in-flight byte credit
        returns in the landing callback (not at an analytic finish
        time), so the ledger reads true occupancy at every instant."""
        key = ("stage", dep_uid)
        n = self._stage_bytes
        src = self._pick_holder(target.node_id, key)
        self.cross_node_bytes += n
        self.staging_dir.record(target.node_id, key, n)
        self._region_waiters.setdefault((target.node_id, dep_uid), [])
        cap = self.cfg.push_inflight_cap_bytes
        if cap is not None:
            self._push_inflight_bytes[target.node_id] = (
                self._push_inflight_bytes.get(target.node_id, 0) + n
            )
        self.pushes += 1
        self.pushed_bytes += n
        t0 = self.now
        ctx = self._t_ctx(si)

        def land(t: float, retried: bool = False) -> None:
            if (
                not retried
                and self.cfg.corrupt_rate > 0.0
                and self._fault_rng.random() < self.cfg.corrupt_rate
            ):
                self.corrupt_detected += 1
                self.cross_node_bytes += n
                self._fluid_start(
                    src, target.node_id, n, lambda t2: land(t2, True)
                )
                return
            if cap is not None:
                self._push_inflight_bytes[target.node_id] -= n
            for w in self._region_waiters.pop((target.node_id, dep_uid), ()):
                w()
            self._t_span(
                "region:push",
                ctx,
                cat="region",
                dur=t - t0,
                tid=f"n{src}" if src is not None else "manager",
                args={"key": dep_uid, "target": target.node_id, "bytes": n},
                ts=t0,
            )

        self._fluid_start(src, target.node_id, n, land)

    def _push_admit(self, target_nid: int, nbytes: int) -> bool:
        """Flow-control admit rule, mirroring the Manager's: a push is
        admitted while the target's in-flight pushed bytes stay within
        the cap; with nothing in flight one push always goes (a single
        region larger than the cap degrades to pull-on-lease, it never
        starves push permanently).  Landed transfers return credits."""
        cap = self.cfg.push_inflight_cap_bytes
        if cap is None:
            return True
        if self.fluid is not None:
            # Event engine: the ledger is exact — credits return in
            # the landing callbacks, no lazy time-based cleaning.
            inflight = self._push_inflight_bytes.get(target_nid, 0)
            return inflight == 0 or inflight + nbytes <= cap
        q = self._push_inflight.setdefault(target_nid, [])
        q[:] = [(t, b) for (t, b) in q if t > self.now]
        inflight = sum(b for _, b in q)
        return inflight == 0 or inflight + nbytes <= cap

    # -- gray-failure resilience: health scoring, probation, hedging --------------

    def _observe_health(self, nid: int, ratio: float) -> None:
        a = self.cfg.health_alpha
        prev = self._health_ratio.get(nid, 1.0)
        self._health_ratio[nid] = (1.0 - a) * prev + a * ratio
        self._health_n[nid] = self._health_n.get(nid, 0) + 1

    def _health_score(self, nid: int) -> float:
        return self._health_ratio.get(nid, 1.0)

    def _health_weight(self, nid: int) -> float:
        return min(1.0, 1.0 / max(self._health_score(nid), 1e-9))

    def _window_for(self, node: _Node) -> int:
        """Capacity-weighted lease window (mirror of the Manager's
        _window_for_locked): full window when health scoring is off,
        one probe lease under probation — granted only from surplus
        backlog the healthy nodes can't absorb — else the window scaled
        by the node's health weight, never starved below 1."""
        if not self.cfg.health_scoring:
            return self.cfg.window
        if self._node_probation.get(node.node_id):
            healthy_slack = sum(
                max(self.cfg.window - len(n.leased), 0)
                for n in self.nodes
                if n is not node
                and n.alive
                and not self._node_probation.get(n.node_id)
            )
            return 1 if len(self.pending) > healthy_slack else 0
        return max(
            1,
            int(self.cfg.window * self._health_weight(node.node_id) + 1e-9),
        )

    def _update_probation(self, node: _Node) -> None:
        """Advance the probation state machine on a stage completion."""
        nid = node.node_id
        if not self._node_probation.get(nid):
            if (
                self._health_n.get(nid, 0) >= self.cfg.probation_min_samples
                and self._health_score(nid) >= self.cfg.probation_ratio
            ):
                self._enter_probation(node)
            return
        self._node_probes[nid] = self._node_probes.get(nid, 0) + 1
        if (
            self._node_probes[nid] >= 2
            and self._health_score(nid) <= self.cfg.probation_recover_ratio
        ):
            self._node_probation[nid] = False
            self._node_hedged[nid] = 0
            self._health_ratio[nid] = 1.0
            self._health_n[nid] = 0
            self.probation_exits += 1
            self._fill_window(node)

    def _enter_probation(self, node: _Node) -> None:
        """Demote a persistently slow node to one probe lease at a time.

        Its uncovered leases are re-queued immediately (a lease with a
        live hedge/backup twin elsewhere is already covered); op work
        finished on this node for the re-queued stages is abandoned, so
        the re-lease re-runs them on a healthy node."""
        nid = node.node_id
        if self._node_probation.get(nid):
            return
        self._dup_possible = True  # re-queues can double-lease a stage
        self._node_probation[nid] = True
        self._node_probes[nid] = 0
        self._node_hedged[nid] = 0
        self.probations += 1
        for uid in sorted(node.leased):
            self._lease_t0.pop(uid, None)
            if uid in self.stage_done:
                continue
            primary = self._clone_of.get(uid, uid)
            active = ({primary} | set(self._clones.get(primary, ()))) - {uid}
            covered = any(
                a in other.leased
                for other in self.nodes
                if other is not node
                for a in active
            ) or any(p.uid in active for p in self.pending)
            if covered:
                continue
            si = self.cw.stage_instances[primary]
            for oi in si.op_instances:
                if (
                    oi.uid in self.op_done
                    and self.op_location.get(oi.uid, (None,))[0] == nid
                ):
                    self.op_done.discard(oi.uid)
            self.recovered += 1
            self.pending.append(si)
        node.leased.clear()
        for other in self.nodes:
            self._fill_window(other)

    def _pick_hedge_target(self, exclude: int) -> Optional[_Node]:
        """Healthiest live, non-probation node with window headroom."""
        best, best_key = None, None
        for node in self.nodes:
            if (
                node.node_id == exclude
                or not node.alive
                or self._partitioned(node.node_id)
                or self._node_probation.get(node.node_id)
            ):
                continue
            # One overflow slot past the window (mirror of the
            # Manager's rule): saturated fleets keep every healthy
            # window full, and the hedge twin is transient anyway.
            free = self._window_for(node) + 1 - len(node.leased)
            if free <= 0:
                continue
            key = (self._health_weight(node.node_id), free, -node.node_id)
            if best_key is None or key > best_key:
                best, best_key = node, key
        return best

    def _hedge_tick(self) -> None:
        """Periodic latency check (the monitor-loop mirror): any lease
        older than its stage's p99 completed duration x hedge_slack
        gets a twin on the healthiest node — first completion wins."""
        slack = self.cfg.hedge_slack
        for node in self.nodes:
            if not node.alive:
                continue
            for uid in sorted(node.leased):
                if (
                    uid in self.stage_done
                    or uid in self._dup_issued
                    or uid in self._clone_of
                ):
                    continue
                t0 = self._lease_t0.get(uid)
                if t0 is None:
                    continue
                si = self.cw.stage_instances[uid]
                durs = self._stage_durations.get(si.stage.name)
                if durs is None or len(durs) < self.cfg.hedge_min_samples:
                    continue
                p99 = _pct(durs, 0.99)
                age = self.now - t0
                if age <= p99 * slack:
                    continue
                target = self._pick_hedge_target(exclude=node.node_id)
                if target is None:
                    continue  # nobody has slack: retry next tick
                self._dup_issued.add(uid)
                self.duplicated += 1
                self.hedged += 1
                self._issue_clone(target, si)
                if self.cfg.health_scoring:
                    nid = node.node_id
                    self._node_hedged[nid] = self._node_hedged.get(nid, 0) + 1
                    p50 = _pct(durs, 0.50)
                    if p50 > 0.0:
                        # An eaten hedge is itself a slowness sample —
                        # it lands before the (late) completion would.
                        self._observe_health(nid, age / p50)
                    if (
                        not self._node_probation.get(nid)
                        and self._node_hedged[nid]
                        >= self.cfg.probation_after_hedges
                    ):
                        self._enter_probation(node)
                        break  # this node's leases were just re-queued
        if self._events or self.pending or any(n.leased for n in self.nodes):
            self._post(
                self.now + self._hedge_interval, self._hedge_tick, "heartbeat"
            )

    def _issue_clone(self, node: _Node, si: StageInstance) -> None:
        """Lease a backup/hedge twin of ``si`` onto ``node``."""
        self._dup_possible = True
        clone = self.cw._new_stage_instance(si.chunk, si.stage)  # noqa: SLF001
        self._clone_of[clone.uid] = si.uid
        self._clones.setdefault(si.uid, []).append(clone.uid)
        node.leased.add(clone.uid)
        self.stage_node[clone.uid] = node.node_id
        self._lease_t0[clone.uid] = self.now
        self._post(
            self.now + self.cfg.dispatch_latency,
            lambda node=node, clone=clone: self._start_stage(node, clone),
            "lease",
        )

    # -- fault tolerance / stragglers ---------------------------------------------

    def _kill_node(self, nid: int) -> None:
        node = self.nodes[nid]
        node.alive = False
        self._dup_possible = True  # re-queues can double-lease a stage
        self.staging_dir.drop_worker(nid)  # its staged replicas are gone
        lost = sorted(uid for uid in node.leased if uid not in self.stage_done)
        node.leased.clear()

        def release() -> None:  # heartbeat timeout, then re-lease
            for uid in lost:
                if uid in self.stage_done:
                    continue
                si = self.cw.stage_instances[uid]
                # Work executed on the dead node is gone: reset its ops.
                for oi in si.op_instances:
                    if (
                        oi.uid in self.op_done
                        and self.op_location.get(oi.uid, (None,))[0] == nid
                    ):
                        self.op_done.discard(oi.uid)
                self.recovered += 1
                self.pending.append(si)
            for other in self.nodes:
                self._fill_window(other)

        self._post(self.now + self.cfg.heartbeat_timeout, release, "heartbeat")

    def _maybe_backup_tasks(self) -> None:
        """Tail-of-run straggler mitigation: when the global queue is
        empty and a node idles, duplicate an outstanding lease from
        another node (first completion wins, the twin is cancelled)."""
        if not self.cfg.backup_tasks or self.pending:
            return
        idle = [
            n
            for n in self.nodes
            if n.alive
            and not n.leased
            and not n.scheduler
            and n.inflight_ops == 0
            and not self._node_probation.get(n.node_id)
        ]
        if not idle:
            return
        outstanding = [
            self.cw.stage_instances[uid]
            for n in self.nodes
            for uid in n.leased
            if uid not in self.stage_done
            and uid not in self._dup_issued
            and uid not in self._clone_of
        ]
        # Each idle node absorbs up to a window of backup clones — the
        # whole straggler tail re-executes in parallel on healthy nodes.
        it = iter(outstanding)
        for node in idle:
            for _ in range(self.cfg.window):
                si = next(it, None)
                if si is None:
                    return
                self._dup_issued.add(si.uid)
                self.duplicated += 1
                self._issue_clone(node, si)


def run_simulation(
    n_tiles: int,
    cfg: SimConfig,
    workflow_builder: Callable[[], AbstractWorkflow] | None = None,
) -> SimResult:
    if workflow_builder is not None:
        builder = workflow_builder
    elif not cfg.pipelined:
        builder = monolithic_workflow
    else:
        builder = lambda: segmentation_feature_workflow(cfg.fused_features)  # noqa: E731
    if cfg.arrival_rate is not None:
        # Serving mode: the gateway instantiates pipeline replicas per
        # arrival; start from an empty concrete workflow.
        cw = ConcreteWorkflow(builder())
        return ClusterSim(cw, cfg).run()
    tiles = make_tiles(n_tiles, seed=cfg.seed)
    cw = ConcreteWorkflow.replicate(builder(), tiles)
    return ClusterSim(cw, cfg).run()
