"""Roofline op cost model — PATS speedup estimates from first principles.

The paper obtains per-operation GPU-vs-CPU speedup estimates by
profiling.  At TPU-pod scale profiling every (op, shape) is impractical,
so this framework *derives* the estimate from a roofline model: an op is
characterized by FLOPs, bytes moved, and (optionally) collective bytes;
a device lane is characterized by peak FLOP/s, memory bandwidth and
link bandwidth.  The predicted runtime is

    t(lane) = max(flops / peak, bytes / mem_bw) + coll_bytes / link_bw

and the PATS estimate for an accelerator lane is
``t(host_core) / t(accel)``.  PATS only needs the *relative order* of
these estimates to be right (paper §V-G shows tolerance to ~60% error),
which a roofline model comfortably delivers.

The same constants feed the §Roofline analysis of the dry-run
(see ``launch/dryrun.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = [
    "LaneModel",
    "OpCost",
    "TPU_V5E",
    "HOST_CORE",
    "predicted_runtime",
    "estimate_speedup",
    "roofline_terms",
    "batched_runtime",
    "batch_amortization",
    "optimal_micro_batch",
    "op_cost_from_seconds",
]


@dataclass(frozen=True)
class LaneModel:
    """Throughput model of one compute lane."""

    name: str
    peak_flops: float        # FLOP/s (dense matmul peak for MXU lanes)
    mem_bw: float            # bytes/s to the lane's fast memory
    link_bw: float = 5e10    # bytes/s per ICI link (collectives)
    vector_flops: float | None = None  # non-MXU (VPU) peak, if different

    def effective_flops(self, mxu_friendly: bool) -> float:
        if mxu_friendly or self.vector_flops is None:
            return self.peak_flops
        return self.vector_flops


#: TPU v5e chip (per spec sheet): 197 TFLOP/s bf16, 819 GB/s HBM,
#: ~50 GB/s/link ICI.  VPU (vector) peak is ~2 orders below the MXU.
TPU_V5E = LaneModel(
    name="tpu_v5e",
    peak_flops=197e12,
    mem_bw=819e9,
    link_bw=50e9,
    vector_flops=4e12,
)

#: One modern host CPU core: ~100 GFLOP/s, ~20 GB/s effective DRAM bw.
HOST_CORE = LaneModel(
    name="host_core", peak_flops=1e11, mem_bw=2e10, link_bw=1e10
)


@dataclass(frozen=True)
class OpCost:
    """Workload characterization of one operation on one data chunk."""

    flops: float
    bytes: float
    coll_bytes: float = 0.0
    mxu_friendly: bool = True  # dense matmul-like (vs gather/scan-like)

    @property
    def intensity(self) -> float:
        return self.flops / max(self.bytes, 1.0)


def predicted_runtime(cost: OpCost, lane: LaneModel) -> float:
    compute = cost.flops / lane.effective_flops(cost.mxu_friendly)
    memory = cost.bytes / lane.mem_bw
    collective = cost.coll_bytes / lane.link_bw
    return max(compute, memory) + collective


def estimate_speedup(
    cost: OpCost, accel: LaneModel = TPU_V5E, host: LaneModel = HOST_CORE
) -> float:
    """PATS estimate: host-core runtime / accelerator runtime."""
    return predicted_runtime(cost, host) / max(
        predicted_runtime(cost, accel), 1e-15
    )


def batched_runtime(
    cost: OpCost,
    lane: LaneModel,
    batch: int,
    launch_overhead: float,
) -> float:
    """Runtime of one batched launch over ``batch`` identical chunks.

    The streaming terms (compute, memory, collectives) scale linearly
    with the batch — a vmapped kernel reads ``batch`` tiles — while the
    fixed dispatch cost (driver launch, JIT cache lookup, control
    round-trip) is paid once.  This is the amortization curve the
    micro-batched dispatcher trades against latency.
    """
    return launch_overhead + batch * predicted_runtime(cost, lane)


def batch_amortization(
    cost: OpCost,
    lane: LaneModel,
    batch: int,
    launch_overhead: float,
) -> float:
    """Speedup of one batched launch vs ``batch`` sequential launches."""
    sequential = batch * (launch_overhead + predicted_runtime(cost, lane))
    return sequential / max(
        batched_runtime(cost, lane, batch, launch_overhead), 1e-15
    )


def optimal_micro_batch(
    cost: OpCost,
    lane: LaneModel,
    launch_overhead: float,
    latency_budget: float,
    max_batch: int = 64,
) -> int:
    """Largest batch whose single-launch latency fits the budget.

    Amortization is monotone in the batch size, so the best batch is
    the largest one the op's latency budget (e.g. the drain tail the
    scheduler can tolerate) still admits.
    """
    best = 1
    for b in range(2, max_batch + 1):
        if batched_runtime(cost, lane, b, launch_overhead) > latency_budget:
            break
        best = b
    return best


def op_cost_from_seconds(
    accel_seconds: float,
    lane: LaneModel = TPU_V5E,
    mxu_friendly: bool = True,
) -> OpCost:
    """Synthesize an :class:`OpCost` whose roofline runtime on ``lane``
    equals a measured / calibrated per-instance runtime.

    The dispatcher knows per-op *seconds* (calibrated profiles, online
    EMAs) rather than flop counts; this adapter lets those timings
    drive the batching curves (``batched_runtime`` /
    ``optimal_micro_batch``) without hand-characterizing every op.
    The cost is compute-bound by construction (memory term at half the
    compute term), which is the regime where batching pays anyway.
    """
    s = max(accel_seconds, 1e-12)
    return OpCost(
        flops=s * lane.effective_flops(mxu_friendly),
        bytes=s * lane.mem_bw / 2.0,
        mxu_friendly=mxu_friendly,
    )


def roofline_terms(
    flops: float,
    bytes_: float,
    coll_bytes: float,
    n_chips: int,
    lane: LaneModel = TPU_V5E,
) -> dict[str, float]:
    """The three §Roofline terms, in seconds, for an n-chip execution."""
    return {
        "compute_s": flops / (n_chips * lane.peak_flops),
        "memory_s": bytes_ / (n_chips * lane.mem_bw),
        "collective_s": coll_bytes / (n_chips * lane.link_bw),
    }
