"""Importable demo workload for multiprocess transport runs.

Spawned worker processes rebuild their VariantRegistry from a
``"module:factory"`` path (locals don't survive ``spawn``), so the
transport tests and benchmarks share this module-level two-stage
pipeline: ``produce`` emits a deterministic tile-sized tensor,
``consume`` reduces it.  Output values depend only on the chunk id,
which is what lets a socket-bus run be compared bit-for-bit against an
inproc run.

The producers return CPU torch tensors (float32; ``fanin_registry``'s
``produce_b`` a bfloat16 one), so every region crosses the wire through
the tensor codec; reductions run in float64, so the ``expected_*``
values are exact.
"""

from __future__ import annotations

import torch

from ..core.variants import VariantRegistry
from ..core.workflow import (
    AbstractWorkflow,
    ConcreteWorkflow,
    DataChunk,
    Operation,
    Stage,
)

__all__ = [
    "demo_registry",
    "demo_slow_registry",
    "busy_registry",
    "dataplane_registry",
    "fanin_registry",
    "demo_workflow",
    "demo_concrete",
    "fanin_workflow",
    "fanin_concrete",
    "expected_consume",
    "expected_dp_consume",
    "expected_dp_combine",
    "expected_combine",
]

_SIDE = 64
#: Data-plane bench tiles: ~4 MB float32 regions — large enough that
#: the cross-worker edge dominates the control plane, small enough
#: that codec CPU does not contend with compute on the bench host.
_DP_SIDE = 1024


def _full(side: int, value: float, dtype=torch.float32) -> torch.Tensor:
    return torch.full((side, side), value, dtype=dtype)


def _sum(x) -> float:
    return float(x.double().sum())


def _mean(x) -> float:
    return float(x.double().mean())


def _produce(ctx) -> torch.Tensor:
    return _full(_SIDE, float(ctx.chunk.chunk_id + 1))


def _produce_slow(ctx) -> torch.Tensor:
    import time

    time.sleep(0.2)  # keep leases outstanding long enough to crash into
    return _produce(ctx)


def _consume(ctx) -> float:
    return _sum(ctx.sole_input())


def expected_consume(chunk_id: int) -> float:
    return float(chunk_id + 1) * _SIDE * _SIDE


def demo_registry() -> VariantRegistry:
    reg = VariantRegistry()
    reg.register("produce", "cpu", _produce)
    reg.register("consume", "cpu", _consume)
    return reg


def demo_slow_registry() -> VariantRegistry:
    """Same pipeline, ~200ms per produce: fault-injection runs need
    leases still in flight when the worker process is killed."""
    reg = VariantRegistry()
    reg.register("produce", "cpu", _produce_slow)
    reg.register("consume", "cpu", _consume)
    return reg


#: ``busy_registry``'s produce runs torch calls this long: past a
#: stopping worker's wait for its lanes (``WorkerRuntime.stop``, 5 s).
_BUSY_S = 10.0


def _produce_busy(ctx) -> torch.Tensor:
    import time

    x = _full(_SIDE, 1.0)
    end = time.monotonic() + _BUSY_S
    while time.monotonic() < end:
        torch.mm(x, x)  # releases the GIL, as a CUDA launch or copy does
    return _produce(ctx)


def busy_registry() -> VariantRegistry:
    """Same pipeline, produce inside torch calls for ``_BUSY_S``
    seconds: a worker stopped meanwhile must wait for its lane before
    its interpreter finalizes."""
    reg = VariantRegistry()
    reg.register("produce", "cpu", _produce_busy)
    reg.register("consume", "cpu", _consume)
    return reg


def _dp_produce(ctx) -> torch.Tensor:
    return _full(_DP_SIDE, float(ctx.chunk.chunk_id + 1))


def _dp_consume(ctx) -> float:
    return _mean(ctx.sole_input())


def expected_dp_consume(chunk_id: int) -> float:
    return float(chunk_id + 1)


#: Simulated compute: sleeps yield the (single) benchmark core to the
#: sibling process, so runs are latency-bound like a real cluster
#: instead of CPU-contention noise.  The asymmetry (slow a, fast b) is
#: the canonical predictive-push shape: b's region finishes early and
#: its transfer toward the combine's predicted worker rides UNDER a's
#: remaining compute — pull-only exposes that same transfer serially
#: after the combine lease lands.
_DP_COMPUTE_A_S = 0.08
_DP_COMPUTE_B_S = 0.01
_DP_COMPUTE_C_S = 0.02


def _dp_produce_a(ctx) -> torch.Tensor:
    import time

    time.sleep(_DP_COMPUTE_A_S)
    return _full(_DP_SIDE, float(ctx.chunk.chunk_id + 1))


def _dp_produce_b(ctx) -> torch.Tensor:
    import time

    time.sleep(_DP_COMPUTE_B_S)
    return _full(_DP_SIDE, float(2 * (ctx.chunk.chunk_id + 1)))


def _dp_combine(ctx) -> float:
    import time

    time.sleep(_DP_COMPUTE_C_S)
    return _mean(ctx.inputs["produce_a"]) + _mean(ctx.inputs["produce_b"])


def expected_dp_combine(chunk_id: int) -> float:
    return float(3 * (chunk_id + 1))


def dataplane_registry() -> VariantRegistry:
    """Transfer-bound variants of the demo pipelines (~4 MB regions,
    sleep-modeled compute): what a produce->consume or fan-in edge
    costs is dominated by where its bytes flow and when they start
    moving, which is exactly what the coordinator-bypass benchmarks
    need to expose.  Serves both ``demo_workflow`` and
    ``fanin_workflow``."""
    reg = VariantRegistry()
    reg.register("produce", "cpu", _dp_produce)
    reg.register("consume", "cpu", _dp_consume)
    reg.register("produce_a", "cpu", _dp_produce_a)
    reg.register("produce_b", "cpu", _dp_produce_b)
    reg.register("combine", "cpu", _dp_combine)
    return reg


def demo_workflow() -> AbstractWorkflow:
    return AbstractWorkflow.chain(
        "transport-demo",
        [Stage.single(Operation("produce")), Stage.single(Operation("consume"))],
    )


def demo_concrete(n_chunks: int) -> ConcreteWorkflow:
    return ConcreteWorkflow.replicate(
        demo_workflow(), [DataChunk(i) for i in range(n_chunks)]
    )


# -- fan-in demo: a guaranteed cross-worker edge ---------------------------
#
# ``combine`` consumes TWO upstream regions; ``produce_b`` is slower than
# ``produce_a``, so on a two-worker cluster (window 1, FIFO) the first
# chunk's a and b deterministically land on different workers and every
# combine has at least one remote input — the data-plane tests and
# benchmarks need cross-worker traffic they can rely on.


def _produce_a(ctx) -> torch.Tensor:
    return _full(_SIDE, float(ctx.chunk.chunk_id + 1))


def _produce_b(ctx) -> torch.Tensor:
    import time

    time.sleep(0.05)
    # bfloat16 holds 2 * (chunk_id + 1) exactly for chunk ids below 128.
    return _full(_SIDE, float(2 * (ctx.chunk.chunk_id + 1)), torch.bfloat16)


def _combine(ctx) -> float:
    return _sum(ctx.inputs["produce_a"]) + _sum(ctx.inputs["produce_b"])


def expected_combine(chunk_id: int) -> float:
    return float(3 * (chunk_id + 1)) * _SIDE * _SIDE


def fanin_registry() -> VariantRegistry:
    reg = VariantRegistry()
    reg.register("produce_a", "cpu", _produce_a)
    reg.register("produce_b", "cpu", _produce_b)
    reg.register("combine", "cpu", _combine)
    return reg


def fanin_workflow() -> AbstractWorkflow:
    return AbstractWorkflow(
        "transport-fanin",
        (
            Stage.single(Operation("produce_a")),
            Stage.single(Operation("produce_b")),
            Stage.single(
                Operation("combine", inputs=("produce_a", "produce_b"))
            ),
        ),
        (("produce_a", "combine"), ("produce_b", "combine")),
    )


def fanin_concrete(n_chunks: int) -> ConcreteWorkflow:
    return ConcreteWorkflow.replicate(
        fanin_workflow(), [DataChunk(i) for i in range(n_chunks)]
    )
