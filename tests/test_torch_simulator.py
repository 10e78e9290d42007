"""The port's cluster layer (byte-identical copies of the JAX package's
``core/simulator.py`` and ``core/network.py``) against the reference:
the same ``SimConfig`` gives the same result, float for float; the
network topologies give the same transfer times; and the lane model
that sizes adaptive micro-batches cancels, so the H100 lane needs no
runtime or simulator of its own."""

from __future__ import annotations

import dataclasses
import heapq
import itertools

import numpy as np
import pytest

import repro.core as ref_core
import repro.core.network as ref_net
import repro_torch.core as port_core
import repro_torch.core.network as port_net
from repro_torch.core.cost_model import (
    HOST_CORE,
    TPU_V5E,
    batched_runtime,
    op_cost_from_seconds,
    optimal_micro_batch,
    predicted_runtime,
)
from repro_torch.launch.costs_h100 import H100_SXM

#: name -> (tiles, SimConfig keyword arguments). Serving mode ignores the
#: tile count: its requests arrive on the seeded Poisson clock.
CONFIGS = {
    "pats": (100, dict(policy="pats", window=17)),
    "fcfs": (100, dict(policy="fcfs", window=15)),
    "pats_dl_prefetch": (100, dict(policy="pats", window=15, locality=True, prefetch=True)),
    "chaining": (100, dict(policy="pats", window=15, chaining=True, micro_batch=4)),
    "adaptive_batch": (200, dict(n_nodes=4, policy="fcfs", window=15, micro_batch=8,
                                 adaptive_batch=True, launch_overhead=0.01,
                                 batch_latency_budget=0.3)),
    "fused_features": (100, dict(policy="pats", window=15, fused_features=True)),
    "fat_tree": (200, dict(n_nodes=8, policy="pats", window=15, staging=True,
                           staging_locality=False, network="fat_tree", rack_size=2)),
    "failure_straggler_backup": (200, dict(n_nodes=8, policy="pats", window=15,
                                           locality=True, prefetch=True,
                                           fail_node_at=(3, 10.0), heartbeat_timeout=2.0,
                                           straggler_factor={7: 6.0}, backup_tasks=True)),
    "telemetry": (60, dict(n_nodes=2, staging=True, predictive_push=True, telemetry=True,
                           seed=3)),
    "serving": (1, dict(n_nodes=2, arrival_rate=5.0, serve_duration_s=0.5,
                        tenants={"t0": 1.0}, deadline_ms=5000.0,
                        admission_queue_cap=64, seed=1)),
}


def _run(core, name):
    n, kw = CONFIGS[name]
    return core.run_simulation(n, core.SimConfig(**kw))


@pytest.mark.parametrize("name", CONFIGS)
def test_simulation_equals_the_reference(name):
    got, want = _run(port_core, name), _run(ref_core, name)
    assert got.completed_ok and want.completed_ok
    assert got.makespan == want.makespan
    assert got.tiles_per_second == want.tiles_per_second
    assert got.gpu_fraction_by_op() == want.gpu_fraction_by_op()
    assert got.recovered_leases == want.recovered_leases
    assert got.duplicated_leases == want.duplicated_leases
    # Every other field too (spans by count and name: their ids are fresh).
    g, w = dataclasses.asdict(got), dataclasses.asdict(want)
    g_spans, w_spans = g.pop("spans"), w.pop("spans")
    assert g == w
    assert len(g_spans) == len(w_spans)
    assert sorted(s["name"] for s in g_spans) == sorted(s["name"] for s in w_spans)
    # Each configuration reaches the code it names.
    reached = {
        "pats_dl_prefetch": got.reuse_hits > 0,
        "chaining": got.batches > 0 and got.reuse_hits > 0,
        "adaptive_batch": got.batches > 0,
        "fused_features": "feature_fused" in got.profile,
        "fat_tree": got.cross_rack_bytes > 0 and got.uplink_busy_s > 0,
        "failure_straggler_backup": got.recovered_leases > 0 and got.duplicated_leases > 0,
        "telemetry": len(g_spans) > 0,
        "serving": got.requests > 0 and got.latency_p99 is not None,
    }
    assert reached.get(name, True), name


class _Clock:
    """A manual event clock driving a ``FluidNetwork``."""

    def __init__(self, net_mod, topo) -> None:
        self.t = 0.0
        self._heap: list = []
        self._seq = itertools.count()
        self.net = net_mod.FluidNetwork(topo, now=lambda: self.t, post=self._post)

    def _post(self, t, fn) -> None:
        heapq.heappush(self._heap, (t, next(self._seq), fn))

    def run(self) -> None:
        while self._heap:
            t, _, fn = heapq.heappop(self._heap)
            self.t = max(self.t, t)
            fn()


def _flows(net_mod, kind, seed):
    """Seeded flows (some relayed) started at seeded times through a
    ``FluidNetwork`` over ``build_network(kind, ...)``; then seeded
    store-and-forward transfers on a fresh topology. Returns every
    completion time and the byte and busy counters."""
    rng = np.random.default_rng(seed)
    n_nodes = 8
    topo = net_mod.build_network(kind, n_nodes, 1.5, rack_size=4, oversubscription=3.0,
                                 coordinator_gb_s=2.0)
    clock = _Clock(net_mod, topo)
    done: dict[int, float] = {}
    for i in range(40):
        src = None if i % 11 == 0 else int(rng.integers(n_nodes))
        dst = int(rng.integers(n_nodes))
        nbytes = int(rng.integers(1, 64)) * 2**20
        relay = bool(rng.integers(4) == 0)
        t0 = float(rng.uniform(0.0, 0.5))

        def start(i=i, src=src, dst=dst, nbytes=nbytes, relay=relay):
            clock.net.start(src, dst, nbytes, lambda t, i=i: done.__setitem__(i, t),
                            relay=relay)

        clock._post(t0, start)
    clock.run()
    reserve = net_mod.build_network(kind, n_nodes, 1.5, rack_size=4, oversubscription=3.0)
    times = []
    for _ in range(40):
        src, dst = int(rng.integers(n_nodes)), int(rng.integers(n_nodes))
        times.append(reserve.transfer(src, dst, int(rng.integers(1, 64)) * 2**20,
                                      float(rng.uniform(0.0, 2.0))))
        times.append(reserve.relay(src, dst, 2**20, 0.0))
    return dict(done=done, reserve=times, fluid_stats=topo.stats(), reserve_stats=reserve.stats(),
                delivered=clock.net.bytes_delivered, rack=[reserve.rack_of(i) for i in range(n_nodes)])


@pytest.mark.parametrize("kind", ["flat", "fat_tree"])
@pytest.mark.parametrize("seed", [0, 1])
def test_network_model_equals_the_reference(kind, seed):
    got, want = _flows(port_net, kind, seed), _flows(ref_net, kind, seed)
    assert len(got["done"]) == 40
    assert got == want
    assert type(port_net.build_network(kind, 8, 1.0)).__name__ == type(
        ref_net.build_network(kind, 8, 1.0)).__name__


#: Per-item seconds, latency budgets and launch overheads of the lane test:
#: values whose batched runtimes never land on a budget (checked below).
ITEM_SECONDS = np.geomspace(3.1e-5, 1.7, 40)
BUDGETS = (0.0173, 0.117, 0.531, 2.29)
OVERHEADS = (0.0, 0.00137)
LANES = (TPU_V5E, H100_SXM, HOST_CORE)


def test_micro_batch_size_does_not_depend_on_the_lane():
    """``op_cost_from_seconds(s, lane)`` builds a cost whose roofline time
    on ``lane`` is ``s``, so ``optimal_micro_batch`` on that lane sees
    ``overhead + B * s`` whatever the lane: the worker's ``_batch_limit``
    and the simulator's ``_op_batchable`` (both on ``TPU_V5E``) size the
    same batch as the H100 lane or a host core would."""
    cases = 0
    for s in ITEM_SECONDS:
        for budget in BUDGETS:
            for overhead in OVERHEADS:
                # Off exact ties: every candidate batch misses the budget by
                # far more than the rounding of s through a lane's rates.
                margins = [abs(overhead + b * s - budget) / budget for b in range(1, 65)]
                assert min(margins) > 1e-6, (s, budget, overhead)
                sizes = set()
                for lane in LANES:
                    cost = op_cost_from_seconds(s, lane)
                    assert predicted_runtime(cost, lane) == pytest.approx(s, rel=1e-12)
                    assert batched_runtime(cost, lane, 3, overhead) == pytest.approx(
                        overhead + 3 * s, rel=1e-12)
                    sizes.add(optimal_micro_batch(cost, lane, overhead, budget))
                assert len(sizes) == 1, (s, budget, overhead, sizes)
                cases += 1
    assert cases == len(ITEM_SECONDS) * len(BUDGETS) * len(OVERHEADS)
    # The grid reaches both ends: unbatched and the cap.
    sizes = {optimal_micro_batch(op_cost_from_seconds(s, H100_SXM), H100_SXM, 0.0, b)
             for s in ITEM_SECONDS for b in BUDGETS}
    assert 1 in sizes and 64 in sizes

