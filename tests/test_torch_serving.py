"""The port's serving front end (byte-identical copies of the JAX
package's ``serving/*``) over its own Manager and buses: the arrival
generator agrees with the reference, the gateway admits, sheds and
orders by weight, and a remote tenant submits and polls over a bus."""

from __future__ import annotations

import threading
import time

import pytest
import torch

import repro.serving as ref_serving
import repro_torch.transport as T
from repro_torch.core import (
    AbstractWorkflow,
    ConcreteWorkflow,
    DataChunk,
    LaneSpec,
    Manager,
    ManagerConfig,
    Operation,
    Stage,
    VariantRegistry,
    WorkerRuntime,
)
from repro_torch.serving import (
    DONE,
    FAILED,
    SHED,
    GatewayConfig,
    RequestGateway,
    WorkloadConfig,
    generate_arrivals,
    zipf_weights,
)


def test_workload_generator_deterministic_and_equal_to_the_reference():
    kw = dict(arrival_rate=200.0, duration_s=0.5, tenants={"a": 2.0, "b": 1.0},
              deadline_ms=100.0, seed=42)
    a1 = generate_arrivals(WorkloadConfig(**kw))
    assert a1 == generate_arrivals(WorkloadConfig(**kw))
    assert a1 != generate_arrivals(WorkloadConfig(**{**kw, "seed": 43}))
    ref = ref_serving.generate_arrivals(ref_serving.WorkloadConfig(**kw))
    assert [(x.t, x.tenant, x.tile, x.deadline_s) for x in a1] == [
        (x.t, x.tenant, x.tile, x.deadline_s) for x in ref]
    assert all(x.t <= y.t for x, y in zip(a1, a1[1:]))
    assert {x.tenant for x in a1} == {"a", "b"}


def test_zipf_popularity_skews_to_head():
    w = zipf_weights(64, 1.1)
    assert abs(sum(w) - 1.0) < 1e-9
    assert w == ref_serving.zipf_weights(64, 1.1)
    arr = generate_arrivals(WorkloadConfig(arrival_rate=2000.0, duration_s=1.0,
                                           n_tiles=64, zipf_alpha=1.1, seed=7))
    top = sum(1 for a in arr if a.tile < 8)
    assert top / len(arr) > 0.4


def _serving_registry(delay_s=0.002, stall_worker0=None, poison=None):
    reg = VariantRegistry()

    def work(ctx):
        if stall_worker0 is not None and threading.current_thread().name.startswith("worker0-"):
            assert stall_worker0.wait(timeout=30.0)
        if ctx.chunk.chunk_id == poison:
            raise RuntimeError("poison tile")
        time.sleep(delay_s)
        # A tensor result: what crosses the bus when the worker is remote.
        return torch.full((4,), float(ctx.chunk.chunk_id))

    reg.register("work", "cpu", work)
    return reg


def _serving_manager(reg, n_workers=1, **cfg_kwargs):
    wf = AbstractWorkflow.chain("serve", [Stage.single(Operation("work"))])
    mgr = Manager(ConcreteWorkflow(wf), ManagerConfig(window=4, backup_tasks=False, **cfg_kwargs))
    workers = []
    for wid in range(n_workers):
        rt = WorkerRuntime(wid, lanes=(LaneSpec("cpu", 0),), variant_registry=reg)
        rt.start()
        mgr.register_worker(rt)
        workers.append(rt)
    return mgr, workers


def test_gateway_admission_sheds_beyond_queue_cap():
    mgr, workers = _serving_manager(_serving_registry(delay_s=0.01))
    gw = RequestGateway(mgr, GatewayConfig(max_queue=4, max_inflight=1), tenants={"t": 1.0})
    try:
        reqs = [gw.submit("t", DataChunk(i)) for i in range(30)]
        shed = [r for r in reqs if r.state == SHED]
        assert shed
        assert gw.stats.admitted + gw.stats.shed == gw.stats.submitted == 30
        assert gw.close(timeout=60.0)
        assert gw.stats.completed == gw.stats.admitted
        assert all(r.t_dispatch is None for r in shed)
    finally:
        for rt in workers:
            rt.stop()


def test_gateway_wfq_dispatch_order_follows_weights():
    gate = threading.Event()
    mgr, workers = _serving_manager(_serving_registry(delay_s=0.0, stall_worker0=gate))
    gw = RequestGateway(mgr, GatewayConfig(max_queue=64, max_inflight=1),
                        tenants={"warm": 1.0, "a": 3.0, "b": 1.0})
    try:
        gw.submit("warm", DataChunk(999))
        a_reqs = [gw.submit("a", DataChunk(i)) for i in range(6)]
        b_reqs = [gw.submit("b", DataChunk(100 + i)) for i in range(2)]
        assert all(r.accepted for r in a_reqs + b_reqs)
        gate.set()
        assert gw.close(timeout=60.0)
        order = sorted(a_reqs + b_reqs, key=lambda r: r.t_dispatch)
        first8 = [r.tenant for r in order[:8]]
        assert first8.count("a") == 6 and first8.count("b") == 2
        assert first8[:3] == ["a", "a", "a"]
    finally:
        gate.set()
        for rt in workers:
            rt.stop()


def test_streaming_manager_is_reusable_between_requests():
    mgr, workers = _serving_manager(_serving_registry(delay_s=0.001))
    gw = RequestGateway(mgr, GatewayConfig(max_queue=8), tenants={"t": 1.0})
    try:
        assert gw.submit("t", DataChunk(0)).wait(timeout=30.0)
        assert mgr._monitor is not None and mgr._monitor.is_alive()
        assert gw.submit("t", DataChunk(1)).wait(timeout=30.0)
        assert gw.close(timeout=30.0)
        assert gw.stats.completed == 2
    finally:
        for rt in workers:
            rt.stop()


@pytest.mark.parametrize("bus_cls", [T.InprocBus, T.SocketBus])
def test_serving_client_submit_and_status_over_bus(bus_cls):
    """The port of the reference's inproc-bus serving test, also over
    real sockets: the worker's tensor results cross the bus."""
    reg = _serving_registry(delay_s=0.001)
    mgr, workers = _serving_manager(reg, n_workers=0)
    endpoint = T.ManagerEndpoint(mgr, bus_cls())
    rt = WorkerRuntime(0, lanes=(LaneSpec("cpu", 0),), variant_registry=reg)
    rt.start()
    workers.append(rt)
    wc = T.WorkerClient(rt, bus_cls(), endpoint.address)
    assert endpoint.wait_workers(1, timeout=30.0)
    gw = RequestGateway(mgr, GatewayConfig(max_queue=64), tenants={"t": 1.0})
    endpoint.attach_gateway(gw)
    client = T.ServingClient(bus_cls(), endpoint.address)
    try:
        acks = [client.submit(i, tenant="t", deadline_ms=5000.0) for i in range(4)]
        assert all(a["ok"] and a["accepted"] for a in acks)
        assert gw.drain(timeout=30.0)
        for a in acks:
            st = client.status(a["req_id"])
            assert st["ok"] and st["state"] == DONE and st["tenant"] == "t"
            assert st["latency"] > 0.0
        assert gw.stats.completed == 4
    finally:
        client.close()
        for w in workers:
            w.stop()
        wc.close()
        endpoint.bus.close()


def test_serving_client_sees_failed_state_and_error_over_bus():
    reg = _serving_registry(delay_s=0.0, poison=13)
    wf = AbstractWorkflow.chain("serve", [Stage.single(Operation("work"))])
    mgr = Manager(ConcreteWorkflow(wf),
                  ManagerConfig(window=4, backup_tasks=False, quarantine_after=2))
    endpoint = T.ManagerEndpoint(mgr, T.InprocBus())
    workers = []
    for wid in range(2):
        rt = WorkerRuntime(wid, lanes=(LaneSpec("cpu", 0),), variant_registry=reg)
        rt.start()
        workers.append(rt)
        T.WorkerClient(rt, T.InprocBus(), endpoint.address)
    assert endpoint.wait_workers(2, timeout=30.0)
    gw = RequestGateway(mgr, GatewayConfig(max_queue=64), tenants={"t": 1.0})
    endpoint.attach_gateway(gw)
    client = T.ServingClient(T.InprocBus(), endpoint.address)
    try:
        ok_ack = client.submit(1, tenant="t")
        bad_ack = client.submit(13, tenant="t")
        assert ok_ack["ok"] and bad_ack["ok"]
        assert gw.drain(timeout=60.0)
        st = client.status(bad_ack["req_id"])
        assert st["ok"] and st["state"] == FAILED and "poison tile" in st["error"]
        st_ok = client.status(ok_ack["req_id"])
        assert st_ok["state"] == DONE and st_ok["error"] is None
    finally:
        client.close()
        for rt in workers:
            rt.stop()
        endpoint.bus.close()
