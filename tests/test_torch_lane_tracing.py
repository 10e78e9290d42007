"""Lane tracing of the port's in-process main path: a ``Manager`` and one
``WorkerRuntime`` (one ``gpu`` lane, PATS, locality, tiles leased in
order as the benchmark's cells lease them) over 256x256 tiles, the
``gpu`` variants on the CPU, under a ``Tracer``; and the same untraced.

The checks of time are checks of order only: each compares two instants
taken in that order on one thread, so a loaded machine cannot fail them.
The card's test runs one 4096x4096 tile with torch's sync debug mode at
``error``: every blocking read outside ``host_sync`` would raise.
"""

import gc
import time

import numpy as np
import pytest
import torch

from repro_torch.app import build_workflow, register_variants, synth_tile
from repro_torch.app._device import SYNCS
from repro_torch.core import (
    ConcreteWorkflow,
    DataChunk,
    LaneSpec,
    Manager,
    ManagerConfig,
    VariantRegistry,
    WorkerRuntime,
)
from repro_torch.telemetry import Tracer, use_context
from repro_torch.telemetry.lanes import current_op

NEW_SPANS = {"wait:op", "wait:lease", "lane:between", "sync", "gc"}


def _run(tiles, device="cpu", tracer=None, on_op_start=None, before_stop=None, fused=False):
    """The bag through one gpu lane; returns the workflow, the runtime,
    the rise of ``SYNCS`` over the run and ``before_stop``'s result."""
    reg = register_variants(VariantRegistry(), device=device)
    cw = ConcreteWorkflow.replicate(
        build_workflow(fused=fused), [DataChunk(i, payload=t) for i, t in enumerate(tiles)])
    for si in cw.stage_instances.values():
        si.deadline = float(si.chunk.chunk_id)
    rt = WorkerRuntime(0, lanes=(LaneSpec("gpu", 0),), policy="pats", locality=True,
                       variant_registry=reg, tracer=tracer)
    rt.on_op_start = on_op_start
    mgr = Manager(cw, ManagerConfig(window=2, backup_tasks=False), tracer=tracer)
    mgr.register_worker(rt)
    root = tracer.start_trace() if tracer is not None else None
    syncs = sum(SYNCS.values())
    rt.start()
    try:
        with use_context(root):
            assert mgr.run(timeout=300.0), rt.errors[:3]
        syncs = sum(SYNCS.values()) - syncs
        extra = before_stop(rt) if before_stop is not None else None
    finally:
        rt.stop()
    if rt.errors:
        raise rt.errors[0][1]
    return cw, rt, syncs, extra


@pytest.fixture(scope="module")
def traced():
    callbacks = list(gc.callbacks)
    tracer = Tracer("test", sample_rate=1.0, capacity=1 << 16, seed=7)

    def collect(rt):
        installed = [cb for cb in gc.callbacks if cb not in callbacks]
        t = time.time()
        gc.collect()
        return installed, t

    tiles = [synth_tile(i, size=256, seed=5) for i in range(2)]
    cw, rt, syncs, (installed, t_collect) = _run(tiles, tracer=tracer, before_stop=collect)
    after_stop = list(gc.callbacks)
    t_after = time.time()
    gc.collect()
    return dict(cw=cw, spans=tracer.spans(), syncs=syncs, installed=installed,
                t_collect=t_collect, t_after=t_after, callbacks=callbacks,
                after_stop=after_stop)


def _by(spans, name):
    return [s for s in spans if s["name"] == name]


def _op_spans(spans):
    return {s["args"]["uid"]: s for s in spans if s["name"].startswith("op:")}


def test_every_op_waits_once_between_its_lease_and_its_start(traced):
    spans, cw = traced["spans"], traced["cw"]
    ops = _op_spans(spans)
    leases = {s["args"]["uid"]: s for s in _by(spans, "stage:lease")}
    waits: dict[int, list] = {}
    for s in _by(spans, "wait:op"):
        waits.setdefault(s["args"]["uid"], []).append(s)
    assert set(ops) == set(cw.op_instances)
    assert set(waits) == set(ops)
    for uid, oi in cw.op_instances.items():
        (w,) = waits[uid]
        assert w["args"]["chunk"] == oi.chunk.chunk_id and w["args"]["op"] == oi.op.name
        assert w["ts"] >= leases[oi.stage_instance.uid]["ts"]
        assert w["ts"] + w["dur"] <= ops[uid]["ts"]


def test_every_features_stage_waits_for_its_lease_once(traced):
    features = [si for si in traced["cw"].stage_instances.values() if si.stage.name == "features"]
    leases = [s for s in _by(traced["spans"], "wait:lease") if s["args"]["stage"] == "features"]
    assert sorted(s["args"]["uid"] for s in leases) == sorted(si.uid for si in features)
    assert all(s["args"]["chunk"] == traced["cw"].stage_instances[s["args"]["uid"]].chunk.chunk_id
               for s in leases)


def test_lane_between_ops_starts_at_an_ops_end(traced):
    spans = traced["spans"]
    ops = _op_spans(spans)
    starts = sorted(s["ts"] for s in ops.values())
    between = _by(spans, "lane:between")
    assert len(between) == len(ops) - 1  # every op but the lane's last
    for b in between:
        op = ops[b["args"]["uid"]]
        assert b["ts"] == op["ts"] + op["dur"]
        assert b["args"]["chunk"] == traced["cw"].op_instances[b["args"]["uid"]].chunk.chunk_id
        assert any(t >= b["ts"] for t in starts)  # a later op started after it


def test_sync_spans_are_the_counters_rise(traced):
    spans = traced["spans"]
    syncs = _by(spans, "sync")
    assert len(syncs) == traced["syncs"] > 0
    ops = _op_spans(spans)
    sites = {s["args"]["site"] for s in syncs}
    assert {"label_sweep", "watershed_sweep", "bincount", "to_host", "upload",
            "n_objects"} <= sites
    for s in syncs:
        op = ops[s["args"]["uid"]]
        assert s["ts"] >= op["ts"] and s["args"]["chunk"] == traced["cw"].op_instances[
            s["args"]["uid"]].chunk.chunk_id


def test_gc_is_traced_only_while_the_runtime_runs(traced):
    assert len(traced["installed"]) == 1
    assert traced["after_stop"] == traced["callbacks"]
    pauses = _by(traced["spans"], "gc")
    assert any(s["args"]["generation"] == 2 and s["ts"] >= traced["t_collect"] for s in pauses)
    assert not any(s["ts"] >= traced["t_after"] for s in pauses)
    assert all("chunk" not in s["args"] for s in pauses)


def test_no_new_span_is_an_op_span(traced):
    names = {s["name"] for s in traced["spans"]}
    ops = {f"op:{oi.op.name}" for oi in traced["cw"].op_instances.values()}
    assert {n for n in names if n.startswith("op:")} == ops
    assert NEW_SPANS <= names


def test_untraced_run_records_nothing_and_installs_nothing():
    callbacks = list(gc.callbacks)
    seen = []
    cw, rt, syncs, during = _run(
        [synth_tile(0, size=256, seed=5)],
        on_op_start=lambda rt, oi: seen.append(current_op()),
        before_stop=lambda rt: list(gc.callbacks))
    assert rt._lanes_trace is None
    assert during == callbacks == list(gc.callbacks)
    assert len(seen) == len(cw.op_instances) and not any(seen)
    assert syncs > 0  # counted untraced too
    assert not any(hasattr(oi, "_ready_at") for oi in cw.op_instances.values())


@pytest.mark.gpu
@pytest.mark.parametrize("fused", [False, True])
def test_every_blocking_read_on_the_card_goes_through_host_sync(fused):
    """One 4096x4096 tile's ops on the card, traced, with the sync debug
    mode at ``error``, lifted only inside ``host_sync``: the run completes,
    so no blocking read escapes the count; each op notes its allocator
    counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tile = np.tile(synth_tile(0, size=512, seed=5), (8, 8, 1))
    tracer = Tracer("test", sample_rate=1.0, capacity=1 << 16, seed=7)
    torch.cuda.init()
    torch.cuda.set_sync_debug_mode("error")
    try:
        cw, _, syncs, _ = _run([tile], device="cuda", tracer=tracer, fused=fused)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    spans = tracer.spans()
    assert len(_by(spans, "sync")) == syncs > 0
    between = _by(spans, "lane:between")
    assert between and all("allocs" in s["args"] and "retries" in s["args"] for s in between)
    print({s: sum(1 for x in _by(spans, "sync") if x["args"]["site"] == s)
           for s in sorted({x["args"]["site"] for x in _by(spans, "sync")})})
