"""The port's fault layer: the seeded plan (its corruption now reaches
torch tensors), the retry policy, the fault-injecting bus, and the CRC
envelope, canonical over tensors and state dicts and equal to the JAX
package's checksum on numpy arrays; end to end, corrupted pulls and
pushes of tensor regions are rejected and recovered."""

from __future__ import annotations

import random
import time

import numpy as np
import pytest
import torch

import repro.faults as ref_faults
import repro_torch.transport as T
import repro_torch.transport.codec as codec_mod
from repro_torch.core import LaneSpec, Manager, ManagerConfig, WorkerRuntime
from repro_torch.faults import FaultPlan, FaultyBus, FaultyPeer, RetryPolicy, region_crc, seal, unseal
from repro_torch.staging import StagingConfig
from repro_torch.staging.store import op_key
from repro_torch.transport.bus import BusError, BusTimeoutError
from repro_torch.transport.demo import expected_combine, fanin_concrete, fanin_registry


def _wait(predicate, timeout: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.005)
    return False


def _state(seed: int = 0) -> dict:
    """A WSI-like state dict: float32, bfloat16, bool and int tensors, a
    numpy feature row and host scalars."""
    g = torch.Generator().manual_seed(seed)
    return {
        "hema": torch.rand(16, 16, generator=g),
        "gray": torch.rand(16, 16, generator=g).to(torch.bfloat16),
        "mask": torch.rand(16, 16, generator=g) > 0.5,
        "objects": torch.randint(0, 9, (16, 16), generator=g, dtype=torch.int32),
        "feat_pixel": np.arange(12, dtype=np.float32).reshape(3, 4),
        "n_objects": 3,
        "scale": 0.5,
        "names": ["hema", "eosin"],
    }


# --------------------------------------------------------------------------
# FaultPlan
# --------------------------------------------------------------------------


def test_fault_plan_same_seed_same_schedule():
    mk = lambda s: FaultPlan(seed=s, drop_notify=0.3, dup_notify=0.2)
    a, b, c = mk(5), mk(5), mk(6)
    seq = lambda p: [(p.should_drop("m"), p.should_dup("m")) for _ in range(300)]
    sa = seq(a)
    assert sa == seq(b)
    assert sa != seq(c)
    assert any(x[0] for x in sa) and not all(x[0] for x in sa)


def test_fault_plan_immune_methods_never_faulted():
    p = FaultPlan(seed=1, drop_notify=1.0, fail_call=1.0)
    assert not p.should_drop("shutdown")
    assert not p.should_fail_call("stop")
    assert p.should_drop("submit_stage")


def test_fault_plan_kill_fires_once_and_partition_windows():
    p = FaultPlan().kill_at("worker0", 0.0).partition("mgr", 0.0, 0.2)
    p.start()
    assert p.kill_due("worker0-peer")
    assert not p.kill_due("worker0-peer")
    assert not p.kill_due("worker1-peer")
    assert p.partitioned("mgr-ctl")
    assert not p.partitioned("worker0")
    assert _wait(lambda: not p.partitioned("mgr-ctl"), timeout=5.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.bool, torch.uint8],
                         ids=lambda d: str(d).removeprefix("torch."))
def test_fault_plan_corrupts_a_copy_of_a_tensor(dtype):
    p = FaultPlan(seed=3, corrupt_rate=1.0)
    t = torch.zeros((4, 4), dtype=dtype)
    out = p.maybe_corrupt("pull_regions", t)
    assert out is not t and isinstance(out, torch.Tensor)
    assert out.dtype == dtype and out.shape == t.shape
    assert not torch.equal(out.view(torch.uint8), t.view(torch.uint8))
    assert not t.view(torch.uint8).any()  # the original is untouched
    assert p.maybe_corrupt("stage_complete", t) is t  # control plane: never


def test_fault_plan_corrupts_a_non_contiguous_tensor_view():
    p = FaultPlan(seed=4, corrupt_rate=1.0)
    base = torch.zeros((6, 8, 3))
    view = base[..., 1]
    out = p.maybe_corrupt("push_region", view)
    assert out.shape == view.shape and not torch.equal(out, view)
    assert not base.any()


def test_fault_plan_corrupts_inside_sealed_tensor_dicts():
    p = FaultPlan(seed=5, corrupt_rate=1.0)
    state = _state()
    env = p.maybe_corrupt("push_region", seal(state))
    value, ok = unseal(env)
    assert not ok
    assert unseal(seal(state))[1]
    # Exactly one tensor differs, in one byte; the sender's dict is intact.
    diffs = [k for k, v in state.items() if isinstance(v, torch.Tensor)
             and not torch.equal(v.view(torch.uint8), value[k].view(torch.uint8))]
    assert len(diffs) == 1
    assert region_crc(state) == region_crc(_state())


def test_fault_plan_corrupts_numpy_as_the_reference():
    for plan in (FaultPlan(seed=3, corrupt_rate=1.0),
                 ref_faults.FaultPlan(seed=3, corrupt_rate=1.0)):
        arr = np.zeros((4, 4), np.float32)
        out = plan.maybe_corrupt("pull_regions", arr)
        assert out is not arr and not np.array_equal(out, arr)
        assert float(arr.sum()) == 0.0
    a = FaultPlan(seed=7, corrupt_rate=1.0).maybe_corrupt("pull_regions", np.zeros(64))
    b = ref_faults.FaultPlan(seed=7, corrupt_rate=1.0).maybe_corrupt(
        "pull_regions", np.zeros(64))
    np.testing.assert_array_equal(a, b)


def test_fault_plan_op_hook_poison_and_crash():
    p = FaultPlan()
    hook = p.op_hook(poison_chunks=(7,), crash_worker_at_op={1: 2})

    class _Rt:
        worker_id = 1
        killed = False

        def kill(self):
            self.killed = True

    class _Oi:
        def __init__(self, cid):
            self.stage_instance = type(
                "S", (), {"chunk": type("C", (), {"chunk_id": cid})()}
            )()

    rt = _Rt()
    with pytest.raises(RuntimeError, match="poison chunk 7"):
        hook(rt, _Oi(7))
    assert not rt.killed
    hook(rt, _Oi(0))
    with pytest.raises(RuntimeError, match="injected crash"):
        hook(rt, _Oi(0))
    assert rt.killed


def test_fault_plan_staging_seams_on_tensors():
    p = FaultPlan(seed=2)
    fetch = p.wrap_fetch(lambda k: "v", error_rate=1.0)
    with pytest.raises(IOError):
        fetch("k")
    assert p.wrap_fetch(lambda k: "v", error_rate=0.0)("k") == "v"
    corrupting = FaultPlan(seed=2, corrupt_rate=1.0)
    dial = corrupting.wrap_dial(
        lambda holder, keys: [seal(torch.ones(8, dtype=torch.bfloat16)) for _ in keys]
    )
    (env,) = dial((1, "addr"), [op_key(0)])
    assert not unseal(env)[1]


# --------------------------------------------------------------------------
# RetryPolicy
# --------------------------------------------------------------------------


def test_retry_policy_backoff_is_bounded():
    pol = RetryPolicy(attempts=5, base_delay=0.05, max_delay=0.4, jitter=0.25)
    rng = random.Random(0)
    for attempt in range(1, 10):
        assert 0.0 < pol.delay(attempt, rng) <= 0.4 * 1.25


def test_retry_policy_retries_timeouts_only():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise BusTimeoutError("transient")
        return "ok"

    pol = RetryPolicy(attempts=4, base_delay=0.001, max_delay=0.002)
    assert pol.run(flaky) == "ok"
    assert calls["n"] == 3

    def wrong():
        calls["n"] += 1
        raise ValueError("handler bug")

    calls["n"] = 0
    with pytest.raises(ValueError):
        pol.run(wrong)
    assert calls["n"] == 1


def test_retry_policy_exhausts_budget_then_raises():
    calls = {"n": 0}

    def dead():
        calls["n"] += 1
        raise BusTimeoutError("gone")

    with pytest.raises(BusTimeoutError):
        RetryPolicy(attempts=3, base_delay=0.001, max_delay=0.002).run(dead)
    assert calls["n"] == 3


# --------------------------------------------------------------------------
# CRC32 envelope
# --------------------------------------------------------------------------


def test_crc_of_numpy_equals_the_reference():
    rng = np.random.default_rng(0)
    for arr in (rng.standard_normal((8, 8)).astype(np.float32),
                np.arange(10, dtype=np.int64)[::3], rng.random((5, 3)) > 0.5,
                np.zeros((0, 4), np.uint8), np.array(2.5),
                np.asfortranarray(rng.standard_normal((4, 6)))):
        assert region_crc(arr) == ref_faults.region_crc(arr)
        assert seal(arr)[1] == ref_faults.seal(arr)[1]


def test_crc_envelope_roundtrip_detects_flips_and_passes_legacy():
    t = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    value, ok = unseal(seal(t))
    assert ok and torch.equal(value, t)
    tag, crc, payload = seal(t)
    bad = payload.clone()
    bad.view(torch.uint8).reshape(-1)[5] ^= 0xFF
    assert not unseal((tag, crc, bad))[1]
    value, ok = unseal(t)
    assert ok and value is t
    assert region_crc({"a": 1}) == region_crc({"a": 1})
    assert region_crc({"a": 1}) != region_crc({"a": 2})
    # dtype and shape are part of the checksum, not just the bytes.
    assert region_crc(torch.zeros(4)) != region_crc(torch.zeros(2, dtype=torch.float64))
    assert region_crc(torch.zeros(4)) != region_crc(torch.zeros(2, 2))
    assert region_crc(torch.zeros(2, dtype=torch.bfloat16)) != region_crc(
        torch.zeros(2, dtype=torch.float16))


def test_crc_is_canonical():
    """Equal values hash equal however they are laid out or typed on
    the way: key order, list or tuple, a strided view or its copy,
    ``np.float64`` or ``float``; a flipped byte anywhere is caught."""
    state = _state()
    again = dict(reversed(list(_state().items())))
    assert region_crc(state) == region_crc(again)
    assert region_crc([1, "a"]) == region_crc((1, "a"))
    base = torch.rand(8, 8, 3)
    assert region_crc(base[..., 1]) == region_crc(base[..., 1].contiguous())
    assert region_crc({"x": np.float64(0.25)}) == region_crc({"x": 0.25})
    flipped = dict(state)
    flipped["gray"] = state["gray"].clone()
    flipped["gray"].view(torch.uint8)[3, 7] ^= 0x01
    assert region_crc(flipped) != region_crc(state)
    flipped = dict(state, feat_pixel=state["feat_pixel"].copy())
    flipped["feat_pixel"].view(np.uint8)[0, 1] ^= 0x80
    assert region_crc(flipped) != region_crc(state)


@pytest.mark.parametrize("framing", ["msgpack", "pickle"])
def test_crc_survives_the_wire(framing, monkeypatch):
    """A sealed state dict is still valid after encode/decode, whatever
    the codec turned its tensors, lists and scalars into."""
    if framing == "pickle":
        monkeypatch.setattr(codec_mod, "msgpack", None)
    codec = T.default_codec()
    state = _state()
    state["view"] = torch.rand(6, 6, 3)[..., 2]
    state["key"] = ("op", 42)
    value, ok = unseal(codec.decode(codec.encode(seal(state))))
    assert ok and region_crc(value) == region_crc(state)


# --------------------------------------------------------------------------
# FaultyBus
# --------------------------------------------------------------------------


def _serve_counter():
    inner = T.InprocBus()
    seen: list = []
    address = inner.serve({"evt": lambda peer, p: seen.append(p), "echo": lambda peer, p: p})
    return inner, address, seen


def test_faulty_bus_drops_and_duplicates_notifies():
    inner, address, seen = _serve_counter()
    try:
        drop = FaultyBus(T.InprocBus(), FaultPlan(drop_notify=1.0))
        peer = drop.connect(address)
        for i in range(5):
            peer.notify("evt", i)
        assert seen == [] and drop.injected_drops == 5
        dup = FaultyBus(T.InprocBus(), FaultPlan(dup_notify=1.0))
        peer = dup.connect(address)
        peer.notify("evt", "x")
        assert _wait(lambda: len(seen) == 2)
        assert dup.injected_dups == 1 and dup.stats()["injected_dups"] == 1
    finally:
        inner.close()


def test_faulty_bus_fails_calls_and_respects_immunity():
    inner, address, _ = _serve_counter()
    try:
        bus = FaultyBus(T.InprocBus(), FaultPlan(fail_call=1.0, immune=frozenset({"echo"})))
        peer = bus.connect(address)
        assert peer.call("echo", 7) == 7
        with pytest.raises(BusTimeoutError):
            peer.call("evt", 1)
        assert bus.injected_call_failures == 1
    finally:
        inner.close()


def test_faulty_bus_scheduled_kill_closes_the_peer():
    inner, address, seen = _serve_counter()
    try:
        bus = FaultyBus(T.InprocBus(), FaultPlan().kill_at("", 0.0))
        bus.plan.start()
        peer = bus.connect(address)
        with pytest.raises(BusError):
            peer.call("echo", 1)
        assert bus.injected_kills == 1
        peer.notify("evt", 2)
        assert seen == []
    finally:
        inner.close()


def test_faulty_bus_partition_blackholes_notifies_and_times_out_calls():
    inner, address, seen = _serve_counter()
    try:
        bus = FaultyBus(T.InprocBus(), FaultPlan().partition("", 0.0))
        bus.plan.start()
        peer = bus.connect(address)
        peer.notify("evt", 1)
        assert seen == [] and bus.injected_drops == 1
        with pytest.raises(BusTimeoutError):
            peer.call("echo", 1)
    finally:
        inner.close()


def test_faulty_bus_server_side_wrapping_is_identity_stable():
    peers: list = []
    server = FaultyBus(T.InprocBus(), FaultPlan())
    address = server.serve({"evt": lambda peer, p: peers.append(peer)})
    client = T.InprocBus()
    try:
        p = client.connect(address)
        p.notify("evt", 1)
        p.notify("evt", 2)
        assert _wait(lambda: len(peers) == 2)
        assert isinstance(peers[0], FaultyPeer) and peers[0] is peers[1]
    finally:
        server.close()
        client.close()


# --------------------------------------------------------------------------
# CRC rejects + alternate-route re-fetch, tensor regions
# --------------------------------------------------------------------------


def _fanin_cluster(bus_factory, plan, *, n_chunks=2, push=False, push_grace=None):
    cw = fanin_concrete(n_chunks)
    mgr = Manager(cw, ManagerConfig(window=2, locality_aware=True, backup_tasks=False,
                                    heartbeat_timeout=120.0, predictive_push=push))
    endpoint = T.ManagerEndpoint(mgr, FaultyBus(bus_factory(), plan))
    workers, clients = [], []
    for wid in range(2):
        rt = WorkerRuntime(wid, lanes=(LaneSpec("cpu", 0),),
                           variant_registry=fanin_registry(), staging=StagingConfig())
        rt.start()
        workers.append(rt)
        kw = {} if push_grace is None else {"push_grace": push_grace}
        clients.append(T.WorkerClient(rt, FaultyBus(bus_factory(), plan),
                                      endpoint.address, **kw))
    return cw, mgr, endpoint, workers, clients


def _combine_outputs(mgr: Manager, cw) -> list:
    clones = mgr._clone_map()  # noqa: SLF001
    return sorted(mgr.stage_outputs(si.uid).get("combine")
                  for si in cw.stage_instances.values()
                  if si.stage.name == "combine" and si.uid not in clones)


@pytest.mark.parametrize("bus_cls", [T.InprocBus, T.SocketBus])
def test_corrupted_pull_is_rejected_and_refetched_via_relay(bus_cls):
    """Every direct dial of a tensor region (float32 and bfloat16)
    corrupted in transit: the CRC rejects it and the puller takes the
    coordinator relay; the answer is never wrong."""
    plan = FaultPlan(seed=9, corrupt_rate=1.0)
    cw, mgr, endpoint, workers, clients = _fanin_cluster(bus_cls, plan, n_chunks=2)
    try:
        assert endpoint.wait_workers(2, timeout=30.0)
        assert mgr.run(timeout=120.0)
        assert _combine_outputs(mgr, cw) == sorted(expected_combine(i) for i in range(2))
        assert sum(c.crc_rejects for c in clients) >= 1
        assert mgr.relay_regions > 0
    finally:
        for rt in workers:
            rt.stop()
        for c in clients:
            c.close()
        endpoint.bus.close()


@pytest.mark.parametrize("bus_cls", [T.InprocBus, T.SocketBus])
def test_corrupted_push_is_rejected_then_pull_backstop_recovers(bus_cls):
    """A corrupted predictive push of a tensor never lands: the ingest
    CRC rejects it and the lost-push backstop re-pulls after the grace."""
    plan = FaultPlan(seed=11, corrupt_rate=1.0)
    cw, mgr, endpoint, workers, clients = _fanin_cluster(
        bus_cls, plan, n_chunks=1, push=True, push_grace=0.3)
    try:
        assert endpoint.wait_workers(2, timeout=30.0)
        assert mgr.run(timeout=120.0)
        assert _combine_outputs(mgr, cw) == [expected_combine(0)]
        assert sum(c.push_crc_rejects for c in clients) >= 1
        assert sum(rt.push_ingested for rt in workers) == 0
    finally:
        for rt in workers:
            rt.stop()
        for c in clients:
            c.close()
        endpoint.bus.close()
