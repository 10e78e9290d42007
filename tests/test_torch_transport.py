"""The port's transport layer: the tensor-aware wire codec (with msgpack
and in its pickle framing), numpy frames byte-equal to the JAX
package's codec, the buses and endpoints (byte-identical copies), the
data plane carrying dicts of tensors over real sockets with no CRC
rejects, and the WSI pipeline across two spawned worker processes held
against the JAX package's ``run_tile(tile, "cpu")``."""

from __future__ import annotations

import gc
import json
import pickle
import threading
import time
import weakref

import numpy as np
import pytest
import torch

import repro.transport.codec as ref_codec
import repro_torch.transport as T
import repro_torch.transport.codec as codec_mod
from repro.app import run_tile as jax_run_tile
from repro_torch.app import build_workflow, synth_tile
from repro_torch.app.pipeline import (
    LAUNCH_LOG_ENV,
    OP_IMPLS,
    _SEG_ORDER,
    _feature_fused_accel,
    _feature_fused_cpu,
)
from repro_torch.core import (
    ConcreteWorkflow,
    DataChunk,
    LaneSpec,
    Manager,
    ManagerConfig,
    VariantRegistry,
    WorkerRuntime,
)
from repro_torch.core.calibration import PARALLEL_FEATURE_OPS
from repro_torch.faults import region_crc
from repro_torch.staging import StagingConfig
from repro_torch.transport.demo import (
    demo_concrete,
    demo_registry,
    expected_combine,
    expected_consume,
    fanin_concrete,
    fanin_workflow,
)

CPU = torch.device("cpu")


@pytest.fixture(params=["msgpack", "pickle"])
def codec(request, monkeypatch):
    """A fresh codec, once with msgpack and once in the pickle framing
    the module falls back to where msgpack is missing."""
    if request.param == "pickle":
        monkeypatch.setattr(codec_mod, "msgpack", None)
    else:
        assert codec_mod.msgpack is not None
    return T.default_codec()


def _assert_same(got, want, path="value"):
    if isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor), path
        assert got.device == CPU, path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert torch.equal(got, want.cpu()), path
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    else:
        assert got == want and type(got) is type(want), path


# --------------------------------------------------------------------------
# codec
# --------------------------------------------------------------------------


def _seeded(dtype, shape=(5, 7), seed=0):
    rng = np.random.default_rng(seed)
    x = np.asarray(rng.standard_normal(shape), dtype=np.float32)
    if dtype is torch.bool:
        return torch.from_numpy(np.asarray(x > 0))
    if dtype is torch.uint8:
        return torch.from_numpy(np.asarray(np.abs(x) * 60, dtype=np.uint8))
    if dtype is torch.int32:
        return torch.from_numpy(np.asarray(x * 1000, dtype=np.int32))
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize(
    "dtype", [torch.float32, torch.int32, torch.bool, torch.uint8, torch.bfloat16],
    ids=lambda d: str(d).removeprefix("torch."),
)
def test_codec_tensor_roundtrip(codec, dtype):
    t = _seeded(dtype)
    payload = {"t": t, "scalar": _seeded(dtype, shape=()), "empty": t[:0],
               "nested": ("op", [t[1:3], 2.5], None)}
    out = codec.decode(codec.encode(payload))
    _assert_same(out, payload)
    assert region_crc(out) == region_crc(payload)


def test_codec_non_contiguous_views(codec):
    base = torch.arange(6 * 8 * 3, dtype=torch.float32).reshape(6, 8, 3)
    views = {"channel": base[..., 1], "transposed": base[..., 0].t(),
             "strided": base[::2, 1::3, :]}
    assert not any(v.is_contiguous() for v in views.values())
    out = codec.decode(codec.encode(views))
    _assert_same(out, views)
    assert all(v.is_contiguous() for v in out.values())
    assert region_crc(out) == region_crc(views)


def test_codec_tensor_inside_pickled_graph(codec):
    """A tensor inside an object msgpack cannot express (and in the
    pickle framing, every tensor) rides the tensor encoding, not
    torch's own pickling, and comes back a CPU tensor."""
    chunk = DataChunk(3, payload={"rgb": _seeded(torch.uint8, (4, 4))})
    out = codec.decode(codec.encode({"chunk": chunk, "set": {1, 2}}))
    assert out["chunk"].chunk_id == 3 and out["set"] == {1, 2}
    _assert_same(out["chunk"].payload, chunk.payload)


def test_codec_tensor_pickle_avoids_torch_storage_pickling():
    t = _seeded(torch.bfloat16, (3, 3))
    data = codec_mod._dumps({"x": t})
    assert b"_rebuild" not in data and b"torch._utils" not in data
    assert torch.equal(pickle.loads(data)["x"], t)


def _wsi_states(size: int = 128) -> dict:
    """Every state dict the WSI pipeline makes on one tile: the numpy
    path (``cpu`` variants) and the torch path (``gpu`` variants on the
    CPU), the fused op of each included."""
    tile = synth_tile(0, size=size, seed=3)
    names = _SEG_ORDER + ("color_deconv",) + tuple(PARALLEL_FEATURE_OPS)
    states = {}
    for kind, idx, kw in (("cpu", 0, {}), ("gpu", 1, {"device": CPU})):
        state = tile
        for name in names:
            out = OP_IMPLS[name][idx](state, **kw)
            states[f"{kind}:{name}"] = out
            if name in _SEG_ORDER or name == "color_deconv":
                state = out
    seg = states["gpu:bwlabel"]
    states["gpu:feature_fused"] = _feature_fused_accel(seg, device=CPU)
    states["cpu:feature_fused"] = _feature_fused_cpu(states["cpu:bwlabel"])
    return states


@pytest.fixture(scope="module")
def wsi_states():
    return _wsi_states()


def test_codec_roundtrips_every_wsi_state_dict(codec, wsi_states):
    assert any(isinstance(v, torch.Tensor)
               for s in wsi_states.values() for v in s.values())
    for name, state in wsi_states.items():
        out = codec.decode(codec.encode(state))
        _assert_same(out, state, name)
        assert region_crc(out) == region_crc(state), name


def test_codec_numpy_frames_equal_the_reference(codec, monkeypatch):
    """Numpy values, alone and in containers, encode to the same bytes
    as the JAX package's codec (with msgpack and in its pickle framing)."""
    rng = np.random.default_rng(5)
    values = [
        rng.standard_normal((4, 6)).astype(np.float32),
        np.arange(10, dtype=np.int64)[::2],
        {"mask": rng.random((8, 8)) > 0.5, "key": ("op", 42), "n": 3,
         "nested": ({"x": 1}, b"raw", None, 2.5)},
        ("req", 7, "pull_regions", (np.ones(3, np.uint8), None)),
        {1, 2, 3},
    ]
    monkeypatch.setattr(ref_codec, "msgpack", codec_mod.msgpack)
    ref = ref_codec.WireCodec()
    for v in values:
        assert codec.encode(v) == ref.encode(v)


def test_codec_roundtrip_arrays_and_graphs():
    codec = T.default_codec()
    arr = np.arange(24, dtype=np.float32).reshape(4, 6)
    payload = {
        "arr": arr,
        "key": ("op", 42),
        "nested": ({"x": 1}, b"raw", None, 2.5),
        "pickled": {1, 2, 3},  # msgpack can't: exercises pickle fallback
    }
    out = codec.decode(codec.encode(payload))
    np.testing.assert_array_equal(out["arr"], arr)
    assert out["arr"].dtype == np.float32
    assert out["key"] == ("op", 42)  # tuples survive (use_list=False)
    assert out["nested"][1] == b"raw"
    assert out["pickled"] == {1, 2, 3}
    assert codec.pickle_fallbacks >= 1


def test_codec_custom_entry_wins_over_pickle():
    class Point:
        def __init__(self, x, y):
            self.x, self.y = x, y

    codec = T.default_codec()
    codec.register(
        T.Codec(
            "pt",
            lambda v: isinstance(v, Point),
            lambda v: {"x": v.x, "y": v.y},
            lambda d: Point(d["x"], d["y"]),
        )
    )
    out = codec.decode(codec.encode([Point(3, 4)]))[0]
    assert (out.x, out.y) == (3, 4)
    assert codec.pickle_fallbacks == 0


# --------------------------------------------------------------------------
# buses
# --------------------------------------------------------------------------


def _echo_handlers(log):
    def echo(peer, payload):
        log.append(payload)
        return payload

    def boom(peer, payload):
        raise ValueError("kaboom")

    return {"echo": echo, "boom": boom}


@pytest.mark.parametrize("bus_cls", [T.InprocBus, T.SocketBus])
def test_bus_call_notify_and_remote_error(bus_cls):
    log: list = []
    server = bus_cls()
    address = server.serve(_echo_handlers(log))
    client = bus_cls() if bus_cls is T.SocketBus else server
    peer = client.connect(address)
    t = _seeded(torch.bfloat16)
    got = peer.call("echo", {"a": 1, "t": t})
    assert got["a"] == 1 and torch.equal(got["t"], t)
    peer.notify("echo", "fire-and-forget")
    with pytest.raises(T.RemoteError):
        peer.call("boom")
    deadline = time.monotonic() + 5.0
    while len(log) < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert log[0]["a"] == 1 and log[1] == "fire-and-forget"
    peer.close()
    server.close()


def test_socketbus_ordered_delivery_and_coalescing():
    received: list[int] = []
    release = threading.Event()

    def slow_then_log(peer, payload):
        release.wait(timeout=10.0)
        received.append(payload)

    server = T.SocketBus()
    address = server.serve({"log": slow_then_log})
    client = T.SocketBus()
    peer = client.connect(address)
    for i in range(50):
        peer.notify("log", i)
    release.set()
    deadline = time.monotonic() + 10.0
    while len(received) < 50 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert received == list(range(50))
    assert client.frames_sent < client.messages_sent
    peer.close()
    server.close()
    client.close()


def test_socketbus_segments_large_tensor_payloads():
    """A tensor payload above ``max_frame_bytes`` rides chunked ``seg``
    messages (sized by ``nbytes``) and reassembles bit for bit."""
    received: dict = {}

    def sink(peer, payload):
        received.update(payload)
        return tuple(payload["t"].shape)

    server = T.SocketBus(max_frame_bytes=64 * 1024)
    address = server.serve({"sink": sink, "echo": lambda p, x: x})
    client = T.SocketBus(max_frame_bytes=64 * 1024)
    peer = client.connect(address)
    big = torch.arange(300_000, dtype=torch.float64).to(torch.bfloat16)
    assert tuple(peer.call("sink", {"t": big}, timeout=30.0)) == tuple(big.shape)
    assert torch.equal(received["t"], big)
    assert peer.sent_segments > 1
    assert peer.call("echo", 7) == 7
    peer.close()
    server.close()
    client.close()


def test_closing_a_served_socketbus_frees_its_handlers():
    """``ManagerEndpoint.close`` ends the bus's accept thread, so the
    endpoint and its Manager (with every stage output it holds) can be
    freed: on Linux, closing the listening socket alone does not wake a
    thread blocked in ``accept``, whose loop holds the handlers."""
    mgr = Manager(demo_concrete(1), ManagerConfig(window=1))
    endpoint = T.ManagerEndpoint(mgr, T.SocketBus())
    accept = endpoint.bus._accept_thread  # noqa: SLF001
    alive = weakref.ref(mgr)
    client = T.SocketBus()
    client.connect(endpoint.address)
    time.sleep(0.2)  # the accept loop is back in ``accept``
    endpoint.close()
    client.close()
    accept.join(timeout=5.0)
    assert not accept.is_alive()
    del mgr, endpoint
    deadline = time.monotonic() + 5.0  # the connection's own threads end soon after
    while alive() is not None and time.monotonic() < deadline:
        gc.collect()
        time.sleep(0.05)
    assert alive() is None


# --------------------------------------------------------------------------
# Manager/Worker over the bus, one process
# --------------------------------------------------------------------------

N_CHUNKS = 4


def _consume_outputs(mgr: Manager, cw, op: str) -> list[float]:
    clones = mgr._clone_map()  # noqa: SLF001
    return sorted(
        mgr.stage_outputs(si.uid).get(op)
        for si in cw.stage_instances.values()
        if si.stage.name == op and si.uid not in clones
    )


@pytest.mark.parametrize("bus_cls", [T.InprocBus, T.SocketBus])
def test_manager_over_bus_runs_the_tensor_demo(bus_cls):
    cw = demo_concrete(N_CHUNKS)
    mgr = Manager(cw, ManagerConfig(window=2, locality_aware=True))
    endpoint = T.ManagerEndpoint(mgr, bus_cls())
    workers = []
    for wid in range(2):
        rt = WorkerRuntime(wid, lanes=(LaneSpec("cpu", 0),),
                           variant_registry=demo_registry(), staging=StagingConfig())
        rt.start()
        workers.append(rt)
        T.WorkerClient(rt, bus_cls(), endpoint.address)
    try:
        assert endpoint.wait_workers(2, timeout=30.0)
        assert mgr.run(timeout=60.0)
        assert _consume_outputs(mgr, cw, "consume") == sorted(
            expected_consume(i) for i in range(N_CHUNKS))
    finally:
        for rt in workers:
            rt.stop()
        endpoint.bus.close()


def _dict_registry() -> VariantRegistry:
    """The fan-in workflow over state dicts of tensors (float32,
    bfloat16, bool) plus host scalars: what a WSI region looks like."""
    def state(cid: int, scale: int, dtype) -> dict:
        v = float(scale * (cid + 1))
        return {"plane": torch.full((64, 64), v, dtype=dtype),
                "mask": torch.arange(64 * 64).reshape(64, 64) % 3 == 0,
                "n_objects": cid + 1, "shape": [64, 64]}

    def produce_a(ctx):
        return state(ctx.chunk.chunk_id, 1, torch.float32)

    def produce_b(ctx):
        time.sleep(0.05)
        return state(ctx.chunk.chunk_id, 2, torch.bfloat16)

    def combine(ctx):
        a, b = ctx.inputs["produce_a"], ctx.inputs["produce_b"]
        assert a["mask"].dtype == torch.bool and b["plane"].dtype == torch.bfloat16
        return float(a["plane"].double().sum() + b["plane"].double().sum())

    reg = VariantRegistry()
    reg.register("produce_a", "cpu", produce_a)
    reg.register("produce_b", "cpu", produce_b)
    reg.register("combine", "cpu", combine)
    return reg


@pytest.mark.parametrize("push", [False, True], ids=["pull", "push"])
def test_socketbus_data_plane_moves_tensor_dicts_without_crc_rejects(push):
    """Real sockets in one process: the fan-in's cross-worker region
    (a dict of tensors) is pulled from the sibling, or pushed to it, in
    a CRC envelope sealed over the sender's tensors and checked over
    the decoded ones: no rejects, no relay."""
    n = 1 if push else N_CHUNKS
    cw = ConcreteWorkflow.replicate(fanin_workflow(), [DataChunk(i) for i in range(n)])
    mgr = Manager(cw, ManagerConfig(window=1, locality_aware=True, backup_tasks=False,
                                    heartbeat_timeout=120.0, predictive_push=push))
    endpoint = T.ManagerEndpoint(mgr, T.SocketBus())
    workers, clients = [], []
    for wid in range(2):
        rt = WorkerRuntime(wid, lanes=(LaneSpec("cpu", 0),),
                           variant_registry=_dict_registry(), staging=StagingConfig())
        rt.start()
        workers.append(rt)
        clients.append(T.WorkerClient(rt, T.SocketBus(), endpoint.address))
    try:
        assert endpoint.wait_workers(2, timeout=30.0)
        assert mgr.run(timeout=120.0)
        assert _consume_outputs(mgr, cw, "combine") == sorted(
            expected_combine(i) for i in range(n))
        assert sum(c.crc_rejects for c in clients) == 0
        assert sum(c.push_crc_rejects for c in clients) == 0
        assert endpoint.relay_bytes == 0
        if push:
            assert sum(c.pushes for c in clients) > 0
            assert sum(rt.push_ingested for rt in workers) > 0
        else:
            assert sum(c.served_regions for c in clients) > 0
            assert sum(rt.agent.direct_keys for rt in workers) > 0
    finally:
        for rt in workers:
            rt.stop()
        for c in clients:
            c.close()
        endpoint.bus.close()


# --------------------------------------------------------------------------
# worker OS processes
# --------------------------------------------------------------------------


def _spawn(endpoint, registry: str, n: int, **spec):
    return [T.spawn_worker(endpoint.address,
                           T.WorkerSpec(worker_id=wid, registry=registry, **spec))
            for wid in range(n)]


def _close(endpoint, procs) -> list:
    endpoint.close()
    for p in procs:
        p.join(timeout=20.0)
    codes = [p.exitcode for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(timeout=5.0)
    return codes


def test_two_worker_processes_move_tensors_directly():
    """Two spawned workers on the fan-in demo (float32 and bfloat16
    tensors): the cross edges go worker to worker, predictive pushes
    land, nothing is relayed and no CRC check fails."""
    cw = fanin_concrete(N_CHUNKS)
    mgr = Manager(cw, ManagerConfig(window=1, locality_aware=True, backup_tasks=False,
                                    heartbeat_timeout=120.0, predictive_push=True))
    endpoint = T.ManagerEndpoint(mgr, T.SocketBus())
    procs = _spawn(endpoint, "repro_torch.transport.demo:fanin_registry", 2)
    codes = None
    try:
        assert endpoint.wait_workers(2, timeout=60.0)
        assert mgr.run(timeout=120.0)
        assert _consume_outputs(mgr, cw, "combine") == sorted(
            expected_combine(i) for i in range(N_CHUNKS))
        assert endpoint.relay_bytes == 0
        stats = [p.stats() for p in endpoint.proxies.values()]
        assert sum(s["prefetch"].get("direct_keys", 0) + s["push_ingested"]
                   for s in stats) > 0
        for s in stats:
            assert s["transport"]["crc_rejects"] == 0
            assert s["transport"]["push_crc_rejects"] == 0
    finally:
        codes = _close(endpoint, procs)
    assert codes == [0, 0]


def test_worker_process_stopped_inside_torch_calls_exits_cleanly():
    """A worker stopped while its lane is still inside torch calls, past
    ``WorkerRuntime.stop``'s wait for its lanes, exits 0: it outlasts its
    threads, since a thread that re-takes the GIL inside torch's C++
    while the interpreter finalizes aborts the process ("terminate
    called without an active exception", exit code -6)."""
    mgr = Manager(demo_concrete(1), ManagerConfig(window=1, backup_tasks=False,
                                                  heartbeat_timeout=120.0))
    endpoint = T.ManagerEndpoint(mgr, T.SocketBus())
    procs = _spawn(endpoint, "repro_torch.transport.demo:busy_registry", 1)
    codes = None
    try:
        assert endpoint.wait_workers(1, timeout=60.0)
        assert not mgr.run(timeout=2.0)  # produce is still in its torch calls
    finally:
        codes = _close(endpoint, procs)
    assert codes == [0]


WSI_SIZE, WSI_TILES = 128, 4


#: (fused, locality, predictive push). With locality on, each tile's
#: features stage lands on the worker holding its segmentation and
#: nothing crosses; with it off (the Manager's leases and the workers'
#: PATS), the features stage may run on the other worker, and the
#: segmentation region is pushed to it or pulled from its sibling.
WSI_CASES = {
    "unfused": (False, True, True),
    "fused": (True, True, True),
    "fused-crossing-push": (True, False, True),
    "fused-crossing-pull": (True, False, False),
}


@pytest.mark.parametrize("fused,locality,push", list(WSI_CASES.values()), ids=list(WSI_CASES))
def test_wsi_pipeline_across_two_worker_processes(fused, locality, push, tmp_path,
                                                  monkeypatch):
    """The Manager here, two spawned workers with one ``gpu`` lane each
    (``wsi_registry_cpu``: the torch ops on the CPU), PATS: every tile's
    features equal the JAX package's numpy path, no CRC rejects, both
    children exit 0 and report their (zero) kernel launches. With
    locality off, regions cross worker to worker (pushed, or pulled from
    the sibling without push) and none is relayed by the Manager."""
    monkeypatch.setenv(LAUNCH_LOG_ENV, str(tmp_path))
    tiles = [synth_tile(i, size=WSI_SIZE, seed=3) for i in range(WSI_TILES)]
    cw = ConcreteWorkflow.replicate(
        build_workflow(fused=fused),
        [DataChunk(i, payload=t) for i, t in enumerate(tiles)],
    )
    mgr = Manager(cw, ManagerConfig(window=2, heartbeat_timeout=60.0,
                                    locality_aware=locality, predictive_push=push,
                                    backup_tasks=False))
    endpoint = T.ManagerEndpoint(mgr, T.SocketBus())
    procs = _spawn(endpoint, "repro_torch.app.pipeline:wsi_registry_cpu", 2,
                   lanes=(("gpu", 0),), policy="pats", extra={"locality": locality})
    codes = None
    try:
        assert endpoint.wait_workers(2, timeout=60.0)
        assert mgr.run(timeout=120.0)
        done, total = mgr.progress()
        assert done == total == 2 * WSI_TILES
        feats: dict[int, dict] = {}
        for si in cw.stage_instances.values():
            if si.stage.name == "features":
                for state in mgr.stage_outputs(si.uid).values():
                    feats.setdefault(si.chunk.chunk_id, {}).update(
                        {k: v for k, v in state.items()
                         if k.startswith("feat_") or k == "n_objects"})
        assert sorted(feats) == list(range(WSI_TILES))
        for cid, got in feats.items():
            want = jax_run_tile(tiles[cid], "cpu")
            assert got["n_objects"] == want["n_objects"]
            for key in ("feat_pixel", "feat_gradient", "feat_haralick",
                        "feat_canny", "feat_morph"):
                assert isinstance(got[key], np.ndarray), key
                np.testing.assert_allclose(got[key], want[key], rtol=1e-3,
                                           atol=1e-4, err_msg=f"tile {cid} {key}")
        stats = [p.stats() for p in endpoint.proxies.values()]
        assert len(stats) == 2
        for s in stats:
            assert s["executed"] > 0
            assert all(set(kinds) == {"gpu"} for kinds in s["profile"].values())
            assert s["transport"]["crc_rejects"] == 0
            assert s["transport"]["push_crc_rejects"] == 0
        feature_op = "feature_fused" if fused else "color_deconv"
        assert sum(s["profile"].get(feature_op, {}).get("gpu", 0)
                   for s in stats) == WSI_TILES
        assert endpoint.bus.codec.decoded_bytes > 0
        if not locality:
            assert endpoint.relay_bytes == 0
            if push:
                assert sum(s["push_ingested"] for s in stats) > 0
            else:
                assert sum(s["prefetch"].get("direct_keys", 0) for s in stats) > 0
                assert sum(s["transport"]["served_regions"] for s in stats) > 0
    finally:
        codes = _close(endpoint, procs)
    assert codes == [0, 0]
    logs = sorted(tmp_path.glob("launches-*.json"))
    assert len(logs) == 2
    for log in logs:
        counts = json.loads(log.read_text())
        assert set(counts) >= {"color_deconv", "morph_recon", "feature_fused"}
        assert sum(counts.values()) == 0  # CPU tensors: the plain versions
