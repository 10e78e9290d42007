"""The port's main path through its Manager/Worker runtime: the run of
``tests/test_app.py`` (threaded Workers, PATS, locality) with ``cpu``
and ``gpu`` lanes, the ``gpu`` variants on ``device="cpu"``; features
held against the JAX package's ``run_tile(tile, "cpu")``."""

import numpy as np
import pytest
import torch

from repro.app import run_tile as jax_run_tile
from repro_torch.app import build_workflow, register_variants, synth_tile
from repro_torch.app.pipeline import _to_host, _wrap
from repro_torch.core import (
    ConcreteWorkflow,
    DataChunk,
    LaneSpec,
    Manager,
    ManagerConfig,
    OpContext,
    VariantRegistry,
    WorkerRuntime,
)
from repro_torch.kernels import ops as K

SIZE = 128


def _features_by_tile(mgr, cw):
    feats: dict[int, dict] = {}
    for si in cw.stage_instances.values():
        if si.stage.name != "features":
            continue
        for state in (mgr.stage_outputs(si.uid) or {}).values():
            feats.setdefault(si.chunk.chunk_id, {}).update(
                {k: v for k, v in state.items()
                 if k.startswith("feat_") or k == "n_objects"}
            )
    return feats


@pytest.mark.parametrize("fused", [False, True])
def test_middleware_executes_port_pipeline(fused):
    """Manager -> Workers -> function variants on threads; every tile's
    features equal the reference's numpy path."""
    reg = VariantRegistry()
    register_variants(reg, device="cpu")
    tiles = [synth_tile(i, size=SIZE, seed=3) for i in range(3)]
    cw = ConcreteWorkflow.replicate(
        build_workflow(fused=fused),
        [DataChunk(i, payload=t) for i, t in enumerate(tiles)],
    )
    workers = []
    for wid in range(2):
        rt = WorkerRuntime(
            wid,
            lanes=(LaneSpec("cpu", 0), LaneSpec("gpu", 0)),
            policy="pats",
            locality=True,
            variant_registry=reg,
        )
        rt.start()
        workers.append(rt)
    mgr = Manager(cw, ManagerConfig(window=2, heartbeat_timeout=60.0))
    for rt in workers:
        mgr.register_worker(rt)
    K.reset_launch_counts()
    try:
        assert mgr.run(timeout=300.0)
        done, total = mgr.progress()
        assert done == total == 6  # 3 tiles x 2 stages
        feats = _features_by_tile(mgr, cw)
        assert sorted(feats) == [0, 1, 2]
        for cid, got in feats.items():
            want = jax_run_tile(tiles[cid], "cpu")
            assert got["n_objects"] == want["n_objects"]
            for key in ("feat_pixel", "feat_gradient", "feat_haralick",
                        "feat_canny", "feat_morph"):
                assert isinstance(got[key], np.ndarray), key
                np.testing.assert_allclose(got[key], want[key], rtol=1e-3,
                                           atol=1e-4, err_msg=key)
        profile = {}
        for rt in workers:
            for op, kinds in rt.stats()["profile"].items():
                for kind, n in kinds.items():
                    profile.setdefault(op, {}).setdefault(kind, 0)
                    profile[op][kind] += n
        # Backup twins of tail stages may run an op more than once.
        feature_op = "feature_fused" if fused else "color_deconv"
        assert sum(profile[feature_op].values()) >= 3
        assert ("color_deconv" in profile) is not fused
        # CPU tensors take the plain versions: no kernel launched.
        assert sum(K.launch_counts().values()) == 0
    finally:
        for rt in workers:
            rt.stop()


def test_cpu_variant_downloads_tensor_inputs():
    state = {"a": torch.arange(4), "b": np.ones(2), "n": 3}
    host = _to_host(state)
    assert isinstance(host["a"], np.ndarray) and host["a"].tolist() == [0, 1, 2, 3]
    assert host["b"] is state["b"] and host["n"] == 3

    seen = {}

    def fn(s, **kw):
        seen.update(s=s, kw=kw)
        return s

    ctx = OpContext(chunk=DataChunk(0, payload=None), inputs={"x": state})
    _wrap(fn, to_host=True)(ctx)
    assert isinstance(seen["s"]["a"], np.ndarray) and seen["kw"] == {}
    _wrap(fn, device=torch.device("cpu"))(ctx)
    assert isinstance(seen["s"]["a"], torch.Tensor)
    assert seen["kw"] == {"device": torch.device("cpu")}


def test_first_gpu_op_uploads_the_payload():
    reg = register_variants(VariantRegistry(), device="cpu")
    tile = synth_tile(0, size=64, seed=1)
    ctx = OpContext(chunk=DataChunk(0, payload=tile), inputs={}, lane_kind="gpu")
    out = reg.get("rbc_detection").implementation("gpu")(ctx)
    assert isinstance(out["rgb"], torch.Tensor)
    assert torch.equal(out["rgb"], torch.as_tensor(tile))
