"""The release of a finished tile (``core/release.py``): once both
stages of a tile completed, the Manager keeps only the tile's result and
the worker drops every other plane of it, so what the runtime holds does
not grow with the tiles it has processed. The port's in-process main
path, one ``gpu`` lane (PATS, locality, tiles leased in order as the
benchmark's cells lease them), the ``gpu`` variants on the CPU at 128²;
results held to the JAX package's ``run_tile(tile, "cpu")``. The card's
test is ``tests/test_torch_release_gpu.py``."""

import pickle
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from repro.app import run_tile as jax_run_tile
from repro_torch.app import build_workflow, register_variants, synth_tile
from repro_torch.app.pipeline import RESULT
from repro_torch.core import (
    ConcreteWorkflow,
    DataChunk,
    LaneSpec,
    Manager,
    ManagerConfig,
    VariantRegistry,
    WorkerRuntime,
)
from repro_torch.core import Operation
from repro_torch.core.release import HostCopies, result_of, tensor_bytes

SIZE = 128
FEATS = ("feat_pixel", "feat_gradient", "feat_haralick", "feat_canny", "feat_morph")


def _run(tiles, fused=False, workers=1, on_op_start=None):
    """The bag through ``workers`` runtimes of one gpu lane each, stopped
    before it returns (every release ran on a lane thread)."""
    reg = register_variants(VariantRegistry(), device="cpu")
    cw = ConcreteWorkflow.replicate(
        build_workflow(fused=fused), [DataChunk(i, payload=t) for i, t in enumerate(tiles)])
    for si in cw.stage_instances.values():
        si.deadline = float(si.chunk.chunk_id)
    mgr = Manager(cw, ManagerConfig(window=2, backup_tasks=False, heartbeat_timeout=60.0))
    rts = []
    for wid in range(workers):
        rt = WorkerRuntime(wid, lanes=(LaneSpec("gpu", 0),), policy="pats", locality=True,
                           variant_registry=reg)
        rt.on_op_start = on_op_start
        mgr.register_worker(rt)
        rts.append(rt)
    for rt in rts:
        rt.start()
    try:
        assert mgr.run(timeout=300.0), [rt.errors[:3] for rt in rts]
    finally:
        for rt in rts:
            rt.stop()
    return mgr, cw, rts


def _held_bytes(mgr, rts) -> int:
    """Tensor bytes reachable from the Manager's outputs and the workers'
    stores: host tiers, lanes' device memory, chained maps. A result is
    on the host, a numpy array, and counts nothing."""
    values = list(mgr._stage_outputs.values())  # noqa: SLF001
    for rt in rts:
        for tier in rt.store.tiers:
            values += [v for v, _ in tier._entries.values()]  # noqa: SLF001
        for lane in rt._lanes:  # noqa: SLF001
            if lane.memory is not None:
                values += list(lane.memory._store.values())  # noqa: SLF001
        values += list(rt._host_chained.values())  # noqa: SLF001
    return tensor_bytes(values)


def _results(mgr, cw) -> dict[int, dict]:
    """Each tile's result as ``stage_outputs`` gives it, checking that
    nothing else is left: ``bwlabel``'s ``objects`` and ``n_objects``,
    and the feature ops' ``feat_*`` (their own and those of the states
    they took in) beside ``n_objects``."""
    keys = {k for names in RESULT.values() for k in names}
    out: dict[int, dict] = {}
    for si in cw.stage_instances.values():
        got = out.setdefault(si.chunk.chunk_id, {})
        outputs = mgr.stage_outputs(si.uid)
        if si.stage.name == "segmentation":
            assert set(outputs) == {"bwlabel"}
            assert set(outputs["bwlabel"]) == {"objects", "n_objects"}
        for name, state in outputs.items():
            assert set(state) <= keys, name
            assert "objects" not in state or name == "bwlabel", name
            got.update(state)
    return out


@pytest.mark.parametrize("fused", [False, True])
def test_a_finished_tile_keeps_only_its_result(fused):
    held = {}
    for n in (3, 9):
        tiles = [synth_tile(i, size=SIZE, seed=3) for i in range(n)]
        mgr, cw, (rt,) = _run(tiles, fused=fused)
        held[n] = _held_bytes(mgr, [rt])
        assert rt.stats()["released_chunks"] == n
        assert rt.stats()["released_bytes"] > 0
        results = _results(mgr, cw)
        if n == 3:
            for cid, got in results.items():
                want = jax_run_tile(tiles[cid], "cpu")
                assert isinstance(got["objects"], np.ndarray)
                np.testing.assert_array_equal(got["objects"], want["objects"])
                assert got["n_objects"] == want["n_objects"]
                for key in FEATS:
                    assert isinstance(got[key], np.ndarray), key
                    np.testing.assert_allclose(got[key], want[key], rtol=1e-3, atol=1e-4,
                                               err_msg=key)
    assert held[3] == held[9]


def test_a_features_stage_re_leased_after_a_fault_finds_its_segmentation():
    """The first features op to start, on the worker that ran the
    segmentation, raises once: the Manager re-leases the stage to the
    other worker, which is given the segmentation's outputs (not
    released: the tile has not finished), and the tile's result is the
    reference's; then both workers drop the tile."""
    failed = []

    def fail_once(rt, oi):
        if oi.stage_instance.stage.name == "features" and not failed:
            failed.append(rt.worker_id)
            raise RuntimeError("injected fault")

    tile = synth_tile(0, size=SIZE, seed=3)
    mgr, cw, rts = _run([tile], workers=2, on_op_start=fail_once)
    assert len(failed) == 1 and mgr.stats()["lease_retries"] == 1
    ran = {rt.worker_id: set(rt.stats()["profile"]) for rt in rts}
    other = 1 - failed[0]
    assert "bwlabel" in ran[failed[0]] and "morphometry" not in ran[failed[0]]
    assert "morphometry" in ran[other] and "bwlabel" not in ran[other]
    got = _results(mgr, cw)[0]
    want = jax_run_tile(tile, "cpu")
    np.testing.assert_array_equal(got["objects"], want["objects"])
    assert got["n_objects"] == want["n_objects"]
    for key in FEATS:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3, atol=1e-4, err_msg=key)
    assert _held_bytes(mgr, rts) == 0
    assert sum(rt.stats()["released_chunks"] for rt in rts) == 2


def test_what_a_released_output_keeps():
    """A state keeps its non-tensor values and, on the host, the tensors
    its op names (a host copy the op started, finished or still being
    written, in place of the tensor); a bare tensor goes unless its op
    names an output."""
    op = Operation("bwlabel", outputs=("objects", "n_objects"))
    objects, labels = torch.arange(6, dtype=torch.int32), torch.ones(6)
    state = {"objects": objects, "labels": labels, "n_objects": 5, "feat": np.zeros(2)}
    kept = result_of(op, state)
    assert set(kept) == {"objects", "n_objects", "feat"} and kept["n_objects"] == 5
    np.testing.assert_array_equal(kept["objects"], np.arange(6))
    copy = Future()
    copy.set_result(np.full(6, 7, np.int32))
    staged = HostCopies(state, {"objects": copy})
    assert result_of(op, staged)["objects"] is copy.result()
    assert type(pickle.loads(pickle.dumps(staged))) is dict  # the state alone crosses a wire
    assert result_of(Operation("watershed"), {"labels": labels}) is None
    assert result_of(Operation("produce"), labels) is None
    assert result_of(Operation("consume"), 3.5) == 3.5
    assert tensor_bytes([state, [labels, objects]]) == 6 * 4 + 6 * 4
