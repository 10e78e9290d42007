"""What decides ``correct``: a sound run of a cell, driven on the CPU
(the harness's look for a card skipped), comes out correct; the control
(the reference in bfloat16) and runs with the timed path broken
underneath come out not correct."""

import time

import pytest
import torch

from benchkit.compare import judge
from benchkit.spec import benchmark, load_module
from benchkit.tiles import make_traffic
from conftest import TINY_TILE, tiny

import run as bench_run
from control import control_readings
from repro_torch.app import pipeline
from repro_torch.kernels import ops

CELLS = [w["name"] for w in benchmark()["workloads"]]


def _run(name: str, seed: int = 4242):
    cell = tiny(name)
    result, _ = bench_run.run_cell(cell, seed, 2.0, False, "cpu", time.perf_counter())
    return result


def test_sound_run_is_correct():
    result = _run("wsi4k-fused.cerebrum")
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"tiles_per_s", "tile_p80_s", "setup_s"}  # no card: no peak


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = tiny(name)
    numbers = control_readings(cell, 77, 2, "cpu")
    assert not judge(numbers, cell.limits["limits"]), numbers


def _faulty_op(name, alter):
    cpu_fn, accel_fn = pipeline.OP_IMPLS[name]

    def accel(state, device="cuda"):
        return alter(accel_fn(state, device=device))

    return cpu_fn, accel


def test_reconstruction_left_unchanged_fails(monkeypatch):
    # A step that returns its state unchanged: the reconstruction gives
    # back min(marker, mask) without flooding.
    monkeypatch.setattr(ops, "morph_recon", lambda marker, mask: torch.minimum(marker, mask))
    assert not _run("wsi4k-fine.cerebrum")["correct"]


def test_feature_altered_where_produced_fails(monkeypatch):
    def alter(out):
        return dict(out, feat_morph=out["feat_morph"] * 1.01)

    monkeypatch.setitem(pipeline.OP_IMPLS, "morphometry", _faulty_op("morphometry", alter))
    result = _run("wsi4k-fused.cerebrum")
    assert not result["correct"] and result["checks"]["feat_morph"]["value"] > 1e-3


def test_object_count_altered_fails(monkeypatch):
    def alter(out):
        return dict(out, n_objects=out["n_objects"] + 1)

    monkeypatch.setitem(pipeline.OP_IMPLS, "bwlabel", _faulty_op("bwlabel", alter))
    assert not _run("wsi4k-fused.cerebrum")["correct"]


@pytest.mark.gpu
def test_control_on_the_card_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at 4096x4096")
    from benchkit.spec import load_cell

    for name in CELLS:
        cell = load_cell(name)
        for seed in (1, 2, 3):
            assert not judge(control_readings(cell, seed, 1, "cuda"), cell.limits["limits"])


def test_traffic_tiles_reach_the_reference_unchanged():
    # The reference reads the harness's tile, not a copy the program made.
    cell = tiny("wsi4k-fine.cerebrum")
    traffic = make_traffic(cell.traffic, 5, TINY_TILE)
    ref = load_module("reference", "wsi")
    before = traffic.tile(0).copy()
    ref.run_tile(traffic.tile(0), "cpu")
    assert (traffic.tile(0) == before).all()
