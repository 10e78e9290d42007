"""What decides ``correct``: a sound run of a cell, driven on the CPU
(the harness's look for a card skipped), comes out correct; the
controls (the reference in the precision below the configuration's;
for the serving cells also a Mamba2 state zeroed once and a decode
attention one position short) and runs with the timed path broken
underneath come out not correct."""

import time

import pytest
import torch

from benchkit.compare import judge
from benchkit.spec import benchmark, load_cell, load_module
from conftest import TINY_TILE, tiny
from kinds.wsi_tiles import make_traffic

import run as bench_run
from control import control_readings
from repro_torch.app import pipeline
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import transformer

CELLS = [w["name"] for w in benchmark()["workloads"]]
WSI = [c for c in CELLS if load_cell(c).config["driver"] == "wsi_manager"]
SERVE = [c for c in CELLS if load_cell(c).config["driver"] == "lm_serve"]
WSI_CONTROL = load_module("controls", "wsi")


def _run(name: str, seed: int = 4242):
    cell = tiny(name)
    result, _ = bench_run.run_cell(cell, seed, 2.0, False, "cpu", time.perf_counter())
    return result


def test_sound_run_is_correct():
    result = _run("wsi4k-fused.cerebrum")
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"tiles_per_s", "tile_p80_s", "setup_s"}  # no card: no peak


@pytest.mark.parametrize("name", WSI)
def test_control_is_not_correct(name):
    cell = tiny(name)
    numbers = WSI_CONTROL.control_readings(cell, 77, 2, "cpu")
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

    for name in WSI:
        cell = load_cell(name)
        for seed in (1, 2, 3):
            numbers = WSI_CONTROL.control_readings(cell, seed, 1, "cuda")
            assert not judge(numbers, cell.limits["limits"])


def test_traffic_tiles_reach_the_reference_unchanged():
    # The reference reads the harness's tile, not a copy the program made.
    cell = tiny("wsi4k-fine.cerebrum")
    traffic = make_traffic(cell.traffic, 5, TINY_TILE)
    ref = load_module("reference", "wsi")
    before = traffic.tile(0).copy()
    ref.run_tile(traffic.tile(0), "cpu")
    assert (traffic.tile(0) == before).all()


# The serving cells: the port's batcher on the smoke configuration.

@pytest.mark.parametrize("name", SERVE)
def test_sound_serving_run_is_correct(name):
    result = _run(name)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"output_tokens_per_s", "ttft_p80_s", "setup_s"}
    assert set(result["checks"]) == {"logits", "token_gap", "attention"}
    assert all(c["value"] is not None for c in result["checks"].values())


@pytest.mark.parametrize("name", SERVE)
def test_serving_controls_are_not_correct(name):
    # The sound program, the float8 weights, a state zeroed once, a cache
    # read one position short; and the float32 witness, which agrees with
    # the reference to rounding.
    cell = tiny(name)
    got = control_readings(cell, 77, "cpu")
    limits = cell.limits["limits"]
    assert judge(got["program"], limits), got
    for control in ("fp8_weights", "state_zeroed", "cache_short"):
        assert not judge(got[control], limits), (control, got)
    # The short cache is seen by the attention stage.
    assert got["cache_short"]["attention"] > limits["attention"], got
    assert got["program_float32"]["logits"] < 1e-4 and got["program_float32"]["token_gap"] == 0.0


@pytest.mark.parametrize("name", SERVE)
def test_decode_state_left_unchanged_fails(monkeypatch, name):
    # A step that returns its state unchanged: each Mamba2 layer's decode
    # gives back the cache it was given.
    mamba_decode = transformer._mamba_block_decode

    def unchanged(p, x, cache, cfg):
        return mamba_decode(p, x, cache, cfg)[0], cache

    monkeypatch.setattr(transformer, "_mamba_block_decode", unchanged)
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", SERVE)
def test_token_altered_where_produced_fails(monkeypatch, name):
    # The serve step hands back a token one above the argmax it chose.
    make = serve.make_serve_step

    def altered(model, *args):
        step = make(model, *args)

        def faulty(caches, tokens, lengths):
            nxt, logits, caches, lengths = step(caches, tokens, lengths)
            return (nxt + 1) % logits.shape[-1], logits, caches, lengths

        return faulty

    monkeypatch.setattr(serve, "make_serve_step", altered)
    result = _run(name)
    assert not result["correct"] and result["checks"]["token_gap"]["value"] > 0.18


@pytest.mark.parametrize("name", SERVE)
def test_prompts_other_than_the_traffic_fail(monkeypatch, name):
    # The program serving prompts of its own, not the harness's.
    make = serve.make_prefill_step

    def shifted(model, max_len):
        step = make(model, max_len)
        return lambda inputs: step({"tokens": (inputs["tokens"] + 1) % model.cfg.vocab_size})

    monkeypatch.setattr(serve, "make_prefill_step", shifted)
    result = _run(name)
    assert not result["correct"] and result["failed"] > 0
