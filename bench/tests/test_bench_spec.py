"""Lookup by name, and the benchmark file against the rules it keeps:
every cell's configuration, traffic, limits, driver and reference
exist as files of their own, every metric has its reader, and an
unknown name is refused."""

import json
import re

import pytest

from benchkit.spec import BENCH, ROOT, load_cell, load_module, metrics_of

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves(cell):
    c = load_cell(cell)
    assert c.chips == 1 and c.config["tile"] == 4096
    assert load_module("drivers", c.config["driver"]).run
    assert load_module("reference", c.config["reference"]).run_tile
    assert c.limits["limits"] and c.limits["check_tiles"] >= 1
    e2e = {m["name"] for m in metrics_of(cell, trace=False)}
    per_layer = {m["name"] for m in metrics_of(cell, trace=True)}
    assert "setup_s" in e2e and len(e2e) >= 2 and per_layer


def test_metrics_follow_their_cells():
    fine = {m["name"] for m in metrics_of("wsi4k-fine.cerebrum", True)}
    fused = {m["name"] for m in metrics_of("wsi4k-fused.cerebrum", True)}
    assert "color_deconv_roofline" in fine - fused
    assert "feature_fused_roofline" in fused - fine


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_every_metric_has_a_reader(kind):
    for m in SPEC[kind]:
        assert NAME.match(m["name"]) and callable(load_module("metrics", m["name"]).read)
        assert m["source"] in ("host_clock", "device_trace", "program_span", "program_counter")
        if kind == "end_to_end":
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        load_cell("wsi4k-fine.nowhere")
    with pytest.raises(KeyError):
        load_module("metrics", "no_such_metric")


def test_files_stay_under_paths():
    assert SPEC["paths"] == ["bench"] and SPEC["command"][1].startswith("bench/")
    for c in SPEC["configs"]:
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).exists()
    assert (BENCH / "run.py").exists()
    assert len({w["name"] for w in SPEC["workloads"]}) == len(SPEC["workloads"])
