"""Lookup by name, and the benchmark file against the rules it keeps:
every cell's configuration, traffic, limits, driver, reference,
comparison and control exist as files of their own, every metric has
its reader, and an unknown name is refused."""

import json
import re

import pytest

from benchkit.spec import BENCH, ROOT, load_cell, load_module, load_reader, metrics_of

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
KIND = {w["name"]: load_cell(w["name"]).config["driver"] for w in SPEC["workloads"]}
WSI = sorted(n for n, d in KIND.items() if d == "wsi_manager")
SERVE = sorted(n for n, d in KIND.items() if d == "lm_serve")


def _resolves(cell):
    """What every cell has, whatever its kind."""
    c = load_cell(cell)
    assert c.chips == 1
    assert load_module("drivers", c.config["driver"]).run
    assert load_module("reference", c.config["reference"]).run_sample
    assert load_module("compare", c.config["compare"]).compare
    assert load_module("controls", c.config["control"]).readings
    assert c.limits["limits"]
    e2e = {m["name"] for m in metrics_of(cell, trace=False)}
    per_layer = {m["name"] for m in metrics_of(cell, trace=True)}
    assert {"setup_s", "peak_device_gib"} <= e2e and len(e2e) >= 3 and per_layer
    return c, e2e, per_layer


@pytest.mark.parametrize("cell", WSI)
def test_every_cell_resolves_wsi(cell):
    c, e2e, per_layer = _resolves(cell)
    assert c.config["tile"] == 4096
    assert load_module("reference", c.config["reference"]).run_tile
    assert c.limits["check_tiles"] >= 1
    assert {"tiles_per_s", "tile_p80_s"} <= e2e and "device_idle_share" in per_layer


@pytest.mark.parametrize("cell", SERVE)
def test_every_cell_resolves_serve(cell):
    c, e2e, per_layer = _resolves(cell)
    assert c.limits["check_requests"] >= 1 and 0 in c.limits["check_steps"]
    assert max(c.limits["check_steps"]) < c.traffic["max_new"]
    assert c.traffic["prompt_len"] + c.traffic["max_new"] <= c.traffic["max_len"]
    assert c.traffic["prompt_len"] % c.config["serve"]["ssd_chunk"] == 0
    assert {"output_tokens_per_s", "ttft_p80_s"} <= e2e and not {"tiles_per_s", "tile_p80_s"} & e2e
    assert {"serve_mfu", "device_idle_share.serve"} <= per_layer


def test_metrics_follow_their_cells():
    fine = {m["name"] for m in metrics_of("wsi4k-fine.cerebrum", True)}
    fused = {m["name"] for m in metrics_of("wsi4k-fused.cerebrum", True)}
    assert "color_deconv_roofline" in fine - fused
    assert "feature_fused_roofline" in fused - fine
    serve = {m["name"] for m in metrics_of("zamba2-1.2b.serve", True)}
    assert not serve & (fine | fused)


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_every_metric_has_a_reader(kind):
    e2e = {e["name"]: e for e in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC[kind]:
        assert NAME.match(m["name"]) and callable(load_reader(m["name"]))
        assert m["source"] in ("host_clock", "device_trace", "program_span", "program_counter")
        assert set(m.get("workloads", cells)) <= cells
        if kind == "end_to_end":
            assert 0.01 <= m["bound"] <= 0.25
        else:
            # The end-to-end metric it moves is reported in every cell it is.
            moved = e2e[m["moves"]]
            assert set(m.get("workloads", cells)) <= set(moved.get("workloads", cells)), m["name"]


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        load_cell("wsi4k-fine.nowhere")
    with pytest.raises(KeyError):
        load_module("metrics", "no_such_metric")
    with pytest.raises(KeyError):
        load_reader("no_such_metric.serve")


def test_a_split_quantity_is_read_by_its_stem():
    # device_idle_share.serve (the serving cells', moving their rate) has
    # no file of its own: the WSI cells' device_idle_share reads it.
    assert not (BENCH / "metrics" / "device_idle_share.serve.py").exists()
    path = load_reader("device_idle_share.serve").__code__.co_filename
    assert path == str(BENCH / "metrics" / "device_idle_share.py")


def test_files_stay_under_paths():
    assert SPEC["paths"] == ["bench"] and SPEC["command"][1].startswith("bench/")
    for c in SPEC["configs"]:
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    assert (BENCH / "run.py").exists()
    assert len({w["name"] for w in SPEC["workloads"]}) == len(SPEC["workloads"])


def test_the_harness_names_no_kind():
    # run.py and benchkit/ reach a kind's traffic, samples, reference,
    # comparison and times only through names in the files.
    words = re.compile(r"\b(tiles?|objects|n_objects|tokens?|requests?)\b", re.I)
    for path in [BENCH / "run.py", *sorted((BENCH / "benchkit").glob("*.py"))]:
        found = words.findall(path.read_text())
        assert not found, (path.name, sorted(set(found)))
