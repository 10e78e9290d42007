"""A configuration of a kind the harness has never seen goes through
``run.run_cell`` by files alone: a temporary checkout holds its
``BENCHMARK.json`` entries, its configuration, traffic and limits, and
its driver, reference, comparison and metric readers, and nothing in
``run.py`` or ``benchkit/`` names it."""

import json
import textwrap
import time

import pytest

import run as bench_run
from benchkit.spec import load_cell

DRIVER = '''
"""A toy kind: the program sums seeded rows of integers, one row a unit."""
import time

import numpy as np

from benchkit.record import Item, Run, Sample


def run(cell, seed, seconds, trace, device, t_start):
    rows = np.random.default_rng(seed).integers(0, 100, (cell.traffic["rows"], 8))
    items, t_open = {}, time.perf_counter()
    for i, row in enumerate(rows):
        items[i] = Item(i, time.perf_counter(), None)
        items[i].done = time.perf_counter() + 1e-6
    record = Run(t_open=t_open, t_close=time.perf_counter() + 1e-3, wall_open=time.time(),
                 setup_s=t_open - t_start, items=items, counters_open={"sums": 0.0},
                 counters_close={"sums": float(len(rows))}, peak_bytes=0, window_peak_bytes=0,
                 own={"wrong_by": cell.config["wrong_by"]})
    got = [int(r.sum()) + cell.config["wrong_by"] for r in rows[:cell.limits["check"]]]
    return record, [Sample(i, rows[i].tolist(), g) for i, g in enumerate(got)]
'''

FILES = {
    "bench/configs/toy.json": {"name": "toy", "driver": "toy", "reference": "toy",
                               "compare": "toy", "control": "toy", "wrong_by": 0},
    "bench/traffic/rows.json": {"rows": 40},
    "bench/limits/toy.rows.json": {"check": 3, "limits": {"sum_error": 0}},
    "bench/drivers/toy.py": DRIVER,
    "bench/reference/toy.py": "def run_sample(inputs, device):\n    return sum(inputs)\n",
    "bench/compare/toy.py": "def compare(got, want):\n    return {'sum_error': abs(got - want)}\n",
    "bench/controls/toy.py": "def readings(cell, seed, device):\n    return {}\n",
    "bench/metrics/rows_per_s.py": "def read(run):\n    return len(run.done()) / run.seconds\n",
    "bench/metrics/setup_s.py": "def read(run):\n    return run.setup_s\n",
    "bench/metrics/sums_per_row.py":
        "def read(run):\n    return run.counter_delta('sums') / len(run.done())\n",
}


def _tree(tmp_path, wrong_by=0):
    spec = {
        "command": ["python3", "bench/run.py"], "paths": ["bench"], "run_seconds": 10,
        "configs": [{"name": "toy", "source": "a test", "file": "bench/configs/toy.json",
                     "reduced": [], "why": "a kind of its own"}],
        "workloads": [{"name": "toy.rows", "config": "toy", "traffic": "rows", "chips": 1,
                       "why": "rows of integers"}],
        "end_to_end": [{"name": "rows_per_s", "unit": "rows/s", "better": "higher", "bound": 0.05,
                        "source": "host_clock"},
                       {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
                        "source": "host_clock"}],
        "per_layer": [{"name": "sums_per_row", "unit": "count", "better": "lower",
                       "source": "program_counter", "layer": "toy", "moves": "rows_per_s"}],
    }
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    for rel, body in FILES.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        if rel == "bench/configs/toy.json":
            body = dict(body, wrong_by=wrong_by)
        path.write_text(json.dumps(body) if isinstance(body, dict) else textwrap.dedent(body))
    return load_cell("toy.rows", root=tmp_path)


@pytest.mark.parametrize("trace", [False, True])
def test_a_new_kind_runs_by_files_alone(tmp_path, trace):
    cell = _tree(tmp_path)
    result, lines = bench_run.run_cell(cell, 12345, 1.0, trace, "cpu", time.perf_counter())
    assert result["correct"] and result["attempted"] == 40 and result["failed"] == 0
    want = {"sums_per_row"} if trace else {"rows_per_s", "setup_s"}
    assert set(result["metrics"]) == want
    assert result["checks"] == {"sum_error": {"value": 0.0, "limit": 0}}
    assert lines[-1] == "check samples compared: 3 of 40; correct True"


def test_a_new_kind_that_errs_is_not_correct(tmp_path):
    cell = _tree(tmp_path, wrong_by=1)
    result, _ = bench_run.run_cell(cell, 12345, 1.0, False, "cpu", time.perf_counter())
    assert not result["correct"] and result["failed"] == 3
