"""Lookup by name: a cell, its configuration, its traffic, its limits,
its driver, its reference, its comparison, its control and the readers
of its metrics.

Everything that belongs to one configuration, traffic mix or metric
sits in a file of its own, found by the name ``BENCHMARK.json`` gives:

* a cell (``workloads``) names a configuration and a traffic mix;
* a configuration's ``file`` holds its sizes and names its ``driver``
  (``bench/drivers/<driver>.py``: ``run(cell, seed, seconds, trace,
  device, t_start) -> (Run, [Sample])``, which makes the cell's traffic
  from the seed, runs the program and keeps the samples' inputs and
  outputs), its plain ``reference`` (``bench/reference/<reference>.py``:
  ``run_sample(inputs, device)``) and its ``compare``
  (``bench/compare/<compare>.py``: ``compare(got, want)``, the numbers
  of one sample) and its ``control`` (``bench/controls/<control>.py``:
  ``readings(cell, seed, device, controls)``, which ``bench/control.py``
  runs);
* a traffic mix is ``bench/traffic/<traffic>.json``, parameters that
  the driver's generator reads;
* a cell's limits on the numbers that decide ``correct`` are
  ``bench/limits/<cell>.json``;
* a metric, end to end or per layer, is read by
  ``bench/metrics/<metric>.py``, whose ``read(run)`` returns a number,
  or None where the run holds nothing to read. A quantity split by the
  end-to-end metric it moves (``<quantity>.<part>``: one name for the
  cells of each) is read by ``<quantity>.py`` unless the part has a
  file of its own.

A later cell, metric or configuration adds files and entries; no file
here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

__all__ = ["BENCH", "ROOT", "Cell", "load_cell", "load_module", "load_reader", "metrics_of"]

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    root: Path = ROOT      # the checkout that holds BENCHMARK.json

    @property
    def bench(self) -> Path:
        return self.root / "bench"


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` and its files; KeyError
    for a name it does not hold."""
    spec = benchmark(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = configs[cell["config"]]
    bench = root / "bench"
    return Cell(
        name=name,
        chips=int(cell["chips"]),
        config_name=config["name"],
        config=_json(root / config["file"]),
        traffic_name=cell["traffic"],
        traffic=_json(bench / "traffic" / f"{cell['traffic']}.json"),
        limits=_json(bench / "limits" / f"{name}.json"),
        root=root,
    )


def metrics_of(cell: str, trace: bool, root: Path = ROOT) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics
    with ``trace`` off, its per-layer metrics with it on; a metric with
    a ``workloads`` key only in the cells it lists."""
    spec = benchmark(root)
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in spec[kind] if cell in m.get("workloads", (cell,))]


def load_module(kind: str, name: str, bench: Path = BENCH) -> ModuleType:
    """``<bench>/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = bench / kind / f"{name}.py"
    if not path.exists():
        raise KeyError(f"no {kind} module {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(metric: str, bench: Path = BENCH):
    """The ``read`` of metric ``metric``: ``<bench>/metrics/<metric>.py``,
    else, for ``<quantity>.<part>``, ``<bench>/metrics/<quantity>.py``."""
    stem = metric.split(".", 1)[0]
    name = metric if (bench / "metrics" / f"{metric}.py").exists() else stem
    return load_module("metrics", name, bench).read
