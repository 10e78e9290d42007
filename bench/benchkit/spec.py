"""Lookup by name: a cell, its configuration, its traffic, its limits,
its driver, its reference and the readers of its metrics.

Everything that belongs to one configuration, traffic mix or metric
sits in a file of its own, found by the name ``BENCHMARK.json`` gives:

* a cell (``workloads``) names a configuration and a traffic mix;
* a configuration's ``file`` holds its sizes and names its ``driver``
  (``bench/drivers/<driver>.py``) and its plain ``reference``
  (``bench/reference/<reference>.py``);
* a traffic mix is ``bench/traffic/<traffic>.json``;
* a cell's limits on the numbers that decide ``correct`` are
  ``bench/limits/<cell>.json``;
* a metric, end to end or per layer, is read by
  ``bench/metrics/<metric>.py``, whose ``read(run)`` returns a number,
  or None where the run holds nothing to read.

A later cell, metric or configuration adds files and entries; no file
here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

__all__ = ["BENCH", "ROOT", "Cell", "load_cell", "load_module", "metrics_of"]

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
    return Cell(
        name=name,
        chips=int(cell["chips"]),
        config_name=config["name"],
        config=_json(root / config["file"]),
        traffic_name=cell["traffic"],
        traffic=_json(BENCH / "traffic" / f"{cell['traffic']}.json"),
        limits=_json(BENCH / "limits" / f"{name}.json"),
    )


def metrics_of(cell: str, trace: bool, root: Path = ROOT) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics
    with ``trace`` off, its per-layer metrics with it on; a metric with
    a ``workloads`` key only in the cells it lists."""
    spec = benchmark(root)
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in spec[kind] if cell in m.get("workloads", (cell,))]


def load_module(kind: str, name: str) -> ModuleType:
    """``bench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    if not path.exists():
        raise KeyError(f"no {kind} module {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
