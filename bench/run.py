#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell (``BENCHMARK.json``'s
``workloads``) names a configuration and a traffic mix; the
configuration's driver (``bench/drivers/``) makes the cell's traffic
from ``--seed``, drives the port's main path on it, warms up, and
measures for ``--seconds`` seconds. After the window the run compares a
sample of the outputs the window produced with the plain reference
(``bench/reference/``), by the configuration's comparison
(``bench/compare/``), each number beside its limit
(``bench/limits/<cell>.json``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics
with ``--trace 0``, its per-layer metrics with ``--trace 1``, each read
by its reader in ``bench/metrics/``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its
limit. The same numbers are the last lines of standard error.

Exits non-zero and prints no result without a CUDA card (or with fewer
than the cell asks for), without the port's package beside ``bench/``,
or if JAX or the JAX package was loaded in this process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import NoReturn  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

from benchkit.compare import judge, within, worst  # noqa: E402
from benchkit.guard import forbidden_modules  # noqa: E402
from benchkit.spec import load_cell, load_module, load_reader, metrics_of  # noqa: E402
from benchkit.trace import breakdown, union_seconds  # noqa: E402


def fail(msg: str, code: int) -> NoReturn:
    print(f"bench/run.py: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def guard(when: str) -> None:
    bad = forbidden_modules()
    if bad:
        fail(f"{when}: modules of JAX or the JAX package were loaded: {bad}", 5)


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float) -> tuple[dict, list[str]]:
    """One run of ``cell`` on ``device``: the result object and the
    lines that show each compared number beside its limit."""
    import torch

    driver = load_module("drivers", cell.config["driver"], cell.bench)
    record, samples = driver.run(cell, seed, seconds, trace, device, t_start)
    guard("after the window")

    metrics = {}
    for m in metrics_of(cell.name, trace, cell.root):
        value = load_reader(m["name"], cell.bench)(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    on_card = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(record.window_peak_bytes)}
    extra = {}
    if trace and record.device is not None:
        dev["busy_s"] = union_seconds(record.device.clipped())
        dev["window_s"] = record.device.window_s
        extra["breakdown"] = breakdown(record.device, record.spans)

    # The program's state goes with the driver's record: free it
    # before the reference takes the card.
    done = record.done()
    errored = len(record.errors)
    del record
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    reference = load_module("reference", cell.config["reference"], cell.bench)
    comparison = load_module("compare", cell.config["compare"], cell.bench)
    per_sample = [comparison.compare(s.got, reference.run_sample(s.inputs, device))
                  for s in samples]
    numbers = worst(per_sample) if per_sample else {}
    limits = cell.limits["limits"]
    failed = errored + sum(1 for n in per_sample if not within(n, limits))
    correct = bool(per_sample) and errored == 0 and judge(numbers, limits)
    checks = {k: {"value": numbers.get(k), "limit": lim} for k, lim in limits.items()}
    lines = [f"check {k}: {c['value']!r} limit {c['limit']!r}" for k, c in checks.items()]
    lines.append(f"check samples compared: {len(per_sample)} of {len(done)}; correct {correct}")
    result = {"correct": correct, "attempted": len(done) + errored, "failed": failed,
              "metrics": metrics, "device": dev, **extra, "checks": checks}
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = load_cell(args.workload)
    except (KeyError, FileNotFoundError) as exc:
        fail(f"no such cell: {exc}", 2)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this benchmark runs on a CUDA card", 3)
    if torch.cuda.device_count() < cell.chips:
        fail(f"the cell needs {cell.chips} cards, {torch.cuda.device_count()} visible", 3)
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        fail(f"the port's package is not beside bench/ ({exc})", 4)
    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    guard("at the end")
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
