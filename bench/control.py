#!/usr/bin/env python3
"""The control of a cell's comparison: the plain reference put in the
program's place and computed in the precision below the configuration's
(bfloat16 for its float32 planes and sums), judged by the cell's own
comparison against the reference in its own precision. It has to come
out not correct; its smallest readings are the upper ends the limits in
``bench/limits/<cell>.json`` were set below.

    python3 bench/control.py --workload <name> --seeds <n>[,<n>...] [--tiles <k>] [--device cuda]

Each seed makes the cell's traffic at the cell's tile size, and the
first ``k`` mosaics of it are compared (the cell's ``check_tiles`` by
default). Prints one JSON line per seed, then one with the least
reading of each number over the seeds and whether each seed failed.
The benchmark's own runs do not run it.
"""

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH)]

from benchkit.compare import compare, judge, worst  # noqa: E402
from benchkit.spec import load_cell, load_module  # noqa: E402
from benchkit.tiles import make_traffic  # noqa: E402

__all__ = ["control_readings"]


def control_readings(cell, seed: int, tiles: int, device: str) -> dict[str, float]:
    """The worst number of each kind over ``tiles`` mosaics of ``seed``:
    the reference in bfloat16 against the reference as configured."""
    import torch

    reference = load_module("reference", cell.config["reference"])
    traffic = make_traffic(cell.traffic, seed, int(cell.config["tile"]))
    per_tile = []
    for i in range(tiles):
        tile = traffic.tile(i)
        want = reference.run_tile(tile, device)
        got = reference.run_tile(tile, device, dt=torch.bfloat16, acc=torch.bfloat16)
        per_tile.append(compare(got, want))
    return worst(per_tile)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--tiles", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cell = load_cell(args.workload)
    tiles = args.tiles or int(cell.limits["check_tiles"])
    limits = cell.limits["limits"]
    readings, failed = [], []
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers = control_readings(cell, seed, tiles, args.device)
        readings.append(numbers)
        failed.append(not judge(numbers, limits))
        print(json.dumps({"seed": seed, "numbers": numbers, "correct": not failed[-1]}), flush=True)
    least = {k: min(r[k] for r in readings) for k in readings[0]}
    print(json.dumps({"workload": cell.name, "least": least, "limits": limits,
                      "every_seed_failed": all(failed)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
