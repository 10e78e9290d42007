#!/usr/bin/env python3
"""The controls of a cell's comparison, on the card at the cell's size:
each has to come out not correct, and its smallest readings are the
upper ends that the limits in ``bench/limits/<cell>.json`` were set
below. The configuration's ``control`` module
(``bench/controls/<control>.py``) gives, for a seed, the numbers of
each control (and, where it runs the program to get them, the sound
program's as ``program``, the lower readings).

    python3 bench/control.py --workload <name> --seeds <n>[,<n>...] [--program-seeds <n>,...]
        [--device cuda]

``--program-seeds`` adds seeds on which only the sound program is read
(where the control module reads it). Prints one JSON line per seed,
then one with the least reading of each control's numbers over the
seeds, the largest of the program's (each entry whose name begins with
``program``), and whether each control failed on every seed. The
benchmark's own runs do not run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

from benchkit.compare import judge  # noqa: E402
from benchkit.spec import load_cell, load_module  # noqa: E402

__all__ = ["control_readings"]

#: The entry of a control module's readings that is the sound program's.
PROGRAM = "program"


def control_readings(cell, seed: int, device: str,
                     controls: bool = True) -> dict[str, dict[str, float]]:
    """Each control's numbers (and the sound program's) on ``seed``; with
    ``controls`` False, the sound program's alone."""
    return load_module("controls", cell.config["control"], cell.bench).readings(
        cell, seed, device, controls)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cell = load_cell(args.workload)
    limits = cell.limits["limits"]
    seen: dict[str, list[dict[str, float]]] = {}
    runs = [(int(s), True) for s in args.seeds.split(",")]
    runs += [(int(s), False) for s in args.program_seeds.split(",") if s]
    for seed, controls in runs:
        t0 = time.perf_counter()
        got = control_readings(cell, seed, args.device, controls)
        for name, numbers in got.items():
            seen.setdefault(name, []).append(numbers)
        print(json.dumps({"seed": seed, "seconds": time.perf_counter() - t0,
                          "readings": got,
                          "correct": {k: judge(v, limits) for k, v in got.items()}}), flush=True)
    summary = {}
    for name, readings in seen.items():
        keys = sorted({k for r in readings for k in r})
        pick = max if name.startswith(PROGRAM) else min
        least_or_most = {k: pick(r.get(k, float("inf")) for r in readings) for k in keys}
        summary[name] = {"numbers": least_or_most,
                         "seeds": len(readings),
                         "every_seed_failed": all(not judge(r, limits) for r in readings)}
    print(json.dumps({"workload": cell.name, "limits": limits, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
