"""feature_fused and sobel_stats of several source trees, timed on one
card in one command.

    python3 benchmarks/torch_feature_ab.py PARENT_TREE CHANGE_TREE [VARIANT_TREE ...]

Each tree is the root of a checkout (``src/repro_torch`` inside it),
e.g. ``git archive <commit> | tar -x -C build/parent``; a variant is a
copy of the change tree with a constant edited. The runs go in the
order parent, change, variants, change, parent, each in its own process
that puts its tree's ``src`` first on the path, builds that tree's two
kernels into the tree's own ``build/`` and calls
``chip_smoke.stencil_records`` (this checkout's) at 4096x4096: the
uint8 channel views of a seeded HWC tile and a seeded float32 plane,
checked against the plain versions, device kernels per call, CUDA-event
medians with L2 flushed by zeroing and by reading 256 MB, the
profiler's device time, the bound.

Prints the card's ``nvidia-smi`` name and power limit, one JSON line per
run, then a table of ms per run. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNELS = ("feature_fused", "sobel_stats")


def _one(tree: Path, seed: int = 45) -> dict:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke
    import repro_torch
    from repro_torch.kernels import _build

    chip_smoke.check(Path(repro_torch.__file__).resolve().is_relative_to(tree.resolve()),
                     f"imported {repro_torch.__file__}, not the tree {tree}")
    t0 = time.perf_counter()
    logs = _build.build_all(KERNELS)
    ptxas = {n: [ln.strip() for ln in logs[n].splitlines() if "registers" in ln or "spill" in ln]
             for n in KERNELS}
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)
    rgb = torch.as_tensor(rng.integers(0, 256, (4096, 4096, 3)).astype(np.uint8), device=dev)
    gray = torch.as_tensor(rng.uniform(0, 255, (4096, 4096)).astype(np.float32), device=dev)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev).zero_
    recs = chip_smoke.stencil_records(flush, rgb=rgb, gray=gray)
    return dict(tree=str(tree), build_s=build_s, ptxas=ptxas, records=recs)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path)
    ap.add_argument("variants", type=Path, nargs="*")
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        print(json.dumps(_one(args.one)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"nvidia-smi: {smi.stdout.strip()}", flush=True)
    rows = []
    for tree in (args.parent, args.change, *args.variants, args.change, args.parent):
        res = subprocess.run([sys.executable, __file__, str(args.parent), str(args.change),
                              "--one", str(tree)], capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        rec = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps(rec), flush=True)
        rows.append(rec)
    keys = ("ms", "ms_clean_l2", "device_ms", "copy_device_ms", "kernels_per_call", "bound_ms")
    print("tree | " + " | ".join(f"{k}: {', '.join(keys)}" for k in KERNELS))
    for rec in rows:
        print(f"{rec['tree']} | " + " | ".join(
            ", ".join("-" if rec["records"][n][k] is None else f"{rec['records'][n][k]:.5f}"
                      for k in keys) for n in KERNELS))
    return 0


if __name__ == "__main__":
    sys.exit(main())
