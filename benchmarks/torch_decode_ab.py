"""decode_attention of two source trees, timed on one card in one command.

    python3 benchmarks/torch_decode_ab.py PARENT_TREE CHANGE_TREE

Each tree is the root of a checkout (``src/repro_torch`` inside it),
e.g. ``git archive <commit> | tar -x -C build/parent``. The runs go in
the order parent, change, change, parent, each in its own process that
puts its tree's ``src`` first on the path, builds that tree's
``csrc/decode_attention.cu`` into the tree's own ``build/`` and calls
``chip_smoke.decode_records`` (this checkout's): checks against the
plain version, one launch per call, CUDA-event medians with L2 flushed,
SDPA with a length mask, the bound. A wrapper that keeps no
``last_plan`` (the two-kernel one before the redesign: 128-key splits,
a block per query head) is given one that describes its launch.

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
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]


def _one(tree: Path) -> dict:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    import repro_torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as DA

    chip_smoke.check(Path(repro_torch.__file__).resolve().is_relative_to(tree.resolve()),
                     f"imported {repro_torch.__file__}, not the tree {tree}")
    if not hasattr(DA, "last_plan"):
        launch = DA.decode_attention_cuda

        def described(q, k, v, lengths):
            splits = -(-k.shape[2] // 128)
            DA.last_plan = SimpleNamespace(splits=splits, split_keys=128, heads=1,
                                           blocks=splits * q.shape[0] * q.shape[1])
            return launch(q, k, v, lengths)

        DA.decode_attention_cuda = described
    t0 = time.perf_counter()
    log = _build.build_all(("decode_attention",))["decode_attention"]
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda").zero_
    recs = chip_smoke.decode_records(flush)
    return dict(tree=str(tree), build_s=time.perf_counter() - t0, ptxas=ptxas, records=recs)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path)
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        print(json.dumps(_one(args.one)), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"nvidia-smi: {smi.stdout.strip()}", flush=True)
    rows = []
    for tree in (args.parent, args.change, args.change, args.parent):
        res = subprocess.run([sys.executable, __file__, str(args.parent), str(args.change),
                              "--one", str(tree)], capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        rec = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps(rec), flush=True)
        rows.append(rec)
    keys = ("ms", "library_ms", "ms_clean_l2", "library_ms_clean_l2", "device_ms",
            "host_us_per_call", "bound_ms")
    print("tree | " + " | ".join(f"{k}: {', '.join(keys)}" for k in rows[0]["records"]))
    for rec in rows:
        print(f"{rec['tree']} | " + " | ".join(
            ", ".join("-" if r[k] is None else f"{r[k]:.5f}" for k in keys)
            for r in rec["records"].values()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
