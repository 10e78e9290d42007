"""The mamba2_chunk_scan backward of several source trees, timed on one
card in one command.

    python3 benchmarks/torch_scan_bwd_ab.py PARENT_TREE CHANGE_TREE [VARIANT_TREE ...]

Each tree is the root of a checkout (``src/repro_torch`` inside it),
e.g. ``git archive <commit> | tar -x -C build/parent``; a variant is a
copy of the change tree with a constant edited (``BWD_MIN_BLOCKS`` in
``csrc/mamba2_scan.cu``, or ``BWD_ELEMS`` there and in the wrapper). The runs go in
the order parent, change, variants, change, parent, each in its own
process that puts its tree's ``src`` first on the path, builds that
tree's ``csrc/mamba2_scan.cu`` into the tree's own ``build/`` and times
``mamba2_chunk_scan_bwd_cuda`` at the training shape (C=8, H=4*64,
F=64*64: zamba2-1.2B's SSD state) in float32 and bfloat16. Inputs are
seeded; states come from the tree's forward kernel. Per type: g_inc
bit-equal to the plain backward and g_decay within rtol 1e-4, atol 1e-3
(the bars of ``chip_smoke.py``), bit-equal on repeat; CUDA-event median
ms with L2 flushed dirty (``chip_smoke.time_ms``, as phase 1) and clean;
device kernels per call and device ms per call from ``torch.profiler``;
the plain backward's ms; a PyTorch add that reads two tensors of the
states' size and writes one (the same bytes; no PyTorch call computes
the function); the bound (bytes at 3.35 TB/s); the plan, where the tree
has one.

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
SHAPE = (8, 256, 4096)  # (C, H, F)
DTYPES = ("float32", "bfloat16")


def _record(chip_smoke, MS, ref, dtype, flush, clean, seed) -> dict:
    import numpy as np
    import torch

    c, h, f = SHAPE
    dt = getattr(torch, dtype)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)
    mk = lambda *sh: torch.as_tensor(  # noqa: E731
        rng.normal(0, 1, sh).astype(np.float32), device=dev).to(dt)
    decay = torch.as_tensor(rng.uniform(0.3, 1.0, (c, h)).astype(np.float32), device=dev)
    states, _ = MS.mamba2_chunk_scan_cuda(decay, mk(c, h, f))
    args = (decay, states, mk(c, h, f), mk(h, f))
    fn = lambda: MS.mamba2_chunk_scan_bwd_cuda(*args)  # noqa: E731
    got, again = fn(), fn()
    chip_smoke.check(all(torch.equal(x, y) for x, y in zip(got, again)),
                     f"{dtype}: a repeated call differs")
    want = ref.mamba2_chunk_scan_bwd_ref(*args)
    err = max(chip_smoke.max_err(got[1], want[1], 0.0, 0.0, f"{dtype} g_inc"),
              chip_smoke.max_err(got[0], want[0], 1e-4, 1e-3, f"{dtype} g_decay"))
    del got, again, want
    plan = getattr(MS, "last_bwd_plan", None)
    buf = torch.empty_like(states)
    size = states.element_size()
    bound_ms, bound_by = chip_smoke.bound(size * (3 * c * h * f + h * f) + 4 * 2 * c * h,
                                          4.0 * c * h * f)
    return dict(
        dtype=dtype, shape=list(SHAPE), max_abs_err=err,
        plan=None if plan is None else dict(splits=plan.splits, vec=plan.vec, k=plan.k,
                                            threads=plan.threads),
        ms=chip_smoke.time_ms(fn, 50, flush), ms_clean_l2=chip_smoke.time_ms(fn, 50, clean),
        kernels_per_call=chip_smoke.device_kernels_per_call(fn),
        device_ms=chip_smoke.kernel_device_ms(fn, 20, clean),
        plain_ms=chip_smoke.time_ms(lambda: ref.mamba2_chunk_scan_bwd_ref(*args), 5, flush),
        bytes_yardstick_ms=chip_smoke.time_ms(
            lambda: torch.add(args[1], args[2], out=buf), 50, flush),
        bound_ms=bound_ms, bound_by=bound_by)


def _one(tree: Path) -> dict:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    import repro_torch
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import mamba2_scan as MS

    chip_smoke.check(Path(repro_torch.__file__).resolve().is_relative_to(tree.resolve()),
                     f"imported {repro_torch.__file__}, not the tree {tree}")
    t0 = time.perf_counter()
    log = _build.build_all(("mamba2_scan",))["mamba2_scan"]
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda", 0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev).zero_
    clean = torch.ones(256 << 20, dtype=torch.uint8, device=dev).max
    recs = {dt: _record(chip_smoke, MS, ref, dt, flush, clean, seed=30 + i)
            for i, dt in enumerate(DTYPES)}
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
    keys = ("ms", "ms_clean_l2", "device_ms", "bytes_yardstick_ms", "plain_ms", "bound_ms",
            "kernels_per_call")
    print("tree | " + " | ".join(f"{k}: {', '.join(keys)}" for k in DTYPES))
    for rec in rows:
        print(f"{rec['tree']} | " + " | ".join(
            ", ".join("None" if r[k] is None else f"{r[k]:.5f}" for k in keys)
            for r in rec["records"].values()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
