"""The flash_attention backward of several source trees, timed on one card
in one command.

    python3 benchmarks/torch_flash_bwd_ab.py PARENT_TREE CHANGE_TREE [VARIANT_TREE ...]

Each tree is the root of a checkout (``src/repro_torch`` inside it),
e.g. ``git archive <commit> | tar -x -C build/parent``; a variant is a
copy of the change tree with a constant edited. The runs go in the
order parent, change, variants, change, parent, each in its own process
that puts its tree's ``src`` first on the path, builds that tree's
``csrc/flash_attention.cu`` into the tree's own ``build/`` and times
``flash_attention_bwd_cuda`` at two bfloat16 causal shapes: the
training shape (B=4, H=32, S=1024, D=64, zamba2-1.2B's attention) and
the GQA shape (B=1, H=32, Hkv=8, S=1024, D=128, the dense models'
heads). Inputs are seeded; out and lse come from the tree's forward
kernel. Per shape: the gradients against the plain backward on the
same out and lse (the bf16 bar of ``chip_smoke.py``) and bit-equal on
repeat; CUDA-event median ms with L2 flushed (``chip_smoke.time_ms``);
device kernels per call and device ms per call by kernel from
``torch.profiler``; the plain backward's ms; SDPA's backward on the same
q, k, v and dout (``enable_gqa`` for the group) as the yardstick; the
bound (bytes at 3.35 TB/s against 5 products at 989 TFLOP/s).

Prints the card's ``nvidia-smi`` name and power limit, one JSON line per
run, then a table of ms per run. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: (B, H, Hkv, S, D), all bfloat16 and causal.
SHAPES = {"training": (4, 32, 32, 1024, 64), "gqa": (1, 32, 8, 1024, 128)}


def _record(chip_smoke, FA, ref, shape, flush, seed) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    b, h, hkv, s, d = shape
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)
    mk = lambda *sh: torch.as_tensor(  # noqa: E731
        rng.normal(0, 1, sh).astype(np.float32), device=dev).bfloat16()
    q, k, v, dout = mk(b, h, s, d), mk(b, hkv, s, d), mk(b, hkv, s, d), mk(b, h, s, d)
    out, lse = FA.flash_attention_cuda(q, k, v, True, return_lse=True)
    args = (q, k, v, out, lse, dout, True)
    fn = lambda: FA.flash_attention_bwd_cuda(*args)  # noqa: E731
    got, again = fn(), fn()
    chip_smoke.check(all(torch.equal(x, y) for x, y in zip(got, again)),
                     f"{shape}: a repeated call differs")
    want = ref.flash_attention_bwd_ref(*args)
    peak = max(float(w.abs().max()) for w in want)
    err = max(chip_smoke.row_err(g, w, 2.0 ** -6, peak, f"{shape} {n}")
              for n, g, w in zip(("dq", "dk", "dv"), got, want))
    del got, again, want
    n = 10
    by_name: dict[str, list[float]] = {}
    for name, us in chip_smoke.device_events(lambda: [fn() for _ in range(n)]):
        key = re.search(r"\w+_kernel\b", name)
        by_name.setdefault(key.group(0) if key else name[:60], []).append(us)
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=hkv != h)
    sdpa = lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), dout,  # noqa: E731
                                       retain_graph=True)
    elems, kv_elems, tri = b * h * s * d, b * hkv * s * d, b * h * s * (s + 1) / 2
    bound_ms, bound_by = chip_smoke.bound(2 * (4 * elems + 4 * kv_elems) + 4 * b * h * s,
                                          5 * 2.0 * tri * d, chip_smoke.BF16_FLOPS)
    return dict(
        shape=list(shape), max_abs_err=err, ms=chip_smoke.time_ms(fn, 20, flush),
        kernels_per_call=chip_smoke.device_kernels_per_call(fn),
        device_ms_by_kernel={k: sum(us) / n / 1e3 for k, us in by_name.items()},
        plain_ms=chip_smoke.time_ms(lambda: ref.flash_attention_bwd_ref(*args), 3, flush),
        library_ms=chip_smoke.time_ms(sdpa, 20, flush), bound_ms=bound_ms, bound_by=bound_by)


def _one(tree: Path) -> dict:
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    import repro_torch
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as FA

    chip_smoke.check(Path(repro_torch.__file__).resolve().is_relative_to(tree.resolve()),
                     f"imported {repro_torch.__file__}, not the tree {tree}")
    t0 = time.perf_counter()
    log = _build.build_all(("flash_attention",))["flash_attention"]
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    build_s = time.perf_counter() - t0
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda").zero_
    recs = {name: _record(chip_smoke, FA, ref, shape, flush, seed=20 + i)
            for i, (name, shape) in enumerate(SHAPES.items())}
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
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "kernels_per_call")
    print("tree | " + " | ".join(f"{k}: {', '.join(keys)}" for k in SHAPES))
    for rec in rows:
        print(f"{rec['tree']} | " + " | ".join(
            ", ".join(f"{r[k]:.5f}" for k in keys) for r in rec["records"].values()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
