"""The float32 flash_attention backward of a parent commit and of this tree,
timed on one card in one command.

    python3 benchmarks/torch_flash_bwd_f32_ab.py PARENT [VARIANT_TREE ...]
    python3 benchmarks/torch_flash_bwd_f32_ab.py --extract-only PARENT

PARENT is a commit of this repository or a tree already extracted from
one. A commit's ``src/repro_torch`` (its ``csrc/flash_attention.cu`` and
the wrapper that matches it) is read with ``git archive`` into
``build/flash_bwd_f32_ab/<commit>/``, where its kernels are built; a
machine without the repository's history (a card machine holds a copy
without ``.git``) takes that directory, made beforehand with
``--extract-only``. A variant is a copy of this tree's ``src`` under
``build/<name>/src`` with a constant edited. The runs go in the order
parent, change, variants, change, parent, each in its own process that
puts its tree's ``src`` first on the path, builds that tree's
``flash_attention.cu`` into the tree's own ``build/`` and times
``flash_attention_bwd_cuda`` in float32, causal, at four shapes: phase
7b's (B=1, H=32, S=256, D=64: zamba2-1.2B's attention, one training
step), one rank's of phase 10 (b) (B=2, H=10, S=256, D=128: qwen1.5-4b
on a model axis of 2), and two that fill the card (B=4, H=32, S=1024,
D=64; B=1, H=32, Hkv=8, S=1024, D=128). Inputs are seeded; out and lse
come from the tree's forward kernel. Per shape: the worst element's
share of the float32 bar (2**-12 of the largest |value| in its row, as
``chip_smoke.py``) against the plain backward on the same out and lse,
and against exact attention (float64 autograd on the card); bit-equal
on repeat; CUDA-event median ms with L2 flushed (``chip_smoke.time_ms``)
and with L2 flushed clean; device kernels per call and device ms per
call by kernel from ``torch.profiler``; the plain backward's ms; SDPA's
float32 backward on the same q, k, v and dout as the yardstick; the
bound (bytes at 3.35 TB/s against 5 products at three TF32 passes,
``chip_smoke.attention_bound``).

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
#: (B, H, Hkv, S, D), all float32 and causal.
SHAPES = {"phase 7b": (1, 32, 32, 256, 64), "phase 10 (b) rank": (2, 10, 10, 256, 128),
          "4x32x1024x64": (4, 32, 32, 1024, 64), "1x32(8)x1024x128": (1, 32, 8, 1024, 128)}
BAR = 2.0 ** -12


def extract(parent: str) -> Path:
    """The parent's tree: ``parent`` itself if it is a directory, else its
    ``src/repro_torch`` read from git into build/flash_bwd_f32_ab/<commit>."""
    if Path(parent).is_dir():
        return Path(parent)
    sha = subprocess.run(["git", "-C", str(ROOT), "rev-parse", "--verify", parent + "^{commit}"],
                         capture_output=True, text=True, check=True).stdout.strip()
    tree = ROOT / "build" / "flash_bwd_f32_ab" / sha[:12]
    if not (tree / "src" / "repro_torch").is_dir():
        tree.mkdir(parents=True, exist_ok=True)
        archive = subprocess.run(["git", "-C", str(ROOT), "archive", sha, "src/repro_torch"],
                                 capture_output=True, check=True).stdout
        subprocess.run(["tar", "-x", "-C", str(tree)], input=archive, check=True)
    return tree


def _share(got, want) -> float:
    """The worst element's |got - want| over its bar (BAR of its row's
    largest |want|, no row below 2**-8 of the three gradients' largest)."""
    peak = max(float(w.abs().max()) for w in want)
    worst = 0.0
    for g, w in zip(got, want):
        g, w = g.double(), w.double()
        scale = w.abs().amax(-1, keepdim=True).clamp_min(2.0 ** -8 * peak)
        worst = max(worst, float(((g - w).abs() / (BAR * scale)).max()))
    return worst


def _exact(q, k, v, dout):
    """Gradients of exact causal attention, float64 autograd."""
    import torch

    group = q.shape[1] // k.shape[1]
    qd, kd, vd = (t.double().requires_grad_() for t in (q, k, v))
    s = q.shape[2]
    scores = qd @ kd.repeat_interleave(group, 1).transpose(-1, -2) / q.shape[3] ** 0.5
    scores = scores.masked_fill(torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1),
                                float("-inf"))
    out = torch.softmax(scores, -1) @ vd.repeat_interleave(group, 1)
    return torch.autograd.grad(out, (qd, kd, vd), dout.double())


def _record(chip_smoke, FA, ref, shape, flush, clean, seed) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    b, h, hkv, s, d = shape
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)
    mk = lambda *sh: torch.as_tensor(rng.normal(0, 1, sh).astype(np.float32),  # noqa: E731
                                     device=dev)
    q, k, v, dout = mk(b, h, s, d), mk(b, hkv, s, d), mk(b, hkv, s, d), mk(b, h, s, d)
    out, lse = FA.flash_attention_cuda(q, k, v, True, return_lse=True)
    args = (q, k, v, out, lse, dout, True)
    fn = lambda: FA.flash_attention_bwd_cuda(*args)  # noqa: E731
    got, again = fn(), fn()
    chip_smoke.check(all(torch.equal(x, y) for x, y in zip(got, again)),
                     f"{shape}: a repeated call differs")
    want = ref.flash_attention_bwd_ref(*args)
    peak = max(float(w.abs().max()) for w in want)
    err = max(chip_smoke.row_err(g, w, BAR, peak, f"{shape} {n}")
              for n, g, w in zip(("dq", "dk", "dv"), got, want))
    share, share_exact = _share(got, want), _share(got, _exact(q, k, v, dout))
    del got, again, want
    torch.cuda.empty_cache()
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
    bound_ms, bound_by = chip_smoke.attention_bound(4 * (4 * elems + 4 * kv_elems) + 4 * b * h * s,
                                                    5 * 2.0 * tri * d, True)
    return dict(
        shape=list(shape), max_abs_err=err, share_of_bar=share, share_of_bar_exact=share_exact,
        ms=chip_smoke.time_ms(fn, 20, flush), ms_clean_l2=chip_smoke.time_ms(fn, 20, clean),
        kernels_per_call=chip_smoke.device_kernels_per_call(fn),
        device_ms_by_kernel={k: sum(us) / n / 1e3 for k, us in by_name.items()},
        plain_ms=chip_smoke.time_ms(lambda: ref.flash_attention_bwd_ref(*args), 3, flush),
        library_ms=chip_smoke.time_ms(sdpa, 10, flush), bound_ms=bound_ms, bound_by=bound_by)


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
    ptxas = chip_smoke.ptxas_entries(log)
    build_s = time.perf_counter() - t0
    regs = {re.sub(r"^_ZN\w*?(flash_bwd_\w+?_kernel)I(\w+?)E+v.*$", r"\1<\2>", n): e
            for n, e in ptxas.items() if "flash_bwd_" in n and "_tc_" not in n
            and "_sum_" not in n}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda").zero_
    clean = torch.ones(256 << 20, dtype=torch.uint8, device="cuda").max
    recs = {name: _record(chip_smoke, FA, ref, shape, flush, clean, seed=30 + i)
            for i, (name, shape) in enumerate(SHAPES.items())}
    return dict(tree=str(tree), build_s=build_s, ptxas=regs, records=recs)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent", help="a commit, or a tree extracted from one")
    ap.add_argument("variants", type=Path, nargs="*")
    ap.add_argument("--extract-only", action="store_true")
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one is not None:
        print(json.dumps(_one(args.one)), flush=True)
        return 0
    parent = extract(args.parent)
    if args.extract_only:
        print(parent)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"nvidia-smi: {smi.stdout.strip()}", flush=True)
    rows = []
    for tree in (parent, ROOT, *args.variants, ROOT, parent):
        res = subprocess.run([sys.executable, __file__, str(parent), "--one", str(tree)],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout[-4000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        rec = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps(rec), flush=True)
        rows.append(rec)
    keys = ("ms", "ms_clean_l2", "plain_ms", "library_ms", "bound_ms", "kernels_per_call",
            "share_of_bar", "share_of_bar_exact")
    print("tree | " + " | ".join(f"{k}: {', '.join(keys)}" for k in SHAPES))
    for rec in rows:
        print(f"{rec['tree']} | " + " | ".join(
            ", ".join(f"{r[k]:.5f}" for k in keys) for r in rec["records"].values()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
