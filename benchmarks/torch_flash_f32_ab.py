"""The float32 flash_attention forward of several source trees, timed on one
card in one command.

    python3 benchmarks/torch_flash_f32_ab.py PARENT_TREE CHANGE_TREE [VARIANT_TREE ...]

Each tree is the root of a checkout (``src/repro_torch`` inside it),
e.g. ``git archive <commit> | tar -x -C build/parent``; a variant is a
copy of the change tree with a constant edited. The runs go in the
order parent, change, variants, change, parent, each in its own process
that puts its tree's ``src`` first on the path, builds that tree's
``csrc/flash_attention.cu`` into the tree's own ``build/`` and times
``flash_attention_cuda`` in float32 at the shapes that phase 11 of
``chip_smoke.py`` launches (``chip_smoke.long_shapes()``, PERF.md's
rows 5k): the 5,120-token prefills of one rank, zamba2-1.2b 1x32x5120x64
and qwen1.5-4b 1x20x5120x128, causal; whisper-small's encoder 2x6x1500x64,
non-causal; the decoders' 128-token prefills 2x16x128x64 and 2x6x128x64,
causal. Inputs are seeded.

Per shape: out, and out and lse of the instantiation with the
log-sum-exp, against the plain version at 2e-5; CUDA-event median ms
with L2 flushed (``chip_smoke.time_ms``); device kernels per call; the
plain version's ms; ``scaled_dot_product_attention`` on the same
inputs (``enable_gqa``) as the yardstick, with its max abs error against
the plain version and the backend that ran it; the bound (bytes at 3.35
TB/s against three TF32 passes at 494.7 TFLOP/s) and the old one (one
pass at 67 TFLOP/s of float32 FMAs). Per tree: the registers and spills
of its float32 forward kernels (ptxas), and ``accuracy``: at the zamba2
rank shape and at peaked scores (q times 8, B=2, H=4, Hkv=2, S=1000, D 64
and 128, causal and not), the max abs error of the kernel against the
plain version and of both against exact attention (float64 on the card),
each also as a share of the float32 bar (2e-5 + 2e-5 |reference|).

Prints the card's ``nvidia-smi`` name and power limit, one JSON line per
run, then a table of ms per run. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: (B, H, Hkv, S, D, causal), float32.
SHAPES = {
    "zamba2 rank 1x32x5120x64": (1, 32, 32, 5120, 64, True),
    "qwen1.5 rank 1x20x5120x128": (1, 20, 20, 5120, 128, True),
    "whisper encoder 2x6x1500x64": (2, 6, 6, 1500, 64, False),
    "zamba2 (c) 2x16x128x64": (2, 16, 16, 128, 64, True),
    "whisper (c) 2x6x128x64": (2, 6, 6, 128, 64, True),
}
TOL = 2e-5


def _record(chip_smoke, FA, ref, shape, flush, seed) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F

    b, h, hkv, s, d, causal = shape
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)
    q, k, v = (_normal(rng, dev, *sh) for sh in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    fn = lambda: FA.flash_attention_cuda(q, k, v, causal)  # noqa: E731
    want, want_lse = ref.flash_attention_fwd_ref(q, k, v, causal)
    err = chip_smoke.max_err(fn(), want, TOL, TOL, f"{shape} out")
    got, lse = FA.flash_attention_cuda(q, k, v, causal, return_lse=True)
    err = max(err, chip_smoke.max_err(got, want, TOL, TOL, f"{shape} out (lse)"))
    lse_err = chip_smoke.max_err(lse, want_lse, TOL, TOL, f"{shape} lse")
    del got, lse, want_lse
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=causal, enable_gqa=hkv != h)
    gap = (sdpa() - want).abs()
    sdpa_err = float(gap.max())
    sdpa_within = bool((gap <= TOL + TOL * want.abs()).all())
    del gap, want
    pairs = b * h * s * ((s + 1) / 2 if causal else s)
    nbytes = 2 * (b * h + b * hkv) * s * d * 4
    bound_ms, bound_by = chip_smoke.attention_bound(nbytes, 4.0 * pairs * d, True)
    return dict(
        shape=list(shape), max_abs_err=err, lse_max_abs_err=lse_err,
        ms=chip_smoke.time_ms(fn, 20, flush),
        kernels_per_call=chip_smoke.device_kernels_per_call(fn),
        plain_ms=chip_smoke.time_ms(lambda: ref.flash_attention_ref(q, k, v, causal), 3, flush),
        library_ms=chip_smoke.time_ms(sdpa, 20, flush), library_max_abs_err=sdpa_err,
        library_within_f32_bar=sdpa_within, library_backend=chip_smoke.sdpa_backend(sdpa),
        bound_ms=bound_ms, bound_by=bound_by,
        bound_ms_cuda_cores=chip_smoke.bound(nbytes, 4.0 * pairs * d, chip_smoke.F32_FLOPS)[0])


def _normal(rng, dev, *shape):
    import numpy as np
    import torch

    return torch.as_tensor(rng.normal(0, 1, shape).astype(np.float32), device=dev)


def _exact(q, k, v, causal):
    """Attention in float64: the reference for both float32 versions."""
    import torch

    group = q.shape[1] // k.shape[1]
    k, v = (t.double().repeat_interleave(group, 1) for t in (k, v))
    q = q.double()
    s = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    if causal:
        n = s.shape[-1]
        s = s.masked_fill(torch.ones(n, n, dtype=torch.bool, device=s.device).triu(1), -math.inf)
    return torch.softmax(s, -1) @ v


def _accuracy(FA, ref) -> dict:
    import numpy as np
    import torch

    dev = torch.device("cuda", 0)
    out = {}
    cases = [("zamba2 rank", 1, 32, 32, 5120, 64, 1.0, True)]
    cases += [(f"peaked D={d}", 2, 4, 2, 1000, d, 8.0, causal)
              for d in (64, 128) for causal in (True, False)]
    for i, (name, b, h, hkv, s, d, q_scale, causal) in enumerate(cases):
        rng = np.random.default_rng(50 + i)
        q, k, v = (_normal(rng, dev, *sh) for sh in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)))
        q = q * q_scale
        got = FA.flash_attention_cuda(q, k, v, causal)
        plain = ref.flash_attention_ref(q, k, v, causal)
        exact = _exact(q, k, v, causal)

        def err(x, y):
            gap = (x.double() - y.double()).abs()
            return [float(gap.max()), float((gap / (TOL + TOL * y.double().abs())).max())]

        out[f"{name} causal={causal}"] = dict(kernel_vs_plain=err(got, plain),
                                              kernel_vs_exact=err(got, exact),
                                              plain_vs_exact=err(plain, exact))
        del got, plain, exact
    return out


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
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in float32
    t0 = time.perf_counter()
    log = _build.build_all(("flash_attention",))["flash_attention"]
    build_s = time.perf_counter() - t0
    ptxas = {n: e for n, e in chip_smoke.ptxas_entries(log).items()
             if "flash_f32_kernel" in n or "flash_fwd_kernelIf" in n}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda").zero_
    recs = {name: _record(chip_smoke, FA, ref, shape, flush, seed=30 + i)
            for i, (name, shape) in enumerate(SHAPES.items())}
    return dict(tree=str(tree), build_s=build_s, ptxas=ptxas, records=recs,
                accuracy=_accuracy(FA, ref))


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
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    print("tree | " + " | ".join(f"{k}: {', '.join(keys)}" for k in SHAPES))
    for rec in rows:
        print(f"{rec['tree']} | " + " | ".join(
            ", ".join(f"{r[k]:.5f}" for k in keys) for r in rec["records"].values()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
