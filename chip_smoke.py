#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Before the main path: prints the card's name and its ``nvidia-smi``
name and power limit, then builds every kernel from ``csrc/*.cu`` (one
``nvcc`` per source, all at once) into ``build/torch_kernels/``, prints
each kernel's registers and spills from ``ptxas``, and counts the
tensor-core instructions (``HMMA``/``HGMMA``, from ``cuobjdump -sass``)
of the bfloat16 flash_attention kernels for each head dim (forward,
backward dQ and dK/dV): it fails if one spills or has none; and fails
if an instantiation of the mamba2_chunk_scan backward spills.

Phase 1, kernels: each hand-written kernel against its plain PyTorch
version on the card, at the shapes its main path gives it, with CUDA
events (median, L2 flushed before each call) beside the plain version's
time, the bound from bytes and operations, and, for the attention
kernels, the time of ``scaled_dot_product_attention`` on the same
function. WSI kernels (color_deconv, morph_recon, feature_fused) at
4096x4096 (strided uint8 channel views of a tile) and a ragged
1000x1500 (feature_fused also on a crop of an HWC tile, its generic
path); feature_fused and sobel_stats (4096x4096, and 1000x1500 plain
and strided) each one device kernel per call, with the profiler's
device time (L2 flushed clean) and that of a PyTorch copy of the same
bytes beside the event time; the fused op at 4096x4096 on the card
against its ``cpu`` variant on the same segmented tile; morph_recon on
each of the four (marker, mask) pairs that
one tile's ops hand it (captured from ``ops.morph_recon``), each
bit-identical to the plain version in one launch, with the rounds, tile
visits and in-tile sweeps the kernel counts; flash_attention at
B=4, H=32, S=1024, D=64, bf16, causal (the zamba2-1.2B serving prefill),
plus a ragged S=1000 and a float32 case, and timed at B=1, H=32, Hkv=8,
S=1024, D=128, bf16, causal (the dense models' GQA shape; SDPA with
``enable_gqa``); decode_attention checked on a float32 GQA case (Hq=8,
Hkv=2), then at B=4, Hq=Hkv=32, S=2048, D=64, bf16, lengths [2048,
1025, 700, 1] (zamba2's decode) and at B=4, Hq=32, Hkv=8, S=16384,
D=128, bf16, lengths [16384, 9000, 4097, 1] (the dense models'
long-context GQA decode), one launch per call at each, with the split
plan the wrapper chose; mamba2_chunk_scan at C=8, H=4*64, F=64*64,
float32.

Phase 2, the WSI main path: the Manager over one WorkerRuntime with one
``gpu`` lane (PATS, locality) runs 8 tiles of 4096x4096, once with
``build_workflow(fused=False)`` and once with ``fused=True``. Checks
every stage completed on the ``gpu`` lane, the kernels' launch counts
(zeroed just before each run) rose, morph_recon launched once per
reconstruction (the scheduler's count of the four ops that run one),
and both runs agree per tile.

Phase 6 (run right after phase 2), the main path across OS processes:
the Manager in this process behind a ``ManagerEndpoint`` on a
``SocketBus``, two worker processes from ``spawn_worker``, each with one
``gpu`` lane on the card (``wsi_registry_cuda``, PATS, locality),
Manager window 2, locality-aware leases and predictive push, on the
first 4 of phase 2's tiles with ``build_workflow(fused=True)``. Region
values cross the wire as tensors through the port's codec, CRC-sealed on
the data plane. Checks both workers registered and ran stages, every
stage completed, every op ran on a ``gpu`` lane, no CRC rejects
(pulls and pushes), ``n_objects`` and every ``feat_*`` per tile equal to
phase 2's fused run (rtol 1e-3, atol 1e-4), morph_recon and
feature_fused launched in the workers (each writes its counts on exit,
``$REPRO_TORCH_LAUNCH_LOG``) and none here, and both children exit 0.
Prints seconds and tiles/s beside phase 2's, the codec's bytes, the
relay's bytes, each worker's transport counters and peak RSS.

Phase 3: one 256x256 tile through ``run_tile`` on the card and through
the numpy path, at the bars of the reference's ``tests/test_app.py``.

Phase 4, the serving path: ``serve_requests`` serves 8 requests (batch
4, prompt 1024, 32 new tokens, cache 2048) of zamba2-1.2B at full width
from seeded weights, after a short warm-up call. Checks every request
got its 32 tokens and that flash_attention, decode_attention and
mamba2_chunk_scan launched (counts zeroed just before the run); then a
profiled prefill and decode step say where the time goes.

Phase 5: zamba2-1.2B at full width cut to 8 layers (two segments, one
shared-attention application), one seed, on the card (kernels) and on
the CPU (plain versions) with the same weights. In float32: prefill
logits of a 256-token prompt (batch 2) and 4 teacher-forced decode
steps within rtol/atol 2e-2, and the same first greedy tokens. In
bfloat16, as served: every block on the card fed the CPU block's input,
within 2e-2 (the whole bfloat16 model's error is printed, not checked:
one-ulp rounding differences between the devices spread through the
later layers beyond 2e-2).

Phase 1 also holds the two backward kernels of the training path to
their plain backward versions: flash_attention at the training shape
(B=4, H=32, S=1024, D=64, bf16, causal), a ragged S=1000, float32 and
GQA (B=1, H=32, Hkv=8, D=128); mamba2_chunk_scan at C=8, H=4*64,
F=64*64, float32. A repeated call must give the same bits; the bf16
flash backward must launch ``bwd_kernels`` device kernels per call
(profiler), the scan backward one; times as above, with SDPA's backward
beside flash's at the training and GQA shapes, itself held to the bf16
bar against the plain backward on its own out, and beside the scan
backward a PyTorch add of the same bytes, its plan and its time with L2
flushed clean.

Phase 7, the training path: ``run_training`` trains zamba2-1.2B at full
width and depth (batch 4, seq 1023: 1024 tokens per row, 24 steps) from
seeded weights. Checks every loss finite, the last below the first, and
the flash and scan kernels launched forward and backward (counts zeroed
just before); prints step seconds (median after step 2), training
tokens/s and peak memory. Then a fresh model: every parameter's
gradient after one step finite and not all zero, and a profiled step
(device busy share, device time by kernel and op). Phase 7b: one train
step of the model cut to 8 layers in float32 (batch 1, 256 tokens), on
the card and on the CPU from the same weights: loss within 1e-4
relative, each gradient within 2e-3 of its norm, each updated
parameter within 1e-6 plus what the gradients' difference can move
AdamW's first step (see ``phase_train_card_vs_cpu``). Phase 7c: smoke zamba2
trained to a checkpoint under ``build/`` and resumed: the restored
state equal to the saved one, the resumed run ending at step 20 after
at most 12 chunks; the directory is removed.

Any failed check exits non-zero. The last lines are a JSON ``kernels``
record and ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS = 67e12           # H100 SXM, float32 outside the tensor cores
BF16_FLOPS = 989e12         # H100 SXM, dense bf16 on the tensor cores
REPLACES = {
    "color_deconv": "src/repro/kernels/color_deconv.py:48",
    "morph_recon": "src/repro/kernels/morph_recon.py:82",
    "feature_fused": "src/repro/kernels/feature_fused.py:128",
    "sobel_stats": "src/repro/kernels/sobel_stats.py:63",
    "flash_attention": "src/repro/kernels/flash_attention.py:93",
    "decode_attention": "src/repro/kernels/decode_attention.py:85",
    "mamba2_chunk_scan": "src/repro/kernels/mamba2_scan.py:56",
    # The backward kernels have no TPU counterpart (the JAX package
    # differentiates plain jnp): they name the forward's TPU kernel.
    "flash_attention_bwd": "src/repro/kernels/flash_attention.py:93",
    "mamba2_chunk_scan_bwd": "src/repro/kernels/mamba2_scan.py:56",
}
SOURCES = {"mamba2_chunk_scan": "mamba2_scan", "mamba2_chunk_scan_bwd": "mamba2_scan",
           "flash_attention_bwd": "flash_attention"}
PATHS = {"color_deconv": "wsi", "morph_recon": "wsi", "feature_fused": "wsi",
         "sobel_stats": None, "flash_attention": "serving",
         "decode_attention": "serving", "mamba2_chunk_scan": "serving",
         "flash_attention_bwd": "training", "mamba2_chunk_scan_bwd": "training"}
SERVE = dict(arch="zamba2_1p2b", smoke=False, n_requests=8, batch_size=4,
             prompt_len=1024, max_new=32, max_len=2048)
#: Phase 7: the loader yields seq + 1 = 1024 tokens per row, a multiple of
#: the chunked SSD's 128.
TRAIN = dict(arch="zamba2_1p2b", batch=4, seq=1023, steps=24, seed=0)
#: Phase 7b: at most this share of all elements may take the sign-flip
#: allowance, and no flipped element's gradient may exceed this share of
#: its tensor's norm: a flip is float32 noise around a gradient near 0.
FLIP_SHARE, FLIP_GRAD = 1e-5, 1e-7
N_TILES, TILE, POOL_TILE = 8, 4096, 1024
#: The ops that run one ``ops.morph_recon`` reconstruction each, per tile.
RECON_OPS = ("recon_to_nuclei", "fill_holes", "pre_watershed", "canny_edge")


class CheckFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------


def mosaic_tiles(n: int, size: int, seed: int = 11):
    """``n`` (size, size, 3) uint8 tiles, each a mosaic of a pool of 4
    distinct ``synth_tile(i, size=POOL_TILE)`` tiles with seeded flips
    and rotations (a native large synth_tile draws a full-frame mask
    per nucleus and takes minutes on a host core)."""
    import numpy as np

    from repro_torch.app.tiles import synth_tile

    pool = [synth_tile(i, size=POOL_TILE, seed=seed) for i in range(4)]
    rng = np.random.default_rng(seed)
    k = size // POOL_TILE
    tiles = []
    for _ in range(n):
        rows = []
        for _ in range(k):
            row = []
            for _ in range(k):
                p = np.rot90(pool[int(rng.integers(4))], int(rng.integers(4)))
                if rng.integers(2):
                    p = p[:, ::-1]
                row.append(p)
            rows.append(np.concatenate(row, axis=1))
        tiles.append(np.ascontiguousarray(np.concatenate(rows, axis=0)))
    return tiles


# --------------------------------------------------------------------------
# build: registers, spills and tensor-core instructions
# --------------------------------------------------------------------------


def ptxas_entries(text: str) -> dict:
    """``{entry name: {"registers", "spill_stores", "spill_loads"}}`` from
    an ``nvcc -Xptxas -v`` log."""
    out: dict[str, dict] = {}
    name = None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w.$]+)", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def hmma_counts(lib: Path) -> dict:
    """``{function name: number of tensor-core instructions (HMMA, HGMMA)}``
    of a built library, from ``cuobjdump -sass`` beside ``nvcc``."""
    from repro_torch.kernels import _build

    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    res = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                         timeout=300)
    check(res.returncode == 0, f"cuobjdump failed: {res.stderr.strip()[:400]}")
    out: dict[str, int] = {}
    name = None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = 0
        elif name is not None and re.search(r"\bH(G)?MMA\b", line):
            out[name] += 1
    return out


def flash_build_report(ptxas: dict) -> dict:
    """Registers, spills and tensor-core instruction count of the
    bfloat16 flash_attention kernels for each head dim: the forward in
    its serving instantiation (``d32`` ...: no log-sum-exp store) and its
    training one (``d32_lse`` ...), and the backward's dQ and dK/dV
    kernels (``bwd_dq_d32`` ...; dK/dV in its group-of-1 and its partial
    instantiation, ``bwd_dkdv_d32`` and ``bwd_dkdv_d32_partial``);
    registers and spills of the float32 backward (``bwd_f32``). Fails on a
    spill of a bf16 kernel or on one with no tensor-core instruction."""
    from repro_torch.kernels import _build

    entries = ptxas_entries(ptxas["flash_attention"])
    sass = hmma_counts(_build._target("flash_attention"))
    wanted = {}
    for d in (32, 64, 128):
        for lse, suffix in ((0, ""), (1, "_lse")):
            wanted[f"d{d}{suffix}"] = (f"bf16 flash kernel D={d}{suffix}",
                                       rf"flash_bf16_kernelILi{d}ELi\d+ELb{lse}E")
        wanted[f"bwd_dq_d{d}"] = (f"bf16 flash backward dQ kernel D={d}",
                                  rf"flash_bwd_dq_tc_kernelILi{d}ELi\d+ELb[01]EE")
        for part, suffix in ((0, ""), (1, "_partial")):
            wanted[f"bwd_dkdv_d{d}{suffix}"] = (
                f"bf16 flash backward dK/dV kernel D={d}{suffix}",
                rf"flash_bwd_dkdv_tc_kernelILi{d}ELi\d+ELb[01]ELb{part}EE")
    report = {}
    for name, (what, pattern) in wanted.items():
        key = re.compile(pattern)
        found = [v for n, v in entries.items() if key.search(n)]
        mma = [c for n, c in sass.items() if key.search(n)]
        check(len(found) == 1 and len(mma) == 1,
              f"{what}: {len(found)} ptxas entries, {len(mma)} SASS functions")
        report[name] = dict(found[0], hmma=mma[0])
        check(mma[0] > 0, f"{what} has no HMMA/HGMMA instruction")
        check(found[0].get("spill_stores") == 0 and found[0].get("spill_loads") == 0,
              f"{what} spills: {found[0]}")
    report["bwd_f32"] = {re.search(r"(flash_bwd_\w+?_kernel)I(\w+?)(Li\d+E)?E", n).expand(
        r"\1<\2\3>"): v for n, v in entries.items()
        if "flash_bwd_" in n and "_tc_" not in n and "_sum_" not in n}
    report["hmma_in_library"] = sum(sass.values())
    return report


def scan_bwd_build_report(ptxas: dict) -> dict:
    """Registers and spills of each instantiation of the mamba2_chunk_scan
    backward (float32 and bfloat16, 16-byte vectors and one element):
    fails if one is missing or spills."""
    entries = ptxas_entries(ptxas["mamba2_scan"])
    report = {}
    for t, tname, wide in (("f", "f32", 4), ("13__nv_bfloat16", "bf16", 8)):
        for vec in (wide, 1):
            key = re.compile(rf"mamba2_scan_bwd_kernelI{t}Li{vec}EE")
            found = [v for n, v in entries.items() if key.search(n)]
            what = f"mamba2_chunk_scan backward {tname} vec={vec}"
            check(len(found) == 1, f"{what}: {len(found)} ptxas entries")
            check(found[0].get("spill_stores") == 0 and found[0].get("spill_loads") == 0,
                  f"{what} spills: {found[0]}")
            report[f"{tname}_vec{vec}"] = found[0]
    return report


# --------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# --------------------------------------------------------------------------


def time_ms(fn, n: int, flush) -> float:
    """Median device time of ``fn`` over ``n`` runs (CUDA events), each
    after a warm-up and with L2 flushed before it."""
    import torch

    fn()
    torch.cuda.synchronize()
    ev = [
        (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for _ in range(n)
    ]
    for start, end in ev:
        flush()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in ev)
    return times[len(times) // 2]


def max_err(got, want, rtol: float, atol: float, what: str) -> float:
    g, w = got.float(), want.float()
    # Equal infinities agree; a NaN fails unless the plain version has one there too.
    same = (g == w) | (g.isnan() & w.isnan())
    err = (g - w).abs().masked_fill(same, 0.0)
    bad = ~same & ~(err <= atol + rtol * w.abs())
    check(not bool(bad.any()), f"{what}: {int(bad.sum())} elements beyond "
          f"rtol={rtol} atol={atol} (max abs err {float(err.max())})")
    return float(err.max()) if err.numel() else 0.0


def row_err(got, want, frac: float, peak: float, what: str) -> float:
    """Max abs err of ``got`` against ``want``, rtol 0: each element is
    held to ``frac`` of the largest |value| in its row (the last dim) of
    ``want``, and no row's bar drops below ``frac * 2**-8 * peak``
    (rows that are all near 0, such as causal dQ's row 0). Fails on any
    non-finite value on either side."""
    g, w = got.float(), want.float()
    check(bool(g.isfinite().all()) and bool(w.isfinite().all()),
          f"{what}: non-finite values (kernel {int((~g.isfinite()).sum())}, "
          f"plain {int((~w.isfinite()).sum())})")
    scale = w.abs().amax(-1, keepdim=True).clamp_min(2.0 ** -8 * peak)
    err = (g - w).abs()
    over = err / (frac * scale)
    check(not bool((over > 1).any()), f"{what}: {int((over > 1).sum())} elements beyond "
          f"{frac:.3g} of their row's largest value (max abs err {float(err.max())}, "
          f"worst {float(over.max()):.3g} of its bar)")
    return float(err.max()) if err.numel() else 0.0


def bound(nbytes: float, flops: float, peak: float = F32_FLOPS) -> tuple[float, str]:
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def recon_inputs(tile) -> dict:
    """``{op: (marker, mask)}``: the pairs that one tile's ops hand
    ``ops.morph_recon`` (``RECON_OPS``), captured on the card."""
    from repro_torch.kernels import ops as K

    caps = []
    kernel = K.morph_recon

    def capture(marker, mask):
        caps.append((marker.float().contiguous().clone(), mask.float().contiguous().clone()))
        return kernel(marker, mask)

    K.morph_recon = capture
    try:
        per_op_times(tile)
    finally:
        K.morph_recon = kernel
    check(len(caps) == len(RECON_OPS), f"{len(caps)} morph_recon calls on one tile")
    return dict(zip(RECON_OPS, caps))


def recon_exact(got, want, what: str) -> float:
    """Fails unless ``got`` equals ``want`` element for element (a NaN
    never does); returns the max abs error, measured."""
    import torch

    check(torch.equal(got, want), f"{what}: not bit-identical to the plain version")
    return float((got - want).abs().max()) if got.numel() else 0.0


def recon_timings(tile, flush) -> tuple[dict, float]:
    """``morph_recon_cuda`` on each pair of :func:`recon_inputs`: checked
    bit-identical to the plain version, then its launches per call, its
    max abs error, its median time and the rounds, tile visits and
    in-tile sweeps the kernel counted; and the plain version's time on
    the ``recon_to_nuclei`` pair."""
    from repro_torch.kernels import morph_recon as MR
    from repro_torch.kernels import ref

    per_input, plain_ms = {}, None
    for name, (marker, mask) in recon_inputs(tile).items():
        n0 = MR.launches
        got = MR.morph_recon_cuda(marker, mask)
        launches = MR.launches - n0
        err = recon_exact(got, ref.morph_recon_ref(marker, mask), f"morph_recon {name} input")
        ms = time_ms(lambda m=marker, k=mask: MR.morph_recon_cuda(m, k), 20, flush)
        rounds, visits, sweeps = MR.last_stats.tolist()
        per_input[name] = dict(ms=ms, launches=launches, max_abs_err=err, rounds=rounds,
                               tile_visits=visits, sweeps=sweeps)
        log(f"  morph_recon {name} input: {ms:.4f} ms, {launches} launch(es), max abs err "
            f"{err:.3g}, {rounds} rounds, {visits} tile visits, {sweeps} in-tile sweeps")
        if name == "recon_to_nuclei":
            plain_ms = time_ms(lambda m=marker, k=mask: ref.morph_recon_ref(m, k), 3, flush)
    return per_input, plain_ms


def phase_kernels(tile) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels import color_deconv as CD
    from repro_torch.kernels import feature_fused as FF
    from repro_torch.kernels import morph_recon as MR
    from repro_torch.kernels import ref

    dev = torch.device("cuda", 0)
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    flush = flush_buf.zero_
    rng = np.random.default_rng(42)
    results = {}

    def planes_of(h, w, dtype):
        mk = lambda: torch.as_tensor(  # noqa: E731
            rng.integers(0, 256, (h, w)).astype(dtype)
            if dtype == np.uint8
            else rng.uniform(0, 255, (h, w)).astype(dtype),
            device=dev,
        )
        return mk(), mk(), mk()

    # Ragged shape, both input types (no timing).
    for dtype in (np.uint8, np.float32):
        r, g, b = planes_of(1000, 1500, dtype)
        e = max(
            max_err(k, p, 3e-5, 3e-5, f"color_deconv 1000x1500 {dtype.__name__}")
            for k, p in zip(CD.color_deconv_cuda(r, g, b), ref.color_deconv_ref(r, g, b))
        )
        log(f"  color_deconv 1000x1500 {dtype.__name__}: max abs err {e:.3g}")
        got, want = FF.feature_fused_cuda(r, g, b), ref.feature_fused_ref(r, g, b)
        e = max(
            max_err(k, p, 3e-5, 1e-4, f"feature_fused 1000x1500 {dtype.__name__}")
            for k, p in zip(got[:3], want[:3])
        )
        max_err(got[3], want[3], 1e-4, 0.0, "feature_fused stats 1000x1500")
        log(f"  feature_fused 1000x1500 {dtype.__name__}: max abs err {e:.3g}")
    # feature_fused's generic path on channel views: a crop of an HWC tile
    # (rows not 16-byte aligned, row stride not 3W).
    big = np.random.default_rng(46).integers(0, 256, (1001, 1501, 3)).astype(np.uint8)
    crop = torch.as_tensor(big, device=dev)[1:, 1:]
    r, g, b = crop[..., 0], crop[..., 1], crop[..., 2]
    check(not FF.interleaved(r, g, b), "a crop took the interleaved path")
    got, want = FF.feature_fused_cuda(r, g, b), ref.feature_fused_ref(r, g, b)
    e = max(max_err(k, p, 3e-5, 1e-4, "feature_fused 1000x1500 crop")
            for k, p in zip(got[:3], want[:3]))
    max_err(got[3], want[3], 1e-4, 0.0, "feature_fused stats 1000x1500 crop")
    log(f"  feature_fused 1000x1500 crop of an HWC tile: max abs err {e:.3g}")
    mask = torch.as_tensor(rng.uniform(0, 255, (1000, 1500)).astype(np.float32), device=dev)
    marker = torch.clamp_min(mask - 55.0, 0.0) * torch.as_tensor(
        (rng.uniform(0, 1, (1000, 1500)) > 0.6).astype(np.float32), device=dev
    )
    n0 = MR.launches
    e = recon_exact(MR.morph_recon_cuda(marker, mask), ref.morph_recon_ref(marker, mask),
                    "morph_recon 1000x1500")
    rounds, visits, sweeps = MR.last_stats.tolist()
    log(f"  morph_recon 1000x1500: max abs err {e:.3g}, {MR.launches - n0} launch, "
        f"{rounds} rounds, {visits} tile visits, {sweeps} sweeps")

    # Main-path shape: strided uint8 channel views of a resident tile.
    rgb = torch.as_tensor(tile, device=dev)
    h, w = int(rgb.shape[0]), int(rgb.shape[1])
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    px = h * w

    got, want = CD.color_deconv_cuda(r, g, b), ref.color_deconv_ref(r, g, b)
    err = max(max_err(k, p, 3e-5, 3e-5, f"color_deconv {h}x{w}") for k, p in zip(got, want))
    bms, by = bound(3 * px + 12 * px, 30 * px)
    results["color_deconv"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: CD.color_deconv_cuda(r, g, b), 50, flush),
        plain_ms=time_ms(lambda: ref.color_deconv_ref(r, g, b), 10, flush),
        bound_ms=bms, bound_by=by,
    )

    check(FF.interleaved(r, g, b), "the tile's channel views missed feature_fused's fast path")
    results["feature_fused"] = stencil_records(flush, rgb=rgb)["feature_fused"]
    check(results["feature_fused"]["kernels_per_call"] == 1,
          f"feature_fused: {results['feature_fused']['kernels_per_call']} device kernels per call")
    results["feature_fused"]["fused_op_vs_cpu"] = fused_op_check(tile)

    # morph_recon on the (marker, mask) pairs the tile's four ops hand it:
    # bit-identical to the plain version, one launch each, rounds and
    # tile visits from the kernel's own counts.
    per_input, plain_ms = recon_timings(tile, flush)
    for name, res in per_input.items():
        check(res["launches"] == 1, f"morph_recon {name}: {res['launches']} launches")
    bms, by = bound(12 * px, 10 * px)
    results["morph_recon"] = dict(
        max_abs_err=max(res["max_abs_err"] for res in per_input.values()),
        ms=per_input["recon_to_nuclei"]["ms"], plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, inputs=per_input,
    )
    for name, res in results.items():
        log(f"  {name} {h}x{w}: " + ", ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}" for k, v in res.items()))
    return results


def device_events(body) -> list[tuple[str, float]]:
    """``(name, microseconds)`` of each device kernel ``torch.profiler``
    records while ``body`` runs (synchronised before the profiler stops).
    The profiler drops a kernel's record now and then, mostly the first
    of a session, and never adds one: a marker kernel
    (``torch.cuda._sleep``'s ``spin_kernel``) runs first and last, and is
    left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def session(fn):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                if e.device_type == DeviceType.CUDA]

    return [(name, us) for name, us in session(body) if "spin_kernel" not in name]


def kernel_device_ms(fn, n: int, flush) -> float | None:
    """Device time per call of what ``fn`` runs on the card, from
    ``torch.profiler`` over ``n`` calls (L2 flushed before each; the
    kernels a lone ``flush`` runs are left out): each kernel's mean time
    times the number of times it runs per call (its count over ``n``,
    rounded, so that a dropped record does not lower the time); None if
    the profiler saw none."""
    import torch

    def calls():
        for _ in range(n):
            flush()
            fn()

    fn()
    torch.cuda.synchronize()
    flushes = {name for name, _ in device_events(flush)}
    by_name: dict[str, list[float]] = {}
    for name, us in device_events(calls):
        if name not in flushes:
            by_name.setdefault(name, []).append(us)
    if not by_name:
        return None
    return sum(sum(us) / len(us) * round(len(us) / n) for us in by_name.values()) / 1e3


def device_kernels_per_call(fn, n: int = 3, tries: int = 3) -> float:
    """Device kernels per call of ``fn`` (after a warm-up): the most the
    profiler records in ``tries`` sessions of ``n`` calls (it drops a
    record now and then, and never adds one)."""
    import torch

    def calls():
        for _ in range(n):
            fn()

    fn()
    torch.cuda.synchronize()
    return max(len(device_events(calls)) for _ in range(tries)) / n


def stencil_records(flush, rgb=None, gray=None) -> dict:
    """feature_fused on the uint8 channel views of ``rgb`` ((H, W, 3) on
    the card) and sobel_stats on the float32 plane ``gray``, for those
    given. Each is checked against its plain version (feature_fused's
    planes at rtol 3e-5, atol 1e-4, sobel_stats' mag bit for bit, the
    moments at rtol 1e-4), its device kernels per call counted by the
    profiler, then timed: ``ms`` with the zeroing flush, as every kernel
    of phase 1; ``ms_clean_l2`` with a reading flush and ``device_ms``,
    the profiler's kernel time with that flush (see
    :func:`decode_records`); beside the plain version, the bound and
    ``copy_device_ms``, the profiler's time (clean flush) of a PyTorch
    copy that moves the same bytes (the uint8 tile cast to float32 in
    its own layout; the plane copied), the rate this card reaches on
    such a mix of reads and writes."""
    import torch

    from repro_torch.kernels import feature_fused as FF
    from repro_torch.kernels import ref
    from repro_torch.kernels import sobel_stats as SS

    clean = torch.ones(256 << 20, dtype=torch.uint8, device=torch.device("cuda", 0)).max
    cases = {}
    if rgb is not None:
        h, w = int(rgb.shape[0]), int(rgb.shape[1])
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        got, want = FF.feature_fused_cuda(r, g, b), ref.feature_fused_ref(r, g, b)
        err = max(max_err(k, p, 3e-5, 1e-4, f"feature_fused {h}x{w}")
                  for k, p in zip(got[:3], want[:3]))
        max_err(got[3], want[3], 1e-4, 0.0, f"feature_fused stats {h}x{w}")
        del got, want
        cast = torch.empty(3 * h * w, dtype=torch.float32, device=rgb.device)
        cases["feature_fused"] = ([h, w], err, lambda: FF.feature_fused_cuda(r, g, b),
                                  lambda: ref.feature_fused_ref(r, g, b),
                                  bound(15 * h * w + 24, 60 * h * w),
                                  lambda: cast.copy_(rgb.reshape(-1)))
    if gray is not None:
        h, w = int(gray.shape[0]), int(gray.shape[1])
        mag, st = SS.sobel_stats_cuda(gray)
        want_mag, want_st = ref.sobel_stats_ref(gray)
        err = max_err(mag, want_mag, 0.0, 0.0, f"sobel_stats {h}x{w}")
        max_err(st, want_st, 1e-4, 0.0, f"sobel_stats stats {h}x{w}")
        del mag, want_mag
        plane = torch.empty_like(gray, memory_format=torch.contiguous_format)
        cases["sobel_stats"] = ([h, w], err, lambda: SS.sobel_stats_cuda(gray),
                                lambda: ref.sobel_stats_ref(gray),
                                bound(8 * h * w + 12, 20 * h * w), lambda: plane.copy_(gray))
    out = {}
    for name, (shape, err, call, plain, (bms, by), copy) in cases.items():
        rec = out[name] = dict(
            shape=shape, max_abs_err=err, kernels_per_call=device_kernels_per_call(call),
            ms=time_ms(call, 50, flush), plain_ms=time_ms(plain, 10, flush), bound_ms=bms,
            bound_by=by, library_ms=None, ms_clean_l2=time_ms(call, 50, clean),
            device_ms=kernel_device_ms(call, 20, clean),
            copy_device_ms=kernel_device_ms(copy, 20, clean))
        log(f"  {name} {shape[0]}x{shape[1]}: {rec['ms']:.4f} ms (bound {bms:.4f}, plain "
            f"{rec['plain_ms']:.4f}; L2 flushed clean {rec['ms_clean_l2']:.4f}, profiler "
            f"{rec['device_ms']}, a copy of the same bytes {rec['copy_device_ms']}), "
            f"{rec['kernels_per_call']:g} device kernel(s) per call, max abs err {err:.3g}")
    return out


def fused_op_check(tile) -> dict:
    """The fused op at full size: ``_feature_fused_accel`` on the card
    against the ``cpu`` variant ``_feature_fused_cpu`` (numpy) on the
    same segmented state of ``tile`` (the segmentation ops run on the
    card, their state brought to the host), at the bars of
    ``tests/test_torch_app.py``. Returns each key's max abs error."""
    import numpy as np
    import torch

    from repro_torch.app._device import to_host
    from repro_torch.app.pipeline import (
        OP_IMPLS, _SEG_ORDER, _feature_fused_accel, _feature_fused_cpu,
    )

    dev = torch.device("cuda", 0)
    state = tile
    for name in _SEG_ORDER:
        state = OP_IMPLS[name][1](state, device=dev)
    state = {k: to_host(v) for k, v in state.items()}
    got, want = _feature_fused_accel(state, device=dev), _feature_fused_cpu(state)
    errs = {}
    for key, (rtol, atol) in (("hema", (3e-5, 3e-5)), ("eosin", (3e-5, 3e-5)),
                              ("feat_pixel", (1e-3, 1e-4)), ("feat_gradient", (1e-3, 1e-4))):
        g = torch.as_tensor(np.asarray(to_host(got[key]), np.float64))
        w = torch.as_tensor(np.asarray(want[key], np.float64))
        check(g.shape == w.shape, f"fused op {key}: shape {tuple(g.shape)} != {tuple(w.shape)}")
        errs[key] = max_err(g, w, rtol, atol, f"fused op {key}, card vs cpu variant")
    log(f"  fused op {tile.shape[0]}x{tile.shape[1]}, card vs cpu variant: max abs err {errs}")
    return errs


def host_us_per_call(fn, n: int) -> float:
    """Host time to issue one call, over ``n`` calls back to back (the
    device runs behind; synchronised before and after)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


#: decode_attention's timed shapes: zamba2-1.2B's decode step (row 6 of
#: PERF.md's kernel table) and the dense models' long-context GQA decode
#: with mistral-nemo-12b's heads (row 6a): (B, Hq, Hkv, S, D, lengths).
DECODE_SHAPES = {
    "main": (4, 32, 32, 2048, 64, [2048, 1025, 700, 1]),
    "gqa_long": (4, 32, 8, 16384, 128, [16384, 9000, 4097, 1]),
}


def decode_records(flush, seed: int = 44) -> dict:
    """decode_attention (bfloat16) at :data:`DECODE_SHAPES`: checked
    against the plain version, one launch per wrapper call, then timed
    beside the plain version and ``scaled_dot_product_attention`` with a
    length mask (``enable_gqa``). The bound counts each valid K/V row of
    the Hkv heads once, plus q and out. ``ms`` and ``library_ms`` flush
    L2 by zeroing 256 MB, as every kernel of phase 1 (the flush leaves
    L2 full of dirty lines, which the kernel's reads must write back);
    ``*_clean_l2`` flush it by reading 256 MB instead (L2 holds clean
    lines, as after a decode step's weight reads), and ``device_ms`` is
    the profiler's kernel time with that flush. Also the host's time to
    issue one call and the split plan of the timed launches.

    The check scales to the output: an element may differ from the plain
    version by 2**-6 of its row's largest magnitude (two bfloat16 ulps of
    that value; P is rounded to bfloat16 before P V, which moves an
    output by far less at these lengths). At 16384 keys a row's outputs
    are about 0.013 in size, so a split left out of the merge, which
    shifts them by several 1e-3, fails it."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import ref

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    buf = torch.ones(256 << 20, dtype=torch.uint8, device=dev)
    clean = buf.max  # reads 256 MB: L2 left holding clean lines
    bf16_tol = (1e-2, 1e-2)  # SDPA, the yardstick: bfloat16 rounding of P and of the output
    out = {}
    for key, (b, hq, hkv, s, d, lengths) in DECODE_SHAPES.items():
        q = torch.as_tensor(rng.normal(0, 1, (b, hq, d)).astype(np.float32), device=dev).bfloat16()
        k, v = (torch.as_tensor(rng.normal(0, 1, (b, hkv, s, d)).astype(np.float32),
                                device=dev).bfloat16() for _ in range(2))
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        n0 = DA.launches
        got = DA.decode_attention_cuda(q, k, v, lens)
        per_call = DA.launches - n0
        check(per_call == 1, f"decode_attention {key}: {per_call} launches for one call")
        want = ref.decode_attention_ref(q, k, v, lens)
        row_tol = 2.0**-6 * want.float().abs().amax(-1, keepdim=True)
        err = max_err(got, want, 0.0, row_tol, f"decode_attention {key} shape")
        mask = (torch.arange(s, device=dev)[None, :] < lens[:, None])[:, None, None, :]
        sdpa = lambda q=q, k=k, v=v, mask=mask: F.scaled_dot_product_attention(  # noqa: E731
            q[:, :, None, :], k, v, attn_mask=mask, enable_gqa=True)
        max_err(sdpa()[:, :, 0], want, *bf16_tol, f"sdpa length mask {key} (yardstick)")
        del want, got
        valid = sum(lengths)
        bms, by = bound(2 * b * hq * d * 2 + 2 * valid * hkv * d * 2 + 4 * b,
                        4.0 * valid * hq * d)
        call = lambda q=q, k=k, v=v, lens=lens: DA.decode_attention_cuda(q, k, v, lens)  # noqa: E731
        rec = dict(
            shape=[b, hq, hkv, s, d], lengths=lengths, max_abs_err=err, launches_per_call=per_call,
            ms=time_ms(call, 50, flush),
            plain_ms=time_ms(lambda: ref.decode_attention_ref(q, k, v, lens), 5, flush),
            bound_ms=bms, bound_by=by, library_ms=time_ms(sdpa, 50, flush))
        rec["ms_clean_l2"] = time_ms(call, 50, clean)
        rec["library_ms_clean_l2"] = time_ms(sdpa, 50, clean)
        rec["device_ms"] = kernel_device_ms(call, 20, clean)
        rec["host_us_per_call"] = host_us_per_call(call, 200)
        p = DA.last_plan
        rec["plan"] = dict(splits=p.splits, split_keys=p.split_keys, heads_per_block=p.heads,
                           blocks=p.blocks, blocks_per_sm=p.blocks / sms)
        log(f"  decode_attention {key} B={b} Hq={hq} Hkv={hkv} S={s} D={d} bf16 {lengths}: "
            f"{rec['ms']:.4f} ms (bound {bms:.4f}, SDPA {rec['library_ms']:.4f}, plain "
            f"{rec['plain_ms']:.4f}; L2 flushed clean {rec['ms_clean_l2']:.4f}, SDPA "
            f"{rec['library_ms_clean_l2']:.4f}, profiler {rec['device_ms']}, host "
            f"{rec['host_us_per_call']:.1f} us per call), {per_call} launch per call, "
            f"max abs err {err:.3g}, "
            f"plan {rec['plan']}")
        out[key] = rec
    return out


def phase_lm_kernels() -> dict:
    """sobel_stats and the three serving-path kernels against their plain
    versions, timed at the serving path's shapes."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import mamba2_scan as MS
    from repro_torch.kernels import ref
    from repro_torch.kernels import sobel_stats as SS

    dev = torch.device("cuda", 0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev).zero_
    rng = np.random.default_rng(43)
    gpu = lambda a, dt=torch.float32: torch.as_tensor(a, device=dev).to(dt)  # noqa: E731
    normal = lambda *shape: rng.normal(0, 1, shape).astype(np.float32)  # noqa: E731
    bf16_tol = (1e-2, 1e-2)  # one bfloat16 ulp (2**-8 relative) of output rounding
    results = {}

    # sobel_stats: the stencil's arithmetic is the plain version's, so the
    # planes must be equal; the moments are summed in another order. A
    # ragged plane, also as a transposed (strided) view; 4096x4096 is
    # checked and timed by stencil_records.
    gray = gpu(rng.uniform(0, 255, (1000, 1500)).astype(np.float32))
    for name, view in (("1000x1500", gray), ("1000x1500 strided", gray.t().contiguous().t())):
        mag, st = SS.sobel_stats_cuda(view)
        want_mag, want_st = ref.sobel_stats_ref(view)
        err = max_err(mag, want_mag, 0.0, 0.0, f"sobel_stats {name}")
        max_err(st, want_st, 1e-4, 0.0, f"sobel_stats stats {name}")
        log(f"  sobel_stats {name}: max abs err {err:.3g}")
    gray = gpu(rng.uniform(0, 255, (4096, 4096)).astype(np.float32))
    results["sobel_stats"] = stencil_records(flush, gray=gray)["sobel_stats"]
    check(results["sobel_stats"]["kernels_per_call"] == 1,
          f"sobel_stats: {results['sobel_stats']['kernels_per_call']} device kernels per call")

    # flash_attention: ragged S and float32 checks, then the prefill shape.
    for (b, h, hkv, s, dt, tol) in ((2, 8, 2, 1000, torch.bfloat16, bf16_tol),
                                    (2, 8, 8, 1000, torch.float32, (2e-5, 2e-5)),
                                    (1, 4, 4, 257, torch.float32, (2e-5, 2e-5))):
        q, k, v = (gpu(normal(*sh), dt) for sh in ((b, h, s, 64), (b, hkv, s, 64), (b, hkv, s, 64)))
        e = max_err(FA.flash_attention_cuda(q, k, v, True), ref.flash_attention_ref(q, k, v, True),
                    *tol, f"flash_attention S={s} {dt} Hkv={hkv}")
        log(f"  flash_attention B={b} H={h} Hkv={hkv} S={s} {dt}: max abs err {e:.3g}")
    b, h, s, d = 4, 32, 1024, 64
    q, k, v = (gpu(normal(b, h, s, d), torch.bfloat16) for _ in range(3))
    err = max_err(FA.flash_attention_cuda(q, k, v, True), ref.flash_attention_ref(q, k, v, True),
                  *bf16_tol, "flash_attention prefill shape")
    lib = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    max_err(lib, ref.flash_attention_ref(q, k, v, True), *bf16_tol, "sdpa causal (yardstick)")
    bms, by = bound(4 * b * h * s * d * 2, 2.0 * b * h * s * (s + 1) * d, BF16_FLOPS)
    results["flash_attention"] = dict(
        max_abs_err=err, ms=time_ms(lambda: FA.flash_attention_cuda(q, k, v, True), 20, flush),
        plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v, True), 5, flush),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
                           20, flush))
    b, h, hkv, s, d = 1, 32, 8, 1024, 128  # the dense models' GQA shape
    q = gpu(normal(b, h, s, d), torch.bfloat16)
    k, v = (gpu(normal(b, hkv, s, d), torch.bfloat16) for _ in range(2))
    want = ref.flash_attention_ref(q, k, v, True)
    err = max_err(FA.flash_attention_cuda(q, k, v, True), want, *bf16_tol,
                  "flash_attention D=128 GQA")
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=True, enable_gqa=True)
    max_err(sdpa(), want, *bf16_tol, "sdpa causal GQA (yardstick)")
    bms, by = bound(2 * (b * h + b * hkv) * s * d * 2, 2.0 * b * h * s * (s + 1) * d, BF16_FLOPS)
    results["flash_attention"]["gqa_d128"] = dict(
        shape=[b, h, hkv, s, d], max_abs_err=err,
        ms=time_ms(lambda: FA.flash_attention_cuda(q, k, v, True), 20, flush),
        plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v, True), 5, flush),
        bound_ms=bms, bound_by=by, library_ms=time_ms(sdpa, 20, flush))
    del want

    # decode_attention: GQA check, then the decode shapes (ragged lengths).
    q = gpu(normal(3, 8, 64))
    k, v = gpu(normal(3, 2, 777, 64)), gpu(normal(3, 2, 777, 64))
    lens = torch.tensor([777, 300, 1], dtype=torch.int32, device=dev)
    e = max_err(DA.decode_attention_cuda(q, k, v, lens), ref.decode_attention_ref(q, k, v, lens),
                3e-5, 3e-5, "decode_attention GQA")
    log(f"  decode_attention GQA Hq=8 Hkv=2 S=777 float32: max abs err {e:.3g}")
    recs = decode_records(flush)
    results["decode_attention"] = dict(recs.pop("main"), **recs)

    # mamba2_chunk_scan: rounded multiply, then add, as the plain version.
    c, h, f = 8, 4 * 64, 64 * 64
    decay = gpu(rng.uniform(0.3, 1.0, (c, h)).astype(np.float32))
    inc = gpu(normal(c, h, f))
    got, want = MS.mamba2_chunk_scan_cuda(decay, inc), ref.mamba2_chunk_scan_ref(decay, inc)
    err = max(max_err(g, w, 0.0, 0.0, "mamba2_chunk_scan") for g, w in zip(got, want))
    bms, by = bound(4 * (c * h + 2 * c * h * f + h * f), 2.0 * c * h * f)
    results["mamba2_chunk_scan"] = dict(
        max_abs_err=err, ms=time_ms(lambda: MS.mamba2_chunk_scan_cuda(decay, inc), 50, flush),
        plain_ms=time_ms(lambda: ref.mamba2_chunk_scan_ref(decay, inc), 10, flush),
        bound_ms=bms, bound_by=by, library_ms=None)
    for name, res in results.items():
        log(f"  {name}: " + ", ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}" for k, v in res.items()))
    return results


# --------------------------------------------------------------------------
# phase 2: the main path through Manager/Worker
# --------------------------------------------------------------------------


def run_main_path(tiles, fused: bool) -> dict:
    import torch

    from repro_torch.app import build_workflow, register_variants
    from repro_torch.app import segmentation as S
    from repro_torch.core import (
        ConcreteWorkflow, DataChunk, LaneSpec, Manager, ManagerConfig,
        VariantRegistry, WorkerRuntime,
    )
    from repro_torch.kernels import ops as K

    reg = VariantRegistry()
    register_variants(reg, device="cuda")
    cw = ConcreteWorkflow.replicate(
        build_workflow(fused=fused),
        [DataChunk(i, payload=t) for i, t in enumerate(tiles)],
    )
    rt = WorkerRuntime(0, lanes=(LaneSpec("gpu", 0),), policy="pats",
                       locality=True, variant_registry=reg)
    rt.start()
    try:
        mgr = Manager(cw, ManagerConfig(window=2, heartbeat_timeout=60))
        mgr.register_worker(rt)
        gc.collect()  # free an earlier run's tensors held in reference cycles
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        S.SWEEPS.clear()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        ok = mgr.run(timeout=900.0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = K.launch_counts()
        sweeps = dict(S.SWEEPS)
        check(ok, f"fused={fused}: Manager.run did not finish: errors={rt.errors[:3]}")
        done, total = mgr.progress()
        check(done == total == 2 * len(tiles), f"fused={fused}: {done}/{total} stages")
        profile = rt.stats()["profile"]
        off_lane = {op: k for op, k in profile.items() if set(k) != {"gpu"}}
        check(not off_lane, f"fused={fused}: ops off the gpu lane: {off_lane}")
        feats: dict[int, dict] = {}
        for si in cw.stage_instances.values():
            if si.stage.name != "features":
                continue
            out = mgr.stage_outputs(si.uid)
            for state in (out or {}).values():
                d = feats.setdefault(si.chunk.chunk_id, {})
                d.update({k: v for k, v in state.items()
                          if k.startswith("feat_") or k == "n_objects"})
        check(sorted(feats) == list(range(len(tiles))), f"fused={fused}: missing tiles")
        return dict(
            seconds=seconds,
            tiles_per_s=len(tiles) / seconds,
            peak_mem_bytes=int(torch.cuda.max_memory_allocated() - base_mem),
            launches=counts,
            sweeps=sweeps,
            profile=profile,
            lane_busy=rt.stats()["lane_busy"],
            feats=feats,
        )
    finally:
        rt.stop()


def per_op_times(tile) -> dict:
    """Host-clock seconds of each accel op on one tile (synchronised
    around each op), in pipeline order: where a tile's time goes."""
    import torch

    from repro_torch.app.pipeline import OP_IMPLS, _SEG_ORDER, _feature_fused_accel
    from repro_torch.core.calibration import PARALLEL_FEATURE_OPS

    dev = torch.device("cuda", 0)
    out: dict[str, float] = {}
    state = tile
    for name in _SEG_ORDER + ("color_deconv",) + tuple(PARALLEL_FEATURE_OPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nxt = OP_IMPLS[name][1](state, device=dev)
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
        if name in _SEG_ORDER or name == "color_deconv":
            state = nxt
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _feature_fused_accel(state, device=dev)
    torch.cuda.synchronize()
    out["feature_fused"] = time.perf_counter() - t0
    return out


def device_busy(tile, unprofiled_s: float) -> dict:
    """``per_op_times`` of one tile under ``torch.profiler``: the sum of
    device (CUDA) event durations against the host wall time of the same
    op sequence without the profiler, and the kernels that take most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        per_op_times(tile)
        profiled_s = time.perf_counter() - t0
    by_name: dict[str, float] = {}
    n = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(
        device_events=n,
        busy_s=busy,
        profiled_wall_s=profiled_s,
        unprofiled_wall_s=unprofiled_s,
        idle_share=1.0 - busy / unprofiled_s if n else None,
        top=[(name[:60], round(s, 6)) for name, s in top],
    )


# --------------------------------------------------------------------------
# phase 6: the main path across OS processes
# --------------------------------------------------------------------------

MP_TILES, MP_WORKERS = 4, 2
#: A features completion of one 4096x4096 tile carries every op's state
#: dict, about 3.8 GB on the wire (2.4 GB for segmentation); the
#: default 10 s would time the call out and re-send it.
MP_RPC_TIMEOUT = 300.0
FEAT_KEYS = ("feat_pixel", "feat_gradient", "feat_haralick", "feat_canny", "feat_morph")


def _peak_rss(who) -> int:
    import resource

    return resource.getrusage(who).ru_maxrss * 1024  # KiB on Linux


def phase_processes(tiles, want: dict) -> dict:
    """The fused workflow on ``tiles`` through a Manager here and
    ``MP_WORKERS`` spawned worker processes on the card; ``want``:
    phase 2's fused features per tile."""
    import os
    import resource
    import shutil

    import numpy as np
    import torch

    import repro_torch.transport as T
    from repro_torch.app import build_workflow
    from repro_torch.app.pipeline import LAUNCH_LOG_ENV
    from repro_torch.core import ConcreteWorkflow, DataChunk, Manager, ManagerConfig
    from repro_torch.kernels import ops as K

    launch_dir = ROOT / "build" / "phase6_launches"
    shutil.rmtree(launch_dir, ignore_errors=True)
    launch_dir.mkdir(parents=True)
    os.environ[LAUNCH_LOG_ENV] = str(launch_dir)
    gc.collect()
    torch.cuda.empty_cache()  # phase 2's cached blocks: the workers need the card
    rss_before = _peak_rss(resource.RUSAGE_SELF)
    cw = ConcreteWorkflow.replicate(
        build_workflow(fused=True),
        [DataChunk(i, payload=t) for i, t in enumerate(tiles)],
    )
    mgr = Manager(cw, ManagerConfig(
        window=2, heartbeat_timeout=60, locality_aware=True, predictive_push=True,
        backup_tasks=False, rpc_timeout=MP_RPC_TIMEOUT))
    endpoint = T.ManagerEndpoint(mgr, T.SocketBus())
    K.reset_launch_counts()
    t0 = time.perf_counter()
    procs = [
        T.spawn_worker(endpoint.address, T.WorkerSpec(
            worker_id=wid, registry="repro_torch.app.pipeline:wsi_registry_cuda",
            lanes=(("gpu", 0),), policy="pats", extra={"locality": True}))
        for wid in range(MP_WORKERS)
    ]
    try:
        check(endpoint.wait_workers(MP_WORKERS, timeout=300.0),
              f"phase 6: {len(endpoint.proxies)} of {MP_WORKERS} workers registered")
        startup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ok = mgr.run(timeout=900.0)
        seconds = time.perf_counter() - t0
        check(ok, "phase 6: Manager.run did not finish")
        done, total = mgr.progress()
        check(done == total == 2 * len(tiles), f"phase 6: {done}/{total} stages")
        stats = {wid: proxy.stats() for wid, proxy in sorted(endpoint.proxies.items())}
        feats: dict[int, dict] = {}
        for si in cw.stage_instances.values():
            if si.stage.name == "features":
                for state in (mgr.stage_outputs(si.uid) or {}).values():
                    feats.setdefault(si.chunk.chunk_id, {}).update(
                        {k: v for k, v in state.items()
                         if k.startswith("feat_") or k == "n_objects"})
        wire = dict(encoded_bytes=int(endpoint.bus.codec.encoded_bytes),
                    decoded_bytes=int(endpoint.bus.codec.decoded_bytes),
                    relay_bytes=int(endpoint.relay_bytes),
                    relay_regions=int(mgr.relay_regions),
                    push_directives=int(mgr.push_directives))
        del mgr, cw
    finally:
        endpoint.close()
        for proc in procs:
            proc.join(timeout=60.0)
        codes = [proc.exitcode for proc in procs]
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=10.0)
        os.environ.pop(LAUNCH_LOG_ENV, None)
    check(codes == [0] * MP_WORKERS, f"phase 6: worker exit codes {codes}")
    check(sum(K.launch_counts().values()) == 0, "phase 6: kernels launched in the Manager")
    logs = sorted(launch_dir.glob("launches-*.json"))
    check(len(logs) == MP_WORKERS, f"phase 6: {len(logs)} launch logs")
    per_worker = [json.loads(f.read_text()) for f in logs]
    launches = {k: sum(c[k] for c in per_worker) for k in per_worker[0]}
    check(launches["morph_recon"] > 0 and launches["feature_fused"] > 0,
          f"phase 6: kernels not launched in the workers: {launches}")
    check(sorted(stats) == list(range(MP_WORKERS)), f"phase 6: workers {sorted(stats)}")
    for wid, st in stats.items():
        check(st["executed"] > 0, f"phase 6: worker {wid} ran no op")
        off_lane = {op: k for op, k in st["profile"].items() if set(k) != {"gpu"}}
        check(not off_lane, f"phase 6: worker {wid} ops off the gpu lane: {off_lane}")
        tr = st["transport"]
        check(tr["crc_rejects"] == 0 and tr["push_crc_rejects"] == 0,
              f"phase 6: worker {wid} CRC rejects {tr}")
    check(sorted(feats) == list(range(len(tiles))), f"phase 6: tiles {sorted(feats)}")
    for cid, got in feats.items():
        check(got["n_objects"] == want[cid]["n_objects"],
              f"phase 6: tile {cid} n_objects {got['n_objects']} != {want[cid]['n_objects']}")
        for key in FEAT_KEYS:
            np.testing.assert_allclose(got[key], want[cid][key], rtol=1e-3, atol=1e-4,
                                       err_msg=f"phase 6: tile {cid} {key}")
    return dict(
        tiles=len(tiles), seconds=seconds, tiles_per_s=len(tiles) / seconds,
        startup_s=startup_s, wire=wire, launches=launches,
        launches_per_worker=per_worker,
        transport={wid: st["transport"] for wid, st in stats.items()},
        executed={wid: st["executed"] for wid, st in stats.items()},
        lane_busy={wid: st["lane_busy"] for wid, st in stats.items()},
        prefetch={wid: st.get("prefetch", {}) for wid, st in stats.items()},
        push_ingested={wid: st["push_ingested"] for wid, st in stats.items()},
        manager_peak_rss_before=rss_before,
        manager_peak_rss=_peak_rss(resource.RUSAGE_SELF),
        children_peak_rss=_peak_rss(resource.RUSAGE_CHILDREN),
    )


def log_processes(res: dict, phase2: dict) -> None:
    gib = 2 ** 30
    log(f"  {res['tiles']} tiles in {res['seconds']:.2f} s across {MP_WORKERS} worker "
        f"processes: {res['tiles_per_s']:.4f} tiles/s (phase 2 in process, fused, "
        f"8 tiles: {phase2['tiles_per_s']:.4f} tiles/s); workers up in "
        f"{res['startup_s']:.2f} s")
    w = res["wire"]
    log(f"  Manager codec: encoded {w['encoded_bytes']} B, decoded {w['decoded_bytes']} B "
        f"({w['decoded_bytes'] / res['tiles'] / gib:.3f} GiB per tile); relay "
        f"{w['relay_bytes']} B in {w['relay_regions']} regions; "
        f"{w['push_directives']} push directives")
    for wid in sorted(res["transport"]):
        log(f"  worker {wid}: executed {res['executed'][wid]} ops, lane busy "
            f"{res['lane_busy'][wid]}, push ingested {res['push_ingested'][wid]}, "
            f"transport {json.dumps(res['transport'][wid])}, "
            f"prefetch {json.dumps(res['prefetch'][wid])}")
    log(f"  Manager peak RSS {res['manager_peak_rss'] / gib:.2f} GiB "
        f"({res['manager_peak_rss_before'] / gib:.2f} GiB before phase 6); largest "
        f"child's peak RSS {res['children_peak_rss'] / gib:.2f} GiB")
    log(f"  kernel launches in the workers: {json.dumps(res['launches_per_worker'])}")


# --------------------------------------------------------------------------
# phase 3: one small tile, card vs numpy
# --------------------------------------------------------------------------


def phase_parity() -> None:
    import numpy as np

    from repro_torch.app import run_tile, synth_tile

    tile = synth_tile(1, size=256, seed=3)
    s_cpu = run_tile(tile, "cpu")
    s_acc = run_tile(tile, "accel", device="cuda")
    check(s_cpu["n_objects"] == s_acc["n_objects"],
          f"n_objects {s_cpu['n_objects']} != {s_acc['n_objects']}")
    agree = float((np.asarray(s_cpu["mask"]) == s_acc["mask"].cpu().numpy()).mean())
    check(agree > 0.999, f"mask agreement {agree}")
    np.testing.assert_allclose(s_acc["feat_haralick"], s_cpu["feat_haralick"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(s_acc["feat_pixel"], s_cpu["feat_pixel"],
                               rtol=1e-3, atol=1e-4)
    log(f"  256x256: n_objects={s_cpu['n_objects']} mask agreement={agree:.6f}")


def phase_backward_kernels() -> dict:
    """The two backward kernels of the training path against their plain
    backward versions on the card: flash_attention at the training shape
    (B=4, H=32, S=1024, D=64, bf16, causal), a ragged S=1000, float32,
    and GQA (H=32, Hkv=8, D=128); mamba2_chunk_scan at C=8, H=4*64,
    F=64*64, float32. Each must give the same bits on a repeated call;
    timed with CUDA events (median, L2 flushed) beside the bound, the
    plain version and, for attention, SDPA's backward on the same
    inputs. The scan backward's row also has its plan (splits, vec, k,
    threads), its device kernels per call (profiler; must be 1), its
    time with L2 flushed clean, and ``bytes_yardstick_ms``: a PyTorch
    add that reads two tensors of the states' size and writes one (no
    PyTorch call computes the function, so ``library_ms`` is None)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import mamba2_scan as MS
    from repro_torch.kernels import ref

    dev = torch.device("cuda", 0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev).zero_
    rng = np.random.default_rng(47)
    gpu = lambda a, dt=torch.float32: torch.as_tensor(a, device=dev).to(dt)  # noqa: E731
    normal = lambda *shape: rng.normal(0, 1, shape).astype(np.float32)  # noqa: E731
    # Forward (the lse instantiation): out at the serving forward's bars;
    # lse within 2**-8 in bfloat16 (its row sum adds P rounded to
    # bfloat16, each term within 2**-9), 2e-5 in float32.
    fwd_tol = {torch.bfloat16: (1e-2, 1e-2), torch.float32: (2e-5, 2e-5)}
    lse_tol = {torch.bfloat16: (0.0, 2.0 ** -8), torch.float32: (2e-5, 2e-5)}
    # Backward against the plain backward on the same q, k, v, out, lse and
    # dout, rtol 0: each element within ``frac`` of the largest |value| in
    # its row. bfloat16: both sides round once (one ulp, at most 2**-7 of
    # the row's largest, apart) and the kernel rounds P and dS to bfloat16
    # before its products (under 2**-7 more: derived and measured in
    # tests/test_torch_flash_bwd_numerics.py), so the bar is two ulps;
    # float32 differs by summation order only. float32 is
    # also held end to end, against the plain backward of the plain
    # forward's out and lse; in bfloat16 that would measure the forward's
    # rounding of out (one ulp of out moves Dvec = rowsum(dO * O), and so
    # a whole row of dS), not the backward.
    fracs = {torch.bfloat16: 2.0 ** -6, torch.float32: 2.0 ** -12}
    results = {}

    def flash_case(b, h, hkv, s, d, dt, what):
        q = gpu(normal(b, h, s, d), dt)
        k, v = (gpu(normal(b, hkv, s, d), dt) for _ in range(2))
        dout = gpu(normal(b, h, s, d), dt)
        out, lse = FA.flash_attention_cuda(q, k, v, True, return_lse=True)
        want_out, want_lse = ref.flash_attention_fwd_ref(q, k, v, True)
        fwd_err = max_err(out, want_out, *fwd_tol[dt], f"flash_attention forward {what} out")
        lse_err = max_err(lse, want_lse, *lse_tol[dt], f"flash_attention forward {what} lse")
        args = (q, k, v, out, lse, dout, True)
        got = FA.flash_attention_bwd_cuda(*args)
        again = FA.flash_attention_bwd_cuda(*args)
        check(all(torch.equal(a, b_) for a, b_ in zip(got, again)),
              f"flash_attention backward {what}: a repeated call differs")
        wants = {"": ref.flash_attention_bwd_ref(*args)}
        if dt == torch.float32:
            wants[" end to end"] = ref.flash_attention_bwd_ref(q, k, v, want_out, want_lse,
                                                               dout, True)
        del want_out, want_lse
        errs, note = {}, []
        for tag, want in wants.items():
            peak = max(float(w.abs().max()) for w in want)
            for n, g, w in zip(("dq", "dk", "dv"), got, want):
                errs[n + tag] = row_err(g, w, fracs[dt], peak,
                                        f"flash_attention backward {what} {n}{tag}")
                if not tag:
                    check(bool(g.any()), f"flash_attention backward {what}: {n} all zero")
                    note.append(f"{n} largest {float(w.abs().max()):.3g}, "
                                f"{float((g != w).float().mean()):.3g} of elements differ")
        err = max(v for n, v in errs.items() if n in ("dq", "dk", "dv"))
        log(f"  flash_attention backward {what} B={b} H={h} Hkv={hkv} S={s} D={d} {dt}: "
            f"max abs err {err:.3g} (forward out {fwd_err:.3g}, lse {lse_err:.3g}"
            + (f", end to end {max(errs.values()):.3g}" if dt == torch.float32 else "")
            + f"); {', '.join(note)}; bit-equal on repeat")
        return err, args

    def sdpa_case(args, what):
        """SDPA's backward on the same q, k, v and dout (its own forward:
        ``enable_gqa`` for a group), held to the bar against the plain
        backward on SDPA's out and the plain forward's lse, as the kernel
        is on its own; returned for timing."""
        q, k, v, _, _, dout, _ = args
        qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                  enable_gqa=k.shape[1] != q.shape[1])
        sdpa_bwd = lambda: torch.autograd.grad(sdpa_out, (qs, ks, vs), dout,  # noqa: E731
                                               retain_graph=True)
        want = ref.flash_attention_bwd_ref(q, k, v, sdpa_out.detach(),
                                           ref.flash_attention_fwd_ref(q, k, v, True)[1],
                                           dout, True)
        peak = max(float(w.abs().max()) for w in want)
        errs = [row_err(g, w, fracs[torch.bfloat16], peak, f"sdpa backward {what} {n}")
                for n, g, w in zip(("dq", "dk", "dv"), sdpa_bwd(), want)]
        log(f"  sdpa backward {what} (yardstick): within the bf16 bar of the plain backward "
            f"on its own out, max abs err dq, dk, dv {[float(f'{e:.3g}') for e in errs]}")
        return sdpa_bwd

    def kernel_record(b, h, hkv, s, d, err, args, sdpa_bwd):
        fn = lambda: FA.flash_attention_bwd_cuda(*args)  # noqa: E731
        per_call = device_kernels_per_call(fn)
        want = FA.bwd_kernels(torch.bfloat16, h // hkv)
        check(per_call == want, f"flash_attention backward H={h} Hkv={hkv}: {per_call:g} "
              f"device kernels per call, not {want}")
        elems, kv_elems, tri = b * h * s * d, b * hkv * s * d, b * h * s * (s + 1) / 2
        # q, o, dout, dq (B, H, S, D), k, v, dk, dv (B, Hkv, S, D) and lse, once
        nbytes = 2 * (4 * elems + 4 * kv_elems) + 4 * b * h * s
        bms, by = bound(nbytes, 5 * 2.0 * tri * d, BF16_FLOPS)
        return dict(shape=[b, h, hkv, s, d], max_abs_err=err, kernels_per_call=per_call,
                    ms=time_ms(fn, 10, flush),
                    plain_ms=time_ms(lambda: ref.flash_attention_bwd_ref(*args), 3, flush),
                    bound_ms=bms, bound_by=by, library_ms=time_ms(sdpa_bwd, 10, flush))

    flash_case(2, 8, 2, 1000, 64, torch.bfloat16, "ragged")
    flash_case(2, 8, 8, 1000, 64, torch.float32, "float32")
    b, h, hkv, s, d = 1, 32, 8, 1024, 128
    err, args = flash_case(b, h, hkv, s, d, torch.bfloat16, "GQA")
    gqa = kernel_record(b, h, hkv, s, d, err, args, sdpa_case(args, "GQA"))
    del args
    b, h, s, d = 4, 32, 1024, 64
    err, args = flash_case(b, h, h, s, d, torch.bfloat16, "training shape")
    results["flash_attention_bwd"] = dict(
        kernel_record(b, h, h, s, d, err, args, sdpa_case(args, "training shape")),
        gqa_d128=gqa)
    del args
    gc.collect()
    torch.cuda.empty_cache()

    c, h, f = 8, 4 * 64, 64 * 64
    decay = gpu(rng.uniform(0.3, 1.0, (c, h)).astype(np.float32))
    states, _ = MS.mamba2_chunk_scan_cuda(decay, gpu(normal(c, h, f)))
    g_states, g_final = gpu(normal(c, h, f)), gpu(normal(h, f))
    args = (decay, states, g_states, g_final)
    got, again = MS.mamba2_chunk_scan_bwd_cuda(*args), MS.mamba2_chunk_scan_bwd_cuda(*args)
    check(all(torch.equal(a, b_) for a, b_ in zip(got, again)),
          "mamba2_chunk_scan backward: a repeated call differs")
    check(all(bool(t.isfinite().all()) and bool(t.any()) for t in got),
          "mamba2_chunk_scan backward: a non-finite or all-zero gradient")
    want = ref.mamba2_chunk_scan_bwd_ref(*args)
    # g_inc: the same rounded multiply, then add; g_decay: a sum over F in
    # another order.
    err = max(max_err(got[1], want[1], 0.0, 0.0, "mamba2_chunk_scan backward g_inc"),
              max_err(got[0], want[0], 1e-4, 1e-3, "mamba2_chunk_scan backward g_decay"))
    plan = MS.last_bwd_plan
    fn = lambda: MS.mamba2_chunk_scan_bwd_cuda(*args)  # noqa: E731
    per_call = device_kernels_per_call(fn)
    check(per_call == 1, f"mamba2_chunk_scan backward: {per_call:g} device kernels per call, "
          "not 1")
    bms, by = bound(4 * (c * h + 3 * c * h * f + h * f + c * h), 4.0 * c * h * f)
    # No PyTorch call computes this function (library_ms None); the
    # yardstick moves the same bytes: reads two (C, H, F) tensors, writes one.
    buf = torch.empty_like(states)
    clean = torch.ones(256 << 20, dtype=torch.uint8, device=dev).max
    results["mamba2_chunk_scan_bwd"] = dict(
        max_abs_err=err, ms=time_ms(fn, 50, flush),
        plain_ms=time_ms(lambda: ref.mamba2_chunk_scan_bwd_ref(*args), 10, flush),
        bound_ms=bms, bound_by=by, library_ms=None, shape=[c, h, f],
        plan=dict(splits=plan.splits, vec=plan.vec, k=plan.k, threads=plan.threads),
        kernels_per_call=per_call, ms_clean_l2=time_ms(fn, 50, clean),
        bytes_yardstick_ms=time_ms(lambda: torch.add(states, g_states, out=buf), 50, flush))
    for name, res in results.items():
        log(f"  {name}: " + ", ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}" for k, v in res.items()))
    return results


# --------------------------------------------------------------------------
# phase 7: training zamba2-1.2B at full width; 7b: card against CPU; 7c: resume
# --------------------------------------------------------------------------


def training_profile(steps: int = 2) -> dict:
    """A fresh full-width model: every parameter's gradient after one
    step finite and not all zero (the autograd path is connected), then
    ``steps`` timed steps and one profiled step: device busy share
    against the unprofiled step's wall time, device time by kernel and by
    PyTorch op, and the port's kernels' device time."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenChunkSource
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.train import TrainState, loss_and_grads, make_train_step

    dev = torch.device("cuda", 0)
    cfg = get_config(TRAIN["arch"])
    model = build_model(cfg, device=dev, seed=TRAIN["seed"], trainable=True)
    src = TokenChunkSource(cfg.vocab_size, TRAIN["seq"], TRAIN["batch"], seed=TRAIN["seed"])
    batch = {"tokens": torch.as_tensor(src(0), device=dev).long()}
    _, _, grads = loss_and_grads(model, batch)
    bad = [n for n, g in grads.items() if not bool(torch.isfinite(g).all()) or not bool(g.any())]
    check(not bad, f"phase 7: parameters with a non-finite or all-zero gradient: {bad[:8]}")
    n_grads = len(grads)
    del grads
    opt = AdamW(lr=cosine_schedule(3e-4, warmup_steps=20, total_steps=TRAIN["steps"]))
    params = dict(model.named_parameters())
    state = TrainState(params, opt.init(params))
    step = make_train_step(model, opt)
    walls = []
    run = {"state": state}

    def one_step(i):
        b = {"tokens": torch.as_tensor(src(1 + i), device=dev).long()}
        run["state"], _ = step(run["state"], b)

    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step(i)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out = dict(parameters_with_gradient=n_grads, step_wall_s=walls,
               **profiled(lambda: one_step(steps), walls[-1]))
    del model, state, step, opt, params, run
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_training() -> dict:
    """zamba2-1.2B at full width and depth through ``run_training``:
    every logged loss finite, the last below the first, the flash and
    scan kernels launched forward and backward (counts zeroed just
    before); step seconds (median after step 2), tokens/s, peak memory;
    then the gradient check and a profiled step (``training_profile``)."""
    import statistics

    import numpy as np
    import torch

    from repro_torch.kernels import ops as K
    from repro_torch.launch.train import run_training

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    out = run_training(arch=TRAIN["arch"], smoke=False, batch=TRAIN["batch"],
                       seq=TRAIN["seq"], steps=TRAIN["steps"], seed=TRAIN["seed"],
                       log_every=1, device="cuda")
    counts = K.launch_counts()
    peak = int(torch.cuda.max_memory_allocated() - base_mem)
    del out["state"]
    gc.collect()
    torch.cuda.empty_cache()
    losses = [m["loss"] for m in out["metrics"]]
    check(out["final_step"] == TRAIN["steps"], f"phase 7: {out['final_step']} steps")
    check(bool(np.isfinite(losses).all()), f"phase 7: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"phase 7: loss did not fall: {losses[0]} -> {losses[-1]}")
    for name in ("flash_attention", "flash_attention_bwd", "mamba2_chunk_scan",
                 "mamba2_chunk_scan_bwd"):
        check(counts[name] > 0, f"phase 7 launched no {name} kernel")
    secs = [m["seconds"] for m in out["metrics"]]
    step_s = [b - a for a, b in zip(secs, secs[1:])][1:]  # steps 3.. (after step 2)
    med = statistics.median(step_s)
    res = dict(losses=losses, step_s_median=med, step_s=step_s,
               tokens_per_s=TRAIN["batch"] * TRAIN["seq"] / med,
               run_tokens_per_s=out["metrics"][-1]["tps"], peak_mem_bytes=peak,
               launches=counts)
    log(f"  {TRAIN['steps']} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}; step "
        f"{med:.4f} s (median after step 2), {res['tokens_per_s']:.1f} training tokens/s "
        f"({res['run_tokens_per_s']:.1f} over the run), peak "
        f"{peak / 2**30:.2f} GiB above the start; launches {counts}")
    log(f"  losses {[round(x, 4) for x in losses]}")
    res["profile"] = training_profile()
    log("  profiled step: " + json.dumps(res["profile"]))
    return res


def phase_train_card_vs_cpu() -> dict:
    """One ``make_train_step`` step of zamba2-1.2B at full width cut to 8
    layers, float32, batch 1 x 256 tokens, from the same weights and
    tokens on the card (kernels) and on the CPU (plain versions): loss
    within 1e-4 relative; each gradient within 2e-3 of its tensor's
    norm; each updated parameter within 1e-6 plus what the two
    gradients' difference can move AdamW's first step. That step moves
    an element by lr * g / (|g| + eps) (g clipped, held by the first
    moment as (1 - b1) g): two gradients dg apart move it at most
    lr * dg * eps / (min|g| + eps)^2 apart, or 2 lr where their signs
    differ. So an element whose gradient is near eps = 1e-8 may move by
    up to lr either way: a bar relative to the tensor's norm alone does
    not hold there (a small tensor such as conv_b, which starts at zero,
    can miss 2e-3 of its norm). The elements given the 2 lr allowance are
    counted and held to ``FLIP_SHARE`` of all elements, each with a
    gradient under ``FLIP_GRAD`` of its tensor's norm."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as K
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.train import loss_and_grads

    cfg = dataclasses.replace(get_config(TRAIN["arch"]), n_layers=8)
    dev = torch.device("cuda", 0)
    toks = torch.as_tensor(np.random.default_rng(6).integers(0, cfg.vocab_size, (1, 256)))
    cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(6),
                      trainable=True, act_dtype=torch.float32)
    card = copy.deepcopy(cpu).to(dev)
    opt = AdamW(lr=1e-3)
    K.reset_launch_counts()
    res = {}
    for name, model, t in (("cpu", cpu, toks), ("card", card, toks.to(dev))):
        t0 = time.perf_counter()
        loss, _, grads = loss_and_grads(model, {"tokens": t})
        params = dict(model.named_parameters())
        old = {k: p.detach().cpu().clone() for k, p in params.items()}
        kept = {k: g.cpu().clone() for k, g in grads.items()}
        _, state = opt.update(grads, opt.init(params), params)
        res[name] = dict(loss=float(loss), grads=kept, old=old,
                         new={k: p.detach().cpu() for k, p in params.items()},
                         g_used={k: (m / (1 - opt.b1)).cpu() for k, m in state.mu.items()},
                         seconds=time.perf_counter() - t0)
    counts = K.launch_counts()
    for name in ("flash_attention", "flash_attention_bwd", "mamba2_chunk_scan",
                 "mamba2_chunk_scan_bwd"):
        check(counts[name] > 0, f"phase 7b launched no {name} kernel")
    lc, lg = res["cpu"]["loss"], res["card"]["loss"]
    c, g = res["cpu"], res["card"]
    grad_rel, upd_over, flips, flip_g = {}, {}, {}, {}
    for k, gw in c["grads"].items():
        grad_rel[k] = float((g["grads"][k] - gw).abs().max()) / max(float(gw.norm()), 1e-12)
        g1, g2 = g["g_used"][k].double(), c["g_used"][k].double()
        drift = (g1 - g2).abs() * opt.eps / (torch.minimum(g1.abs(), g2.abs()) + opt.eps) ** 2
        flip = g1.sign() != g2.sign()
        bound = 1e-6 + opt.lr * torch.where(flip, torch.full_like(drift, 2.0), drift)
        upd_over[k] = float(((g["new"][k] - c["new"][k]).abs().double() / bound).max())
        # The elements given the sign-flip allowance, and the largest
        # gradient among them as a share of its tensor's norm.
        flips[k] = int(flip.sum())
        flip_g[k] = (float(torch.maximum(g1.abs(), g2.abs())[flip].max())
                     / max(float(g2.norm()), 1e-30)) if flips[k] else 0.0
    worst_g = max(grad_rel, key=grad_rel.get)
    worst_p = max(upd_over, key=upd_over.get)
    worst_f = max(flip_g, key=flip_g.get)
    n_flips, n_elems = sum(flips.values()), sum(t.numel() for t in c["grads"].values())
    upd_rel = max(float((g["new"][k] - c["new"][k]).abs().max()) / max(
        float((c["new"][k] - c["old"][k]).norm()), 1e-12) for k in c["new"])
    out = dict(loss_cpu=lc, loss_card=lg, grad_err_of_norm=grad_rel[worst_g],
               worst_grad=worst_g, update_err_of_bound=upd_over[worst_p], worst_update=worst_p,
               update_err_of_update_norm=upd_rel, sign_flips=n_flips,
               sign_flip_grad_of_norm=flip_g[worst_f], cpu_s=c["seconds"],
               card_s=g["seconds"], launches=counts)
    log(f"  loss card {lg:.6f}, CPU {lc:.6f}; worst gradient error {grad_rel[worst_g]:.3g} "
        f"of its norm ({worst_g}); worst updated parameter {upd_over[worst_p]:.3g} of its "
        f"bound ({worst_p}), {upd_rel:.3g} of its update's norm at most "
        f"({len(grad_rel)} tensors); sign-flip allowance taken by {n_flips} of {n_elems} "
        f"elements ({dict((k, n) for k, n in flips.items() if n)}), their largest gradient "
        f"{flip_g[worst_f]:.3g} of its tensor's norm ({worst_f}); CPU {c['seconds']:.1f} s; "
        f"launches {counts}")
    check(abs(lg - lc) <= 1e-4 * abs(lc), f"phase 7b loss: card {lg}, CPU {lc}")
    check(grad_rel[worst_g] <= 2e-3, f"phase 7b gradient {worst_g}: max abs err "
          f"{grad_rel[worst_g]:.3g} of its norm")
    check(upd_over[worst_p] <= 1.0, f"phase 7b updated {worst_p}: beyond its bound "
          f"({upd_over[worst_p]:.3g} of it)")
    check(n_flips <= FLIP_SHARE * n_elems, f"phase 7b: {n_flips} of {n_elems} elements took "
          f"the sign-flip allowance (limit {FLIP_SHARE:g} of them)")
    check(flip_g[worst_f] <= FLIP_GRAD, f"phase 7b {worst_f}: a sign flip at a gradient "
          f"{flip_g[worst_f]:.3g} of its norm (limit {FLIP_GRAD:g})")
    del cpu, card, res, c, g
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_train_resume() -> dict:
    """Smoke zamba2 with a checkpoint directory under ``build/``: train 12
    steps (checkpoints at 6 and 12), the restored state equal to the
    saved one, then resume to step 20: the reference's
    ``test_restart_resumes_mid_epoch`` expectations. The directory is
    removed afterwards."""
    import shutil

    import torch

    from repro_torch.ckpt import load_checkpoint
    from repro_torch.ckpt.checkpoint import tree_leaves
    from repro_torch.launch.train import run_training

    ck = ROOT / "build" / "phase7c_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    try:
        kw = dict(arch=TRAIN["arch"], smoke=True, batch=2, seq=32, device="cuda")
        first = run_training(steps=12, ckpt_dir=str(ck), ckpt_every=6, log_every=6, **kw)
        saved, manifest = load_checkpoint(ck, first["state"])
        check(manifest["step"] == 12, f"phase 7c: checkpoint of step {manifest['step']}")
        pairs = list(zip(tree_leaves(saved), tree_leaves(first["state"])))
        check(len(pairs) > 0 and all(torch.equal(a, b.detach().cpu()) for a, b in pairs),
              "phase 7c: the restored state differs from the saved one")
        check(int(saved.opt.step) == 12, f"phase 7c: optimizer step {int(saved.opt.step)}")
        out = run_training(steps=20, ckpt_dir=str(ck), resume=True, log_every=4, **kw)
        check(out["final_step"] == 20, f"phase 7c: resumed run ended at {out['final_step']}")
        check(out["chunks"] <= 20 - 12 + 4, f"phase 7c: resumed run read {out['chunks']} chunks")
        res = dict(final_step=out["final_step"], chunks=out["chunks"],
                   losses=[m["loss"] for m in first["metrics"] + out["metrics"]])
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    check(not ck.exists(), "phase 7c: checkpoint directory left behind")
    log(f"  restored state equal to the saved one; resumed to step {res['final_step']} "
        f"reading {res['chunks']} chunks; losses {[round(x, 4) for x in res['losses']]}")
    return res


# --------------------------------------------------------------------------


# --------------------------------------------------------------------------
# phase 4: serving zamba2-1.2B; phase 5: card against CPU
# --------------------------------------------------------------------------


def serving_profile(steps: int = 4) -> dict:
    """One prefill (batch 4 x 1024) and ``steps`` decode steps of the
    full model, each part timed on the host clock and then run again
    under ``torch.profiler``: device busy share against the unprofiled
    wall time, device kernels per call, device time by kernel and by the
    PyTorch op that launched it, and the device time of each kernel of
    ``csrc/*.cu``."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    dev = torch.device("cuda", 0)
    model = build_model(get_config(SERVE["arch"]), device=dev, seed=1)
    b, n = SERVE["batch_size"], SERVE["prompt_len"]
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, 32000, (b, n + steps)),
                           device=dev)
    state = {}

    def prefill():
        _, state["caches"] = model.prefill({"tokens": toks[:, :n]}, SERVE["max_len"])

    def decode():
        for i in range(steps):
            pos = torch.full((b,), n + i, dtype=torch.int32, device=dev)
            model.decode_step(state["caches"], toks[:, n + i], pos)

    out = {}
    for part, fn, calls in (("prefill", prefill, 1), ("decode", decode, steps)):
        fn()  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out[part] = profiled(fn, time.perf_counter() - t0, calls)
    del model, state
    return out


def profiled(fn, wall: float, calls: int = 1) -> dict:
    """Run ``fn`` (``calls`` calls of some work) once more under
    ``torch.profiler``, synchronised before it stops: per call, the
    device busy share against ``wall``, the unprofiled wall time of the
    same run; device kernels; device time by kernel and by the PyTorch
    op that launched it; and the device time of each kernel of
    ``csrc/*.cu``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    kernels = {n for src in (SRC / "repro_torch" / "kernels" / "csrc").glob("*.cu")
               for n in re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)",
                                   src.read_text())}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    n_events = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n_events += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    port = {k: t for k, t in by_name.items()
            if any(re.search(rf"\b{n}[<(]", k) for n in kernels)}
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)[:10]
    return dict(wall_s_per_call=wall / calls, device_busy_s_per_call=busy / calls,
                idle_share=1.0 - busy / wall if n_events else None,
                device_kernels_per_call=n_events / calls,
                top=[(name[:60], round(t / calls, 6)) for name, t in top],
                port_kernels=[(re.search(r"\w+(<[^>]*>)?(?=\()", k).group(0), t / calls)
                              for k, t in sorted(port.items(), key=lambda kv: -kv[1])],
                top_ops=[(e.key[:40], e.count // calls,
                          round(e.self_device_time_total / 1e6 / calls, 6)) for e in ops])


def phase_serving() -> dict:
    import torch

    from repro_torch.kernels import ops as K
    from repro_torch.launch.serve import serve_requests

    warm = dict(SERVE, n_requests=SERVE["batch_size"], max_new=2)
    serve_requests(**warm, device="cuda")  # first cuBLAS / allocator use
    gc.collect()
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    out = serve_requests(**SERVE, device="cuda")
    counts = K.launch_counts()
    out["peak_mem_bytes"] = int(torch.cuda.max_memory_allocated() - base_mem)
    out["launches"] = counts
    check(out["requests"] == SERVE["n_requests"], f"{out['requests']} requests answered")
    check(out["tokens"] == SERVE["n_requests"] * SERVE["max_new"],
          f"{out['tokens']} tokens, not {SERVE['max_new']} for each request")
    for name in ("flash_attention", "decode_attention", "mamba2_chunk_scan"):
        check(counts[name] > 0, f"serving launched no {name} kernel")
    log(f"  served {out['requests']} requests, {out['tokens']} tokens in {out['wall_s']:.3f} s: "
        f"{out['tokens_per_s']:.2f} tokens/s, mean time to first token "
        f"{out['mean_ttft_s']:.4f} s, mean decode step {1e3 * out['mean_decode_step_s']:.3f} ms, "
        f"peak {out['peak_mem_bytes'] / 2**30:.3f} GiB above the start, steps {out['steps']}")
    log(f"  launches {counts}; PATS estimates (H100 lane) {out['pats_estimates']}")
    prof = serving_profile()
    for part, res in prof.items():
        log(f"  profiled {part}: " + json.dumps(res))
    out["profile"] = prof
    return out


def _teacher_forced(model, toks, n, steps, max_len, dev):
    """Prefill logits of ``toks[:, :n]`` and of ``steps`` decode steps fed
    ``toks[:, n + i]``, on the CPU."""
    import torch

    b = toks.shape[0]
    logits, caches = model.prefill({"tokens": toks[:, :n].to(dev)}, max_len)
    out = [logits.float().cpu()]
    for i in range(steps):
        pos = torch.full((b,), n + i, dtype=torch.int32, device=dev)
        logits, caches = model.decode_step(caches, toks[:, n + i].to(dev), pos)
        out.append(logits.float().cpu())
    return out


def phase_card_vs_cpu() -> dict:
    """8 layers of zamba2-1.2B at full width, one seed, on the card and
    on the CPU. Whole model in float32: prefill + 4 decode-step logits
    within 2e-2 and the same first greedy tokens. As served (bfloat16):
    every block on the card fed the CPU block's input, within 2e-2 (a
    whole bfloat16 model differs between the two devices by more than
    that: one-ulp rounding differences spread through later layers; that
    error is printed)."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as K
    from repro_torch.models import build_model
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_config(SERVE["arch"]), n_layers=8)
    dev, cpu_dev = torch.device("cuda", 0), torch.device("cpu")
    b, n, steps, max_len = 2, 256, 4, 512
    toks = torch.as_tensor(np.random.default_rng(5).integers(0, cfg.vocab_size, (b, n + steps)))
    bf16_cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    K.reset_launch_counts()

    # float32, whole model
    f32_cpu = copy.deepcopy(bf16_cpu).float()
    f32_card = copy.deepcopy(f32_cpu).to(dev)
    t0 = time.perf_counter()
    want = _teacher_forced(f32_cpu, toks, n, steps, max_len, cpu_dev)
    t_cpu = time.perf_counter() - t0
    got = _teacher_forced(f32_card, toks, n, steps, max_len, dev)
    f32_errs = [max_err(g, w, 2e-2, 2e-2, f"float32 step {i} logits, card vs CPU")
                for i, (g, w) in enumerate(zip(got, want))]
    first = want[0].argmax(-1)
    check(torch.equal(first, got[0].argmax(-1)),
          f"first greedy tokens differ: CPU {first.tolist()}, card {got[0].argmax(-1).tolist()}")
    del f32_cpu, f32_card

    # bfloat16 as served, block by block on the CPU block's input
    bf16_card = copy.deepcopy(bf16_cpu).to(dev)
    x = T._embed_in(bf16_cpu, cfg, toks[:, :n])
    block_errs = []

    def compare(name, fn, p_cpu, p_card, x):
        y = fn(p_cpu, x, cfg)[0]
        y_card = fn(p_card, x.to(dev), cfg)[0]
        block_errs.append(max_err(y_card.cpu(), y, 2e-2, 2e-2, f"bfloat16 {name}, card vs CPU"))
        return y

    segs, off = T.zamba_segments(cfg), 0
    for si, seg in enumerate(segs):
        for i in range(off, off + seg):
            x = compare(f"mamba block {i}", T._mamba_block, bf16_cpu["blocks"][i],
                        bf16_card["blocks"][i], x)
        off += seg
        if si < len(segs) - 1:
            x = compare(f"shared block {si}", T._dense_block, bf16_cpu["shared"],
                        bf16_card["shared"], x)
    head = T._lm_head(bf16_card, cfg, x[:, -1:].to(dev)).cpu()
    block_errs.append(max_err(head, T._lm_head(bf16_cpu, cfg, x[:, -1:]), 2e-2, 2e-2,
                              "bfloat16 logits, card vs CPU"))
    whole = [(g - w).abs().max().item() for g, w in zip(
        _teacher_forced(bf16_card, toks, n, steps, max_len, dev),
        _teacher_forced(bf16_cpu, toks, n, steps, max_len, cpu_dev))]
    counts = K.launch_counts()
    for name in ("flash_attention", "decode_attention", "mamba2_chunk_scan"):
        check(counts[name] > 0, f"phase 5 launched no {name} kernel")
    log(f"  float32, prompt {n}, batch {b}: max abs err (prefill, 4 decode steps) "
        f"{[float(f'{e:.3g}') for e in f32_errs]}, first greedy tokens {first.tolist()} on both, "
        f"CPU {t_cpu:.1f} s")
    log(f"  bfloat16 per block (+ logits): max abs err {[float(f'{e:.3g}') for e in block_errs]}; "
        f"whole bfloat16 model, not checked: {[float(f'{e:.3g}') for e in whole]}; "
        f"launches {counts}")
    del bf16_cpu, bf16_card
    return dict(float32=f32_errs, bfloat16_blocks=block_errs, bfloat16_whole=whole)


def phase_main_path(tiles) -> dict:
    import numpy as np

    runs = {}
    for fused in (False, True):
        res = run_main_path(tiles, fused)
        runs[fused] = res
        log(f"  fused={fused}: {res['tiles_per_s']:.4f} tiles/s ({res['seconds']:.2f} s), "
            f"peak {res['peak_mem_bytes'] / 2**30:.2f} GiB above the start, "
            f"launches {res['launches']}, sweeps {res['sweeps']}, "
            f"lane busy {res['lane_busy']}")
    c0, c1 = runs[False]["launches"], runs[True]["launches"]
    check(c0["color_deconv"] > 0, "unfused run launched no color_deconv kernel")
    check(c1["feature_fused"] > 0, "fused run launched no feature_fused kernel")
    for fused, res in runs.items():
        # One launch per reconstruction: as many as the scheduler ran
        # ops that reconstruct (4 per tile's stages).
        n_recon = sum(res["profile"].get(op, {}).get("gpu", 0) for op in RECON_OPS)
        check(n_recon >= len(RECON_OPS) * len(tiles), f"fused={fused}: {n_recon} reconstructions")
        check(res["launches"]["morph_recon"] == n_recon,
              f"fused={fused}: {res['launches']['morph_recon']} morph_recon launches "
              f"for {n_recon} reconstructions")
        log(f"  fused={fused}: {n_recon} reconstructions, "
            f"{res['launches']['morph_recon']} morph_recon launches")
    for cid, f0 in runs[False]["feats"].items():
        f1 = runs[True]["feats"][cid]
        check(f0["n_objects"] == f1["n_objects"], f"tile {cid}: n_objects differ")
        for key in ("feat_pixel", "feat_gradient"):
            np.testing.assert_allclose(f1[key], f0[key], rtol=1e-3, atol=1e-4,
                                       err_msg=f"tile {cid} {key}")
    n_obj = [runs[False]["feats"][c]["n_objects"] for c in sorted(runs[False]["feats"])]
    log(f"  fused and unfused agree on all {len(tiles)} tiles (n_objects {n_obj})")
    ops = per_op_times(tiles[0])
    log("  per-op seconds, one tile: " + json.dumps({k: round(v, 6) for k, v in ops.items()}))
    busy = device_busy(tiles[0], sum(ops.values()))
    if busy["device_events"]:
        log("  device busy, same op sequence: " + json.dumps(busy))
    else:
        log("  device busy: not measured (the profiler saw no device events)")
    return runs


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: no card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"nvidia-smi: {smi.stdout.strip().splitlines()[0]}")

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    ptxas = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for {', '.join(_build.KERNELS)}")
    for name, text in ptxas.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    flash_build = flash_build_report(ptxas)
    log("  bf16 flash_attention kernel (ptxas, cuobjdump -sass): " + json.dumps(flash_build))
    scan_bwd_build = scan_bwd_build_report(ptxas)
    log("  mamba2_chunk_scan backward (ptxas): " + json.dumps(scan_bwd_build))

    t0 = time.perf_counter()
    tiles = mosaic_tiles(N_TILES, TILE)
    log(f"tiles: {len(tiles)} x {TILE}x{TILE} mosaics in {time.perf_counter() - t0:.1f} s")

    log("phase 1: kernels vs plain versions")
    from repro_torch.kernels import ops as K

    K.reset_launch_counts()
    kres = phase_kernels(tiles[0])
    kres.update(phase_lm_kernels())
    kres.update(phase_backward_kernels())
    kres["flash_attention"]["build"] = flash_build
    kres["mamba2_chunk_scan_bwd"]["build"] = scan_bwd_build
    phase1_counts = K.launch_counts()
    log(f"phase 2: main path, {N_TILES} tiles of {TILE}x{TILE}, one gpu lane")
    runs = phase_main_path(tiles)
    log(f"phase 6: main path across processes, {MP_TILES} tiles of {TILE}x{TILE}, "
        f"{MP_WORKERS} worker processes with one gpu lane each, SocketBus")
    procs = phase_processes(tiles[:MP_TILES], runs[True]["feats"])
    log_processes(procs, runs[True])
    log("phase 3: 256x256 tile, card vs numpy")
    phase_parity()
    del tiles
    gc.collect()
    log(f"phase 4: serving {SERVE['arch']} at full width: {SERVE}")
    served = phase_serving()
    log("phase 5: zamba2-1.2B, 8 layers at full width, card vs CPU")
    phase_card_vs_cpu()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 7: training {TRAIN['arch']} at full width: {TRAIN}")
    trained = phase_training()
    log("phase 7b: one train step, zamba2-1.2B cut to 8 layers, float32, card vs CPU")
    phase_train_card_vs_cpu()
    log("phase 7c: smoke zamba2, checkpoint, resume")
    phase_train_resume()

    records = []
    for name in REPLACES:
        res = kres[name]
        if PATHS[name] == "wsi":
            launches = sum(r["launches"][name] for r in runs.values())
        elif PATHS[name] == "serving":
            launches = served["launches"][name]
        elif PATHS[name] == "training":
            launches = trained["launches"][name]
        else:  # on no path of the reference: its phase-1 launches
            launches = phase1_counts[name]
        check(launches > 0, f"{name}: no launch")
        records.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{SOURCES.get(name, name)}.cu",
            replaces=REPLACES[name], path=PATHS[name], launches=launches,
            max_abs_err=res["max_abs_err"], ms=res["ms"], plain_ms=res["plain_ms"],
            bound_ms=res["bound_ms"], bound_by=res["bound_by"],
            library_ms=res.get("library_ms"),
            **{k: v for k, v in res.items()
               if k in ("inputs", "gqa_d128", "gqa_long", "plan", "shape", "build",
                        "ms_clean_l2", "device_ms", "kernels_per_call", "copy_device_ms",
                        "fused_op_vs_cpu", "bytes_yardstick_ms")},
        ))
        if name in ("flash_attention", "mamba2_chunk_scan"):
            records[-1]["launches_training"] = trained["launches"][name]
        if PATHS[name] == "training":
            records[-1]["tpu_counterpart"] = None  # a backward kernel: the TPU had none
    log("kernels " + "; ".join(
        f"{r['name']}: launches={r['launches']} max_abs_err={r['max_abs_err']:.3g} "
        f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f}"
        for r in records))
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
