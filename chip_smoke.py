#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Before the main path: prints the card's name and its ``nvidia-smi``
name and power limit, then builds every kernel from ``csrc/*.cu`` (one
``nvcc`` per source, all at once) into ``build/torch_kernels/``, prints
each kernel's registers and spills from ``ptxas``, and counts the
tensor-core instructions (``HMMA``/``HGMMA``, from ``cuobjdump -sass``)
of the bfloat16 flash_attention kernels for each head dim (forward,
backward dQ and dK/dV): it fails if one spills or has none; the float32
forward's and backward's (dQ, dK/dV) TF32 ``HMMA`` (three passes of each
product): it fails if one spills or its count is not a whole number of
three-pass tiles, or if a CUDA-core float32 flash kernel is still built;
and fails if an instantiation of the mamba2_chunk_scan backward spills.

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
plus a ragged S=1000 and float32 cases (D 32, 64, 128, GQA,
non-causal; out and lse at 2e-5), and timed at B=1, H=32, Hkv=8,
S=1024, D=128, bf16, causal (the dense models' GQA shape; SDPA with
``enable_gqa``), and at every shape the families and ranks launch
(float32 rows bounded by three TF32 passes, with SDPA's error against
the plain version and its backend); decode_attention checked on a
float32 GQA case (Hq=8, Hkv=2), then at B=4, Hq=Hkv=32, S=2048, D=64, bf16, lengths [2048,
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

Phase 6b (right after phase 6): phase 6 once more with locality off
(``locality_aware=False`` in the Manager, ``extra={"locality": False}``
in the workers), predictive push on: a tile's features stage may now
land on the worker that does not hold its segmentation, so regions
cross worker to worker as tensors on the data plane. Phase 6's checks,
and more than 0 regions crossed (pushes ingested), no region relayed by
the Manager. Prints the bytes that crossed and the seconds beside phase
6's. (With push off, regions pulled from the sibling, the crossing is
held by ``tests/test_torch_transport.py`` on the CPU.)

Phase 3: one 256x256 tile through ``run_tile`` on the card and through
the numpy path, at the bars of the reference's ``tests/test_app.py``.

Phase 3b (the last phase): phase 2's tile 0 (4096x4096) through
``run_tile`` on the card, against the numpy path, which runs in a process
spawned at the top of ``main`` (minutes of one host core; it overlaps
every other phase): ``n_objects`` equal, mask agreement above 0.999,
``feat_haralick`` at rtol 1e-4, atol 1e-5, every other ``feat_*`` at
rtol 1e-3, atol 1e-4. Prints the largest label id before renumbering
beside 2**24 (label ids are int32), and the numpy path's seconds per op
at 4096x4096.

Phase 8 (run right after phase 3), the hybrid node: 4 tiles of
1024x1024 (mosaics of phase 2's tile pool) with ``build_workflow()``
(unfused) through the Manager (window 2) and one WorkerRuntime, three
times: A with one ``gpu`` lane (PATS), B with a ``cpu`` lane beside
the ``gpu`` lane (PATS), C as B under FCFS; locality on. Checks every
stage done in each run, B and C each ran ops on both lanes, morph_recon
and color_deconv launched in B, every tile's ``feat_*`` in B and C
equal to A's (rtol 1e-3, atol 1e-4) with ``n_objects`` exact, and A's
tile 0 equal to the numpy path (``n_objects``, mask agreement above
0.999, ``feat_haralick`` at 1e-4/1e-5, every other ``feat_*`` at
1e-3/1e-4). Prints each run's seconds, tiles/s, lane busy seconds and
ops by lane, and per op (Fig 7 on this card) the numpy path's seconds
on tile 0, the ``gpu`` lane's observed seconds in A
(``FunctionVariant.expected_runtime``), their ratio beside the
calibrated speedup, and the ``cpu`` lane's observed seconds in B and C.

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

Phase 5b: the dry run's bytes against the card's: qwen1.5-4b at its
published widths cut to 8 layers, a serving prefill of 4 x 1024 into
caches of 2048, once on ``meta`` under ``launch/dryrun.py``'s
``LiveBytes`` (arguments plus the peak of live storage) and once on the
card (arguments plus the step's ``max_memory_allocated()``, both less
the bytes held before); fails on a ratio card / dry run outside
``DRYRUN_BAND``.

Phase 1 also holds the two backward kernels of the training path to
their plain backward versions: flash_attention at the training shape
(B=4, H=32, S=1024, D=64, bf16, causal), a ragged S=1000, float32 and
GQA (B=1, H=32, Hkv=8, D=128); mamba2_chunk_scan at C=8, H=4*64,
F=64*64, float32. A repeated call must give the same bits; the bf16
flash backward must launch ``bwd_kernels`` device kernels per call
(profiler), the scan backward one; times as above, with SDPA's backward
beside flash's at the training and GQA shapes, itself held to the bf16
bar against the plain backward on its own out; the float32 backward
(three-pass TF32, 2 kernels a call at a group of 1) is held to 2**-12 of
each row's largest on the same inputs and end to end, and timed, also
with L2 flushed clean, at phase 7b's shape and at one rank's of phase 10
(b) (``float32_bwd_shapes``) and at 4x32x1024x64 and 1x32(8)x1024x128
(``F32_BWD_TIMING``), beside SDPA's float32 backward; beside the scan
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
at most 12 chunks; the directory is removed. Phase 7d: five bf16 steps
of smoke zamba2 on the card and on the CPU from the same weights and
tokens (the run of ``tests/test_torch_train.py``'s bf16 curve): every
loss within rtol/atol 2e-2 of the CPU's, the last below the first.

Phase 9 (after 7c), every other family of the model zoo at its
published widths from seeded weights, drawn tensor by tensor on the
card, each freed before the next is built: dbrx-132b cut to 4 of 40
layers (prefill 4 x 1024, 32 greedy decode steps, cache 2048),
arctic-480b cut to 1 of 35 (2 x 512, 8 steps, 128 experts and the dense
residual), whisper-small (4 x 1500 seeded frame embeddings through the
non-causal encoder, a decoder prompt of 384, 32 steps, cache 448) and
pixtral-12b (40 layers, seeded patch and text embeddings 4 x 1024, 32
steps, cache 2048), each after a short warm-up; xlstm-125m through
``serve_requests`` (4 requests, batch 4, prompt 1024, 32 new tokens).
Checks every row got its tokens, every logit finite, flash_attention and
decode_attention launched (counts zeroed just before each prefill), and
for MoE that the prefill's capacity dropped at least one (token, slot)
pair and a ``train_forward``'s balance loss is finite and positive;
prints prefill seconds, decode tokens/s and peak memory. Then (f) each
new family's smoke config in float32, card against CPU from one seeded
state dict: prefill and 4 teacher-forced decode steps within rtol/atol
1e-3 with the same greedy tokens (but where the CPU's two best logits
lie within twice the error), and the int8 KV cache of
``attention_options(kv_quant=True)`` on smoke mistral-nemo, a 12-step
decode chain from empty caches within 2e-2. Phase 1 adds every
flash_attention and decode_attention shape that phase 9's measured runs
launch, derived from the configs (``family_shapes``): the prefills of
dbrx (H=48/Hkv=8), arctic (56/8) and pixtral (32/8) at D=128, whisper's
encoder (B=4, H=12, S=1500, D=64, non-causal) and decoder (S=384,
causal), and each family's decode over its cache (bf16, ragged
lengths); and decode_attention in float32 at Hq=32/Hkv=8, D=128 (the
int8 cache's launch).

Phase 10 (after 9), the launchers beyond one card
(``launch/{mesh,sharding,spmd,elastic}.py``), as spawned ranks that share
this one card over ``gloo`` (``nccl`` refuses two ranks on one device;
every collective of a CUDA tensor is staged through pinned host memory
and its bytes counted; which gloo collectives take CUDA tensors is
probed and printed). Two ranks: (b) qwen1.5-4b at its published widths
cut to 2 layers, one float32 step on mesh (data 1, model 2) against one
step on a single rank at phase 7b's bars; (c) ``make_compressed_dp_grads``
on (2, 1), the first step's gradients within one int8 step of a plain
version of the reference's arithmetic and within what it allows of the
exact mean, then the loss falling over 4 steps; (d) the bf16 model of (a)
served on (1, 2): prefill 4 x 1024, 16 greedy steps, 10 KV slots a rank,
and at 2 layers in float32 the greedy tokens of one rank (teacher-forced);
(a) qwen1.5-4b trained on (1, 2) at the largest depth whose state fits
the card (``dist_layers``, at least 8 of 40), float32 masters, bf16
activations, AdamW (cosine), remat, batch 4 x 1024, 12 steps: loss finite
and falling, flash forward and backward launched in each rank; step
seconds, tokens/s, peak GiB a rank, collective and staged bytes a step.
Four ranks: (e) smoke qwen1.5 on (2, 2) for 3 steps, ``reshard_state``
onto (1, 2), 3 more, against a single rank's 6 steps at 2e-3. Phase 1
also checks and times flash (forward and backward) and decode_attention
at the shapes one rank launches (``rank_shapes``). Two ranks on one card
measure correctness and the cost of the collectives on one card, not
scaling across cards.

Phase 11 (after 10), long-context decode and every family's serving on
a mesh, as two spawned ranks that share this card over ``gloo``: (a)
zamba2-1.2B at full width and depth in ``long_500k``'s layout: batch 1,
a 524,288-position cache on mesh (data 2, model 1), so each rank holds
262,144 positions of each of the 6 shared-attention KV caches (bf16,
seeded up to position 400,000, so both chunks hold keys; Mamba2 states
seeded alike on both ranks); no prefill, as in the reference's cell; 16
greedy decode steps, each rank's decode_attention with its log-sum-exp
and the partial results merged over the data axis: logits finite, every
rank launched the kernel; decode tokens/s, seconds a step, peak GiB a
rank, bytes staged a step. (b) float32 against one rank holding the
whole cache: zamba2 cut to 7 layers and qwen1.5-4b to 2, batch 1, cache
8,192 on (2, 1), prompt 5,120 (every rank prefills it and keeps its
half of the caches), 16 decode steps teacher-forced on one rank's greedy
tokens: logits within 1e-4, the same greedy tokens; and the int8 KV
cache's chain of ``tests/test_torch_long_context.py`` (smoke qwen1.5-4b,
float32, 20 teacher-forced steps from empty caches of 32 on (2, 1))
against one rank's int8 chain at rtol/atol 1e-5. (c) zamba2-1.2B,
xlstm-125m and whisper-small at full width on (1, 2): prefill 4 x 1024
(whisper: its 1500 frames and a 384-token decoder prompt), 16 greedy
steps, bf16 timings; then each at 2 layers (zamba2 at 7) in float32
against one rank at (b)'s bars. Phase 1 adds decode_attention at a
long-context rank's shape with ``return_lse`` (B=1, Hq=Hkv=32, S=262,144,
D=64, bf16, length 200,000): out and lse against the plain version; and
flash and decode at every other shape a rank of phase 11 launches,
derived from its settings and the configs (``long_shapes``): (b)'s
float32 prefill of 5,120 and its decode with ``return_lse`` over each
rank's 4,096-position chunk (zamba2 32x64, qwen1.5 20x128), and (c)'s
prefills and decodes with the heads split over the model axis (zamba2
16x64, whisper 6x64 with its encoder), bf16 at full width and float32
at the small runs' batch and prompt. The launch counts phase 11 checks
come from the configs too (``shared_applications``, ``family_kernels``).

Any failed check exits non-zero. The last lines are a JSON ``kernels``
record and ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import functools
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS = 67e12           # H100 SXM, float32 outside the tensor cores
TF32_FLOPS = 494.7e12       # H100 SXM, dense TF32 on the tensor cores
BF16_FLOPS = 989e12         # H100 SXM, dense bf16 on the tensor cores
#: Tensor-core passes of a float32 product: the float32 attention kernels'
#: bound is this many products at TF32_FLOPS (three-pass TF32: hi*hi,
#: hi*lo, lo*hi), not one at F32_FLOPS.
F32_PASSES = 3
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
#: Phase 8, the hybrid node: 4 tiles of 1024x1024 (a host core's numpy
#: pipeline takes seconds per op at this size and minutes at 4096x4096),
#: run A (one gpu lane), B (a cpu and a gpu lane, PATS) and C (the same
#: under FCFS); locality on, Manager window 2, unfused workflow.
HYBRID_TILES, HYBRID_SIZE = 4, 1024
HYBRID_RUNS = {"A": (("gpu",), "pats"), "B": (("cpu", "gpu"), "pats"),
               "C": (("cpu", "gpu"), "fcfs")}
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


@functools.lru_cache(maxsize=None)
def tile_pool(seed: int = 11) -> tuple:
    """4 distinct ``synth_tile(i, size=POOL_TILE, seed=seed)`` tiles, made
    once per run (phases 2 and 8 draw on the same pool)."""
    from repro_torch.app.tiles import synth_tile

    return tuple(synth_tile(i, size=POOL_TILE, seed=seed) for i in range(4))


def mosaic_tiles(n: int, size: int, seed: int = 11):
    """``n`` (size, size, 3) uint8 tiles, each a mosaic of the pool of 4
    distinct ``synth_tile(i, size=POOL_TILE)`` tiles with seeded flips
    and rotations (a native large synth_tile draws a full-frame mask
    per nucleus and takes minutes on a host core)."""
    import numpy as np

    pool = tile_pool(seed)
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


def hmma_counts(lib: Path, pattern: str = r"\bH(G)?MMA\b") -> dict:
    """``{function name: number of tensor-core instructions (HMMA, HGMMA;
    or those matching ``pattern``)}`` of a built library, from
    ``cuobjdump -sass`` beside ``nvcc``."""
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
        elif name is not None and re.search(pattern, line):
            out[name] += 1
    return out


def flash_build_report(ptxas: dict) -> dict:
    """Registers, spills and tensor-core instruction count of the
    bfloat16 flash_attention kernels for each head dim: the forward in
    its serving instantiation (``d32`` ...: no log-sum-exp store) and its
    training one (``d32_lse`` ...), and the backward's dQ and dK/dV
    kernels (``bwd_dq_d32`` ...; dK/dV in its group-of-1 and its partial
    instantiation, ``bwd_dkdv_d32`` and ``bwd_dkdv_d32_partial``);
    registers, spills and TF32 ``HMMA`` count of the float32 forward
    (``f32_d32`` ..., ``f32_d32_lse`` ...) and of the float32 backward's
    dQ and dK/dV kernels with one and two warp groups a block
    (``f32_bwd_dq_d32_g1`` ..., ``f32_bwd_dkdv_d32_g1``,
    ``f32_bwd_dkdv_d32_partial_g2`` ...). Fails on a spill, on a bf16 kernel
    with no tensor-core instruction, on a float32 kernel whose TF32
    ``HMMA`` count is not a whole number of three-pass tiles, or if a
    CUDA-core float32 kernel (forward or backward) is still built."""
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
    # The float32 kernels: three-pass TF32 on mma.sync. A tile is BK keys
    # (forward: 6 (D / 8)(BK / 8) TF32 HMMA, QK^T and PV) or a step of NC
    # columns (backward dQ: 9 (D / 8)(NC / 8), S, dP and dQ; dK/dV: 12,
    # S^T, dP^T, dV and dK), three products each.
    tf32 = hmma_counts(_build._target("flash_attention"), r"\bHMMA\.1688\.F32\.TF32\b")
    f32_wanted = {}
    for d, bk, nc in ((32, 64, 32), (64, 64, 32), (128, 32, 16)):
        for lse, suffix in ((0, ""), (1, "_lse")):
            f32_wanted[f"f32_d{d}{suffix}"] = (
                f"float32 flash kernel D={d}{suffix}",
                rf"flash_f32_kernelILi{d}ELi\d+ELb{lse}E", 6 * (d // 8) * (bk // 8),
                f"3 passes of QK^T and PV over a {bk}-key tile")
        for groups in (1, 2):  # warp groups a block
            f32_wanted[f"f32_bwd_dq_d{d}_g{groups}"] = (
                f"float32 flash backward dQ kernel D={d} G={groups}",
                rf"flash_bwd_dq_f32_kernelILi{d}ELi\d+ELb[01]ELi{groups}EE",
                9 * (d // 8) * (nc // 8), f"3 passes of S, dP and dQ over a {nc}-key step")
            for part, suffix in ((0, ""), (1, "_partial")):
                f32_wanted[f"f32_bwd_dkdv_d{d}{suffix}_g{groups}"] = (
                    f"float32 flash backward dK/dV kernel D={d}{suffix} G={groups}",
                    rf"flash_bwd_dkdv_f32_kernelILi{d}ELi\d+ELb[01]ELb{part}ELi{groups}EE",
                    12 * (d // 8) * (nc // 8),
                    f"3 passes of S^T, dP^T, dV and dK over a {nc}-query step")
    for name, (what, pattern, per_tile, unit) in f32_wanted.items():
        key = re.compile(pattern)
        found = [v for n, v in entries.items() if key.search(n)]
        mma = [c for n, c in tf32.items() if key.search(n)]
        check(len(found) == 1 and len(mma) == 1,
              f"{what}: {len(found)} ptxas entries, {len(mma)} SASS functions")
        check(mma[0] > 0 and mma[0] % per_tile == 0,
              f"{what}: {mma[0]} TF32 HMMA, not a multiple of {per_tile} ({unit})")
        check(found[0].get("spill_stores") == 0 and found[0].get("spill_loads") == 0,
              f"{what} spills: {found[0]}")
        report[name] = dict(found[0], hmma_tf32=mma[0], hmma_tf32_per_tile=per_tile)
    check(not any("flash_fwd_kernel" in n for n in sass),
          "the CUDA-core float32 forward (flash_fwd_kernel) is still built")
    old_bwd = [n for n in sass if re.search(r"flash_bwd_(dvec|dq|dkdv)_kernelI", n)]
    check(not old_bwd, f"the CUDA-core float32 backward is still built: {old_bwd}")
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


def attention_bound(nbytes: float, flops: float, f32: bool) -> tuple[float, str]:
    """``bound`` of an attention kernel: bf16 products at BF16_FLOPS,
    float32 ones as F32_PASSES TF32 products at TF32_FLOPS."""
    if f32:
        return bound(nbytes, F32_PASSES * flops, TF32_FLOPS)
    return bound(nbytes, flops, BF16_FLOPS)


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


def sdpa_backend(fn) -> str:
    """Which backend of ``scaled_dot_product_attention`` ran ``fn``, read
    from the names of the device kernels it launched: ``flash``,
    ``cudnn``, ``efficient`` (the CUTLASS ``fmha`` kernels) or ``math``
    (plain products and a softmax). Three calls, so that a record the
    profiler drops does not hide the backend."""
    names = " ".join(name for name, _ in device_events(lambda: [fn() for _ in range(3)]))
    names = names.lower()
    for key, backend in (("flash", "flash"), ("cudnn", "cudnn"), ("fmha", "efficient")):
        if key in names:
            return backend
    return "math"


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
#: PERF.md's kernel table), the dense models' long-context GQA decode
#: with mistral-nemo-12b's heads (row 6a), and the same heads in float32
#: (row 6d), which the int8 KV cache (``attention_options(kv_quant=True)``)
#: launches on its dequantised cache: (B, Hq, Hkv, S, D, lengths[, dtype]).
#: Phase 9's shapes come from :func:`family_shapes`.
DECODE_SHAPES = {
    "main": (4, 32, 32, 2048, 64, [2048, 1025, 700, 1]),
    "gqa_long": (4, 32, 8, 16384, 128, [16384, 9000, 4097, 1]),
    "f32_gqa32_d128": (4, 32, 8, 2048, 128, [2048, 1100, 600, 1], "float32"),
    "long_ctx_rank": (1, 32, 32, 262144, 64, [200000]),
}
#: Shapes launched, checked and timed with ``return_lse`` (the
#: long-context layout's launch, phase 11: one rank's half of
#: zamba2-1.2B's 524,288-position cache). Its lse is held to the plain
#: version's at rtol 1e-5, atol 1e-4 (float32 sums in another order, and
#: ex2.approx per key). Its inputs are drawn on the card: on an H100,
#: uploading 2 GiB from numpy left ``torch.profiler`` dropping the kernel
#: records of every other session for the rest of the process, and the
#: profiler-based checks after it read those records.
DECODE_LSE = frozenset({"long_ctx_rank"})


def decode_records(flush, shapes: dict = DECODE_SHAPES, seed: int = 44,
                   with_lse: frozenset = DECODE_LSE) -> dict:
    """decode_attention at ``shapes`` (:data:`DECODE_SHAPES` unless
    given; those in ``with_lse`` with ``return_lse``, out and lse
    checked): checked against the plain version, one launch per wrapper
    call, then timed beside the plain version and ``scaled_dot_product_attention`` with a
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
    for key, (b, hq, hkv, s, d, lengths, *dtype) in shapes.items():
        dt = getattr(torch, dtype[0]) if dtype else torch.bfloat16
        lse = key in with_lse
        if lse:  # drawn on the card: see DECODE_LSE
            gen = torch.Generator(dev).manual_seed(seed)
            q, k, v = (torch.randn(shp, generator=gen, device=dev, dtype=dt)
                       for shp in ((b, hq, d), (b, hkv, s, d), (b, hkv, s, d)))
        else:
            q = torch.as_tensor(rng.normal(0, 1, (b, hq, d)).astype(np.float32),
                                device=dev).to(dt)
            k, v = (torch.as_tensor(rng.normal(0, 1, (b, hkv, s, d)).astype(np.float32),
                                    device=dev).to(dt) for _ in range(2))
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        n0 = DA.launches
        got = DA.decode_attention_cuda(q, k, v, lens, return_lse=lse)
        per_call = DA.launches - n0
        check(per_call == 1, f"decode_attention {key}: {per_call} launches for one call")
        want = ref.decode_attention_ref(q, k, v, lens, return_lse=lse)
        lse_err = None
        if lse:
            (got, got_lse), (want, want_lse) = got, want
            lse_err = max_err(got_lse, want_lse, 1e-5, 1e-4, f"decode_attention {key} lse")
            del got_lse, want_lse
        if dt == torch.float32:  # summation order only, as the float32 GQA check
            err = max_err(got, want, 3e-5, 3e-5, f"decode_attention {key} shape")
        else:
            row_tol = 2.0**-6 * want.float().abs().amax(-1, keepdim=True)
            err = max_err(got, want, 0.0, row_tol, f"decode_attention {key} shape")
        mask = (torch.arange(s, device=dev)[None, :] < lens[:, None])[:, None, None, :]
        sdpa = lambda q=q, k=k, v=v, mask=mask: F.scaled_dot_product_attention(  # noqa: E731
            q[:, :, None, :], k, v, attn_mask=mask, enable_gqa=True)
        max_err(sdpa()[:, :, 0], want, *bf16_tol, f"sdpa length mask {key} (yardstick)")
        del want, got
        valid, item = sum(lengths), q.element_size()
        bms, by = bound(2 * b * hq * d * item + 2 * valid * hkv * d * item + 4 * b
                        + (4 * b * hq if lse else 0), 4.0 * valid * hq * d)
        call = lambda q=q, k=k, v=v, lens=lens, lse=lse: DA.decode_attention_cuda(  # noqa: E731
            q, k, v, lens, return_lse=lse)
        rec = dict(
            shape=[b, hq, hkv, s, d], dtype=str(dt).removeprefix("torch."), lengths=lengths,
            return_lse=lse, lse_max_abs_err=lse_err,
            max_abs_err=err, launches_per_call=per_call,
            ms=time_ms(call, 50, flush),
            plain_ms=time_ms(lambda: ref.decode_attention_ref(q, k, v, lens, return_lse=lse), 5,
                             flush),
            bound_ms=bms, bound_by=by, library_ms=time_ms(sdpa, 50, flush))
        rec["ms_clean_l2"] = time_ms(call, 50, clean)
        rec["library_ms_clean_l2"] = time_ms(sdpa, 50, clean)
        rec["device_ms"] = kernel_device_ms(call, 20, clean)
        rec["host_us_per_call"] = host_us_per_call(call, 200)
        p = DA.last_plan
        rec["plan"] = dict(splits=p.splits, split_keys=p.split_keys, heads_per_block=p.heads,
                           blocks=p.blocks, blocks_per_sm=p.blocks / sms)
        log(f"  decode_attention {key} B={b} Hq={hq} Hkv={hkv} S={s} D={d} {rec['dtype']} {lengths}: "
            f"{rec['ms']:.4f} ms (bound {bms:.4f}, SDPA {rec['library_ms']:.4f}, plain "
            f"{rec['plain_ms']:.4f}; L2 flushed clean {rec['ms_clean_l2']:.4f}, SDPA "
            f"{rec['library_ms_clean_l2']:.4f}, profiler {rec['device_ms']}, host "
            f"{rec['host_us_per_call']:.1f} us per call), {per_call} launch per call, "
            f"max abs err {err:.3g}" + (f", lse max abs err {lse_err:.3g}, " if lse else ", ") +
            f"plan {rec['plan']}")
        out[key] = rec
    return out


def family_shapes() -> tuple[dict, dict]:
    """The flash_attention and decode_attention shapes that phase 9's
    measured runs launch, from :data:`FAMILIES` and each published
    config: flash (B, H, Hkv, S, D, causal) for each prefill (whisper:
    its encoder, non-causal over its frames, and its decoder's prompt),
    decode (B, Hq, Hkv, S, D, lengths) over each ``max_len`` cache, the
    lengths ragged and the longest the one phase 9's last step reaches."""
    from repro_torch.configs import get_config

    flash, decode = {}, {}
    for name, spec in FAMILIES.items():
        cfg = get_config(name)
        b, n, m = spec["batch"], spec["prompt"], spec["max_len"]
        heads = (cfg.n_heads, cfg.n_kv_heads)
        d = cfg.resolved_head_dim
        if cfg.family == "audio":
            flash[f"{name} encoder"] = (b, *heads, cfg.encoder_frames, d, False)
        flash[name] = (b, *heads, n, d, True)
        decode[name] = (b, *heads, m, d, [n + spec["steps"], m, n // 2 + 1, 1][:b])
    return flash, decode


def rank_shapes() -> tuple[dict, dict]:
    """The flash_attention and decode_attention shapes one rank of phase
    10 launches: ``DIST``'s model on its model axis of 2 (its heads split
    over the ranks), the training and serving prefill (B, H, Hkv, S, D,
    causal) and the last decode step over the rank's cache."""
    from repro_torch.configs import get_config

    cfg = get_config(DIST["arch"])
    h, hkv = cfg.n_heads // 2, cfg.n_kv_heads // 2
    d, b, n = cfg.resolved_head_dim, DIST["batch"], DIST["seq"]
    m = DIST_SERVE["prompt"] + DIST_SERVE["steps"]
    key = f"{DIST['arch']} tp2 rank"
    return {key: (b, h, hkv, n, d, True)}, {key: (DIST_SERVE["batch"], h, hkv, m, d, [m] * b)}


def long_shapes() -> tuple[dict, dict, frozenset]:
    """The flash_attention and decode_attention shapes one rank of phase
    11 launches, from ``LONG_SMALL``, ``MESH_FAMILIES``, ``MESH_SERVE``,
    the two meshes and each published config. (b): each model's float32
    prefill of the whole prompt (every rank prefills it) and its decode
    with ``return_lse`` over its chunk of the cache at the last step:
    the first rank's chunk full, the second's prefix; and the int8
    chain's (``LONG_INT8``, smoke widths, float32) over each rank's chunk
    at its last step. (c): each family's
    prefill (whisper: the encoder over its frames, non-causal, and the
    decoder's prompt) and its decode over its cache at the last step,
    its heads split over the model axis as the plan pads them; bf16 at
    full width, then float32 at the small run's batch and prompt. (a)'s
    launch is ``DECODE_SHAPES["long_ctx_rank"]``. -> (flash (B, H, Hkv,
    S, D, causal, dtype), decode (B, Hq, Hkv, S, D, lengths, dtype), the
    decode keys launched with ``return_lse``)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.plan import plan_attention

    flash, decode, lse = {}, {}, set()
    b = LONG_SMALL
    ranks, chunk = LONG_MESH[0], b["max_len"] // LONG_MESH[0]
    valid = b["prompt"] + b["steps"]  # the last step attends to its own row too
    for arch in b["layers"]:
        cfg = get_config(arch)
        heads, d = (cfg.n_heads, cfg.n_kv_heads), cfg.resolved_head_dim
        flash[f"{arch} (b) prefill"] = (1, *heads, b["prompt"], d, True, "float32")
        for r in range(ranks):
            key = f"{arch} (b) rank {r}"
            decode[key] = (1, *heads, chunk, d, [min(chunk, max(0, valid - r * chunk))],
                           "float32")
            lse.add(key)
    q = LONG_INT8
    cfg = get_smoke_config(q["arch"])
    chunk = q["max_len"] // ranks
    for r in range(ranks):
        key = f"{q['arch']} smoke (b) int8 rank {r}"
        decode[key] = (1, cfg.n_heads, cfg.n_kv_heads, chunk, cfg.resolved_head_dim,
                       [min(chunk, max(0, q["steps"] - r * chunk))], "float32")
        lse.add(key)
    tp, sv = FAMILY_MESH[1], MESH_SERVE
    for arch, spec in MESH_FAMILIES.items():
        cfg = get_config(arch)
        if cfg.family == "ssm":  # xLSTM: no attention layers
            continue
        plan = plan_attention(cfg, tp)
        heads, d = (plan.q_eff // tp, plan.slots // tp), cfg.resolved_head_dim
        for tag, bsz, n, m, dt in (("", sv["batch"], spec["prompt"], spec["max_len"], "bfloat16"),
                                   (" f32", sv["small_batch"], sv["small_prompt"],
                                    sv["small_prompt"] + sv["steps"], "float32")):
            key = f"{arch} (c) rank{tag}"
            if cfg.family == "audio":
                flash[f"{key} encoder"] = (bsz, *heads, cfg.encoder_frames, d, False, dt)
            flash[key] = (bsz, *heads, n, d, True, dt)
            decode[key] = (bsz, *heads, m, d, [n + sv["steps"]] * bsz, dt)
    return flash, decode, frozenset(lse)


def flash_family_records(flush, gpu, normal, bf16_tol, shapes: dict) -> dict:
    """flash_attention at ``shapes`` (B, H, Hkv, S, D, causal[, dtype]),
    bfloat16 unless given, against the plain version at the serving
    forward's bar (float32: phase 1's 2e-5 for out, and for out and lse
    of the instantiation with the log-sum-exp), timed beside it and beside
    ``scaled_dot_product_attention`` (``enable_gqa``). The bound counts q,
    k, v and out once, and the products of the unmasked scores (a causal
    row of S keys attends to (S + 1) / 2 of them): bf16 at BF16_FLOPS,
    float32 three passes at TF32_FLOPS (``bound_ms_cuda_cores``: one at
    F32_FLOPS). A float32 row also has SDPA's max abs error against the
    plain version, the backend that ran it (from its kernels' names) and
    whether it holds the float32 bar of 2e-5."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref

    out = {}
    for key, (b, h, hkv, s, d, causal, *dtype) in shapes.items():
        dt = getattr(torch, dtype[0]) if dtype else torch.bfloat16
        f32 = dt == torch.float32
        q = gpu(normal(b, h, s, d), dt)
        k, v = (gpu(normal(b, hkv, s, d), dt) for _ in range(2))
        want, want_lse = ref.flash_attention_fwd_ref(q, k, v, causal)
        err = max_err(FA.flash_attention_cuda(q, k, v, causal), want,
                      *((2e-5, 2e-5) if f32 else bf16_tol), f"flash_attention {key}")
        extra = {}
        if f32:  # the lse instantiation, which training runs
            got, lse = FA.flash_attention_cuda(q, k, v, causal, return_lse=True)
            err = max(err, max_err(got, want, 2e-5, 2e-5, f"flash_attention {key} (lse)"))
            extra["lse_max_abs_err"] = max_err(lse, want_lse, 2e-5, 2e-5,
                                               f"flash_attention {key} lse")
            del got, lse
        del want_lse
        sdpa = lambda q=q, k=k, v=v, c=causal: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=c, enable_gqa=True)
        lib = sdpa()
        max_err(lib, want, *bf16_tol, f"sdpa {key} (yardstick)")
        if f32:
            gap = (lib - want).abs()
            within = bool((gap <= 2e-5 + 2e-5 * want.abs()).all())
            extra.update(library_max_abs_err=float(gap.max()), library_backend=sdpa_backend(sdpa),
                         library_within_f32_bar=within)
            if not within:
                extra["library_note"] = ("SDPA misses the float32 bar of 2e-5 against the plain "
                                         "version: not a like-for-like yardstick")
            del gap
        del want, lib
        pairs = b * h * s * ((s + 1) / 2 if causal else s)
        nbytes = 2 * (b * h + b * hkv) * s * d * q.element_size()
        bms, by = attention_bound(nbytes, 4.0 * pairs * d, f32)
        if f32:
            extra["bound_ms_cuda_cores"] = bound(nbytes, 4.0 * pairs * d, F32_FLOPS)[0]
        call = lambda q=q, k=k, v=v, c=causal: FA.flash_attention_cuda(q, k, v, c)  # noqa: E731
        out[key] = dict(
            shape=[b, h, hkv, s, d], causal=causal, dtype=str(dt).removeprefix("torch."),
            max_abs_err=err, ms=time_ms(call, 20, flush),
            plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v, causal), 3, flush),
            bound_ms=bms, bound_by=by, library_ms=time_ms(sdpa, 20, flush), **extra)
        log(f"  flash_attention {key} B={b} H={h} Hkv={hkv} S={s} D={d}: "
            + ", ".join(f"{n}={x:.4g}" if isinstance(x, float) else f"{n}={x}"
                        for n, x in out[key].items()))
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

    # flash_attention: ragged S and float32 checks (every head dim, GQA,
    # non-causal; float32 also with its lse), then the prefill shape.
    f32_tol = (2e-5, 2e-5)
    for (b, h, hkv, s, d, causal, dt, tol) in (
            (2, 8, 2, 1000, 64, True, torch.bfloat16, bf16_tol),
            (2, 8, 8, 1000, 64, True, torch.float32, f32_tol),
            (1, 4, 4, 257, 64, True, torch.float32, f32_tol),
            (2, 8, 2, 1000, 64, False, torch.float32, f32_tol),
            (2, 4, 4, 77, 32, True, torch.float32, f32_tol),
            (1, 8, 2, 300, 128, True, torch.float32, f32_tol),
            (1, 4, 1, 129, 128, False, torch.float32, f32_tol)):
        q, k, v = (gpu(normal(*sh), dt) for sh in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)))
        what = f"flash_attention S={s} D={d} {dt} Hkv={hkv} causal={causal}"
        want, want_lse = ref.flash_attention_fwd_ref(q, k, v, causal)
        e = max_err(FA.flash_attention_cuda(q, k, v, causal), want, *tol, what)
        if dt == torch.float32:
            got, lse = FA.flash_attention_cuda(q, k, v, causal, return_lse=True)
            e = max(e, max_err(got, want, *tol, what + " (lse)"),
                    max_err(lse, want_lse, *tol, what + " lse"))
        log(f"  {what}: max abs err {e:.3g}")
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
    fam_flash, fam_decode = family_shapes()
    rank_flash, rank_decode = rank_shapes()
    long_flash, long_decode, long_lse = long_shapes()
    results["flash_attention"].update(flash_family_records(
        flush, gpu, normal, bf16_tol, {**fam_flash, **rank_flash, **long_flash}))

    # decode_attention: GQA check, then the decode shapes (ragged lengths).
    q = gpu(normal(3, 8, 64))
    k, v = gpu(normal(3, 2, 777, 64)), gpu(normal(3, 2, 777, 64))
    lens = torch.tensor([777, 300, 1], dtype=torch.int32, device=dev)
    e = max_err(DA.decode_attention_cuda(q, k, v, lens), ref.decode_attention_ref(q, k, v, lens),
                3e-5, 3e-5, "decode_attention GQA")
    log(f"  decode_attention GQA Hq=8 Hkv=2 S=777 float32: max abs err {e:.3g}")
    recs = decode_records(flush, {**DECODE_SHAPES, **fam_decode, **rank_decode, **long_decode},
                          with_lse=DECODE_LSE | long_lse)
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


def run_main_path(tiles, fused: bool, lanes: tuple[str, ...] = ("gpu",),
                  policy: str = "pats", label: str | None = None, keep: tuple = ()) -> dict:
    """The WSI workflow on ``tiles`` through a Manager (window 2) and one
    WorkerRuntime with one lane of each kind in ``lanes`` (locality on,
    ``policy``), the ``gpu`` variants on the card. Checks every stage
    completed and every op ran on one of ``lanes``; returns each tile's
    ``feat_*``, ``n_objects`` and the ``keep`` keys (on the host), the
    kernels' launches (zeroed just before the run), the op profile per
    lane kind, lane busy seconds and the variant registry."""
    import torch

    from repro_torch.app import build_workflow, register_variants
    from repro_torch.app import segmentation as S
    from repro_torch.app._device import to_host
    from repro_torch.core import (
        ConcreteWorkflow, DataChunk, LaneSpec, Manager, ManagerConfig,
        VariantRegistry, WorkerRuntime,
    )
    from repro_torch.kernels import ops as K

    tag = label or f"fused={fused}"
    reg = VariantRegistry()
    register_variants(reg, device="cuda")
    cw = ConcreteWorkflow.replicate(
        build_workflow(fused=fused),
        [DataChunk(i, payload=t) for i, t in enumerate(tiles)],
    )
    rt = WorkerRuntime(0, lanes=tuple(LaneSpec(kind, 0) for kind in lanes), policy=policy,
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
        check(ok, f"{tag}: Manager.run did not finish: errors={rt.errors[:3]}")
        done, total = mgr.progress()
        check(done == total == 2 * len(tiles), f"{tag}: {done}/{total} stages")
        profile = rt.stats()["profile"]
        off_lane = {op: k for op, k in profile.items() if not set(k) <= set(lanes)}
        check(not off_lane, f"{tag}: ops off the {'/'.join(lanes)} lanes: {off_lane}")
        feats: dict[int, dict] = {}
        for si in cw.stage_instances.values():
            if si.stage.name != "features":
                continue
            out = mgr.stage_outputs(si.uid)
            for state in (out or {}).values():
                d = feats.setdefault(si.chunk.chunk_id, {})
                d.update({k: to_host(v) for k, v in state.items()
                          if k.startswith("feat_") or k == "n_objects" or k in keep})
        check(sorted(feats) == list(range(len(tiles))), f"{tag}: missing tiles")
        return dict(
            seconds=seconds,
            tiles_per_s=len(tiles) / seconds,
            peak_mem_bytes=int(torch.cuda.max_memory_allocated() - base_mem),
            launches=counts,
            sweeps=sweeps,
            profile=profile,
            lane_busy=rt.stats()["lane_busy"],
            feats=feats,
            registry=reg,
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


def phase_processes(tiles, want: dict, locality: bool = True,
                    label: str = "phase 6") -> dict:
    """The fused workflow on ``tiles`` through a Manager here and
    ``MP_WORKERS`` spawned worker processes on the card; ``want``:
    phase 2's fused features per tile. ``locality`` sets the Manager's
    locality-aware leases and the workers' locality; predictive push is
    on. Without locality (phase 6b) the regions that crossed worker to
    worker (pushes ingested) must be more than 0, and the Manager must
    relay none."""
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
        window=2, heartbeat_timeout=60, locality_aware=locality, predictive_push=True,
        backup_tasks=False, rpc_timeout=MP_RPC_TIMEOUT))
    endpoint = T.ManagerEndpoint(mgr, T.SocketBus())
    K.reset_launch_counts()
    t0 = time.perf_counter()
    procs = [
        T.spawn_worker(endpoint.address, T.WorkerSpec(
            worker_id=wid, registry="repro_torch.app.pipeline:wsi_registry_cuda",
            lanes=(("gpu", 0),), policy="pats", extra={"locality": locality}))
        for wid in range(MP_WORKERS)
    ]
    try:
        check(endpoint.wait_workers(MP_WORKERS, timeout=300.0),
              f"{label}: {len(endpoint.proxies)} of {MP_WORKERS} workers registered")
        startup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ok = mgr.run(timeout=900.0)
        seconds = time.perf_counter() - t0
        check(ok, f"{label}: Manager.run did not finish")
        done, total = mgr.progress()
        check(done == total == 2 * len(tiles), f"{label}: {done}/{total} stages")
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
    check(codes == [0] * MP_WORKERS, f"{label}: worker exit codes {codes}")
    check(sum(K.launch_counts().values()) == 0, f"{label}: kernels launched in the Manager")
    logs = sorted(launch_dir.glob("launches-*.json"))
    check(len(logs) == MP_WORKERS, f"{label}: {len(logs)} launch logs")
    per_worker = [json.loads(f.read_text()) for f in logs]
    launches = {k: sum(c[k] for c in per_worker) for k in per_worker[0]}
    check(launches["morph_recon"] > 0 and launches["feature_fused"] > 0,
          f"{label}: kernels not launched in the workers: {launches}")
    check(sorted(stats) == list(range(MP_WORKERS)), f"{label}: workers {sorted(stats)}")
    for wid, st in stats.items():
        check(st["executed"] > 0, f"{label}: worker {wid} ran no op")
        off_lane = {op: k for op, k in st["profile"].items() if set(k) != {"gpu"}}
        check(not off_lane, f"{label}: worker {wid} ops off the gpu lane: {off_lane}")
        tr = st["transport"]
        check(tr["crc_rejects"] == 0 and tr["push_crc_rejects"] == 0,
              f"{label}: worker {wid} CRC rejects {tr}")
    check(sorted(feats) == list(range(len(tiles))), f"{label}: tiles {sorted(feats)}")
    for cid, got in feats.items():
        check(got["n_objects"] == want[cid]["n_objects"],
              f"{label}: tile {cid} n_objects {got['n_objects']} != {want[cid]['n_objects']}")
        for key in FEAT_KEYS:
            np.testing.assert_allclose(got[key], want[cid][key], rtol=1e-3, atol=1e-4,
                                       err_msg=f"{label}: tile {cid} {key}")
    tr = [st["transport"] for st in stats.values()]
    crossed = dict(
        push_ingested=sum(st["push_ingested"] for st in stats.values()),
        pushed_bytes=sum(t["pushed_bytes"] for t in tr),
        direct_keys=sum(st.get("prefetch", {}).get("direct_keys", 0) for st in stats.values()),
        direct_bytes=sum(st.get("prefetch", {}).get("direct_bytes", 0)
                         for st in stats.values()),
        served_regions=sum(t["served_regions"] for t in tr),
        served_bytes=sum(t["served_bytes"] for t in tr),
    )
    if not locality:
        check(wire["relay_bytes"] == 0, f"{label}: the Manager relayed {wire['relay_bytes']} B")
        check(crossed["push_ingested"] > 0, f"{label}: no region pushed across: {crossed}")
    return dict(
        label=label, locality=locality, crossed=crossed,
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


def log_processes(res: dict, phase2: dict, phase6: dict | None = None) -> None:
    """``phase6``: phase 6's result, beside which phase 6b's is printed."""
    gib = 2 ** 30
    log(f"  {res['label']} (locality {res['locality']}, predictive push True): "
        f"{res['tiles']} tiles in {res['seconds']:.2f} s across {MP_WORKERS} worker "
        f"processes: {res['tiles_per_s']:.4f} tiles/s (phase 2 in process, fused, "
        f"8 tiles: {phase2['tiles_per_s']:.4f} tiles/s"
        + ("" if phase6 is None else f"; phase 6 {phase6['seconds']:.2f} s") +
        f"); workers up in {res['startup_s']:.2f} s")
    log(f"  crossed worker to worker: {json.dumps(res['crossed'])}")
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
        f"({res['manager_peak_rss_before'] / gib:.2f} GiB before {res['label']}); largest "
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


def check_close(got, want, rtol: float, atol: float, what: str) -> None:
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    check(got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}")
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    bad = int((err > atol + rtol * np.abs(want.astype(np.float64))).sum())
    check(bad == 0, f"{what}: {bad} elements beyond rtol {rtol} atol {atol}, "
                    f"max abs err {float(err.max()) if err.size else 0.0:.3g}")


# --------------------------------------------------------------------------
# phase 3b: a whole 4096x4096 tile, card vs numpy
# --------------------------------------------------------------------------

#: Phase 3b, the last phase, waits at most this long for the numpy path,
#: which runs in a process spawned at the top of ``main`` (775 s of one
#: host core at 4096x4096 beside phases 6, 6b and 11 on an H100's host),
#: so that the whole script stays within 1200 s.
WHOLE_TILE_WAIT_S = 300.0


def _numpy_whole_tile(out) -> None:
    """The spawned process of phase 3b: phase 2's tile 0 made anew from
    its seed, through the numpy path op by op; puts on ``out`` what
    phase 3b compares (or the error, so that phase 3b fails at once)."""
    import traceback
    import zlib

    try:
        tile = mosaic_tiles(1, TILE)[0]  # the first tile of any mosaic_tiles(n, TILE)
        t0 = time.perf_counter()
        state, seconds = numpy_op_seconds(tile)
        out.put(dict(crc=zlib.crc32(tile), n_objects=state["n_objects"], mask=state["mask"],
                     labels_max=int(state["labels"].max()),
                     feats={k: state[k] for k in FEAT_KEYS}, seconds=seconds,
                     total_s=time.perf_counter() - t0))
    except BaseException:
        out.put(dict(error=traceback.format_exc()))
        raise


def start_numpy_whole_tile() -> tuple:
    """Spawn :func:`_numpy_whole_tile` (a daemon: it ends with this
    process) -> (process, its queue, the start time)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    proc = ctx.Process(target=_numpy_whole_tile, args=(out,), daemon=True,
                       name="numpy-whole-tile")
    proc.start()
    return proc, out, time.perf_counter()


def phase_whole_tile(tile, job: tuple) -> dict:
    """Phase 3b: ``tile`` (phase 2's tile 0) through ``run_tile`` on the
    card, against the numpy path's result from ``job``
    (:func:`start_numpy_whole_tile`) at phase 8's bars: ``n_objects``
    equal, mask agreement above 0.999, ``feat_haralick`` at rtol 1e-4,
    atol 1e-5 and every other ``feat_*`` at rtol 1e-3, atol 1e-4. Prints
    the largest label id each path reaches before renumbering (the
    watershed's labels, a component's least linear index + 1) beside
    2**24, and the numpy path's seconds per op."""
    import queue
    import zlib

    import numpy as np
    import torch

    from repro_torch.app import run_tile

    proc, out, started = job
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = run_tile(tile, "accel", device="cuda")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    card = dict(n_objects=s["n_objects"], mask=s["mask"].cpu().numpy(),
                labels_max=int(s["labels"].max()), feats={k: s[k] for k in FEAT_KEYS})
    del s
    t0 = time.perf_counter()
    try:
        res = out.get(timeout=WHOLE_TILE_WAIT_S)
    except queue.Empty:
        raise CheckFailed(f"phase 3b: no result from the numpy path after "
                          f"{time.perf_counter() - started:.0f} s") from None
    waited = time.perf_counter() - t0
    proc.join(timeout=60.0)
    check("error" not in res, f"phase 3b: the numpy path failed:\n{res.get('error')}")
    check(proc.exitcode == 0, f"phase 3b: the numpy process exited {proc.exitcode}")
    check(res["crc"] == zlib.crc32(tile), "phase 3b: the numpy path's tile is not phase 2's tile 0")
    check(card["n_objects"] == res["n_objects"],
          f"phase 3b: n_objects card {card['n_objects']} != numpy {res['n_objects']}")
    agree = float((card["mask"] == res["mask"]).mean())
    check(agree > 0.999, f"phase 3b: mask agreement {agree}")
    for key in FEAT_KEYS:
        tol = (1e-4, 1e-5) if key == "feat_haralick" else (1e-3, 1e-4)
        check_close(card["feats"][key], res["feats"][key], *tol,
                    f"phase 3b: {key}, card against numpy")
    h, w = tile.shape[:2]
    log(f"  {h}x{w}: card {card_s:.3f} s, numpy {res['total_s']:.2f} s in its own process "
        f"(waited {waited:.2f} s for it here); n_objects {card['n_objects']}, mask agreement "
        f"{agree:.6f}, every feat_* within its bar")
    log(f"  largest label id before renumbering: card {card['labels_max']}, numpy "
        f"{res['labels_max']}; 2**24 = {2 ** 24}, h*w = {h * w}")
    log(f"  numpy path's seconds per op at {h}x{w} (one host core, beside every other phase "
        "in the main process): " + json.dumps({k: float(f"{v:.6g}") for k, v in res["seconds"].items()}))
    return dict(n_objects=card["n_objects"], mask_agreement=agree, card_s=card_s,
                numpy_s=res["total_s"], waited_s=waited, numpy_op_s=res["seconds"],
                labels_max=card["labels_max"], numpy_labels_max=res["labels_max"])


# --------------------------------------------------------------------------
# phase 8: the hybrid node, a cpu lane beside the gpu lane
# --------------------------------------------------------------------------


def numpy_op_seconds(tile) -> tuple[dict, dict]:
    """``run_tile(tile, "cpu")`` (the numpy path), timed op by op: the
    final state and each op's host seconds."""
    from repro_torch.app.pipeline import OP_IMPLS, _SEG_ORDER
    from repro_torch.core.calibration import PARALLEL_FEATURE_OPS

    state, seconds = tile, {}
    for name in _SEG_ORDER + ("color_deconv",) + tuple(PARALLEL_FEATURE_OPS):
        t0 = time.perf_counter()
        state = OP_IMPLS[name][0](state)
        seconds[name] = time.perf_counter() - t0
    return state, seconds


def phase_hybrid() -> dict:
    """Runs A, B and C of ``HYBRID_RUNS`` on the same tiles, then tile 0
    through the numpy path. Checks every stage done in each run; B and C
    each ran ops on both lanes; morph_recon and color_deconv launched in
    B; B's and C's features equal A's per tile; A's tile 0 equal to the
    numpy path at phase 3's bars. Returns each run's numbers and, per
    op, Fig 7 on this card: the variants' observed seconds on each lane
    kind (``FunctionVariant.expected_runtime``) beside the numpy path's
    seconds on tile 0 and the calibrated speedup."""
    import numpy as np

    from repro_torch.core.calibration import OP_PROFILES

    t_phase = time.perf_counter()
    tiles = mosaic_tiles(HYBRID_TILES, HYBRID_SIZE)
    runs = {}
    for name, (lanes, policy) in HYBRID_RUNS.items():
        res = run_main_path(tiles, fused=False, lanes=lanes, policy=policy,
                            label=f"phase 8 {name}", keep=("mask",))
        runs[name] = res
        log(f"  {name} ({'+'.join(lanes)}, {policy}): {res['seconds']:.4f} s, "
            f"{res['tiles_per_s']:.4f} tiles/s, lane busy "
            f"{ {k: round(v, 4) for k, v in res['lane_busy'].items()} }, "
            f"launches {res['launches']}, ops by lane {json.dumps(res['profile'], sort_keys=True)}")
    for name in ("B", "C"):
        kinds = {kind for k in runs[name]["profile"].values() for kind in k}
        check(kinds == {"cpu", "gpu"}, f"phase 8 {name}: ops ran on {sorted(kinds)} lanes only")
    for kernel in ("morph_recon", "color_deconv"):
        check(runs["B"]["launches"][kernel] > 0, f"phase 8 B launched no {kernel} kernel")
    want = runs["A"]["feats"]
    for name in ("B", "C"):
        for cid, got in runs[name]["feats"].items():
            check(got["n_objects"] == want[cid]["n_objects"],
                  f"phase 8 {name}: tile {cid} n_objects {got['n_objects']} "
                  f"!= A's {want[cid]['n_objects']}")
            for key in FEAT_KEYS:
                check_close(got[key], want[cid][key], 1e-3, 1e-4,
                            f"phase 8 {name}: tile {cid} {key} against A's")
    t0 = time.perf_counter()
    s_cpu, cpu_s = numpy_op_seconds(tiles[0])
    numpy_s = time.perf_counter() - t0
    a0 = want[0]
    check(s_cpu["n_objects"] == a0["n_objects"],
          f"phase 8: tile 0 n_objects numpy {s_cpu['n_objects']} != card {a0['n_objects']}")
    agree = float((np.asarray(s_cpu["mask"]) == a0["mask"]).mean())
    check(agree > 0.999, f"phase 8: tile 0 mask agreement {agree}")
    for key in FEAT_KEYS:
        tol = (1e-4, 1e-5) if key == "feat_haralick" else (1e-3, 1e-4)
        check_close(a0[key], s_cpu[key], *tol, f"phase 8: tile 0 {key}, card against numpy")
    log(f"  tile 0, A against numpy ({numpy_s:.2f} s): n_objects {a0['n_objects']}, "
        f"mask agreement {agree:.6f}, every feat_* within its bar")
    fig7 = {}
    for op, numpy_op_s in cpu_s.items():
        gpu_s = runs["A"]["registry"].get(op).expected_runtime("gpu")
        lane_cpu = {r: runs[r]["registry"].get(op).expected_runtime("cpu") for r in ("B", "C")}
        fig7[op] = dict(
            numpy_s=numpy_op_s, gpu_s=gpu_s,
            ratio=numpy_op_s / gpu_s if gpu_s else None,
            cpu_lane_s={r: v for r, v in lane_cpu.items() if v is not None},
            calibrated=OP_PROFILES[op].gpu_speedup,
        )
    log(f"  Fig 7 at {HYBRID_SIZE}x{HYBRID_SIZE}: the numpy path's seconds on tile 0 over A's "
        "observed gpu-lane seconds (EMA), the calibrated speedup, and the cpu lane's observed "
        "seconds in B and C where it ran the op:")
    for op, r in fig7.items():
        log(f"    {op}: numpy {r['numpy_s']:.6g} s, gpu {r['gpu_s']:.6g} s, ratio "
            f"{r['ratio']:.6g}x (calibrated {r['calibrated']}x), cpu lane "
            + json.dumps({k: float(f"{v:.6g}") for k, v in r["cpu_lane_s"].items()}))
    seconds = time.perf_counter() - t_phase
    log(f"  phase 8: {seconds:.1f} s")
    for res in runs.values():
        del res["registry"], res["feats"]
    return dict(runs=runs, fig7=fig7, numpy_s=numpy_s, mask_agreement=agree, seconds=seconds)


#: Two float32 flash backward shapes that fill the card, timed in phase 1
#: beside the path's (``float32_bwd_shapes``): (B, H, Hkv, S, D), causal.
F32_BWD_TIMING = {"4x32x1024x64": (4, 32, 32, 1024, 64),
                  "1x32(8)x1024x128": (1, 32, 8, 1024, 128)}


def float32_bwd_shapes() -> dict:
    """The float32 flash backward's launches on the paths: phase 7b's
    (``TRAIN``'s model, batch 1 x 256) and one rank's of phase 10 (b)
    (``DIST``'s model on a model axis of 2, ``DIST_SMALL``'s batch):
    (B, H, Hkv, S, D)."""
    from repro_torch.configs import get_config

    z, q = get_config(TRAIN["arch"]), get_config(DIST["arch"])
    return {
        "phase 7b": (1, z.n_heads, z.n_kv_heads, 256, z.resolved_head_dim),
        "phase 10 (b) rank": (DIST_SMALL["batch"], q.n_heads // 2, q.n_kv_heads // 2,
                              DIST_SMALL["seq"], q.resolved_head_dim),
    }


def phase_backward_kernels() -> dict:
    """The two backward kernels of the training path against their plain
    backward versions on the card: flash_attention at the training shape
    (B=4, H=32, S=1024, D=64, bf16, causal), a ragged S=1000, float32,
    and GQA (H=32, Hkv=8, D=128); mamba2_chunk_scan at C=8, H=4*64,
    F=64*64, float32. Each must give the same bits on a repeated call;
    timed with CUDA events (median, L2 flushed) beside the bound, the
    plain version and, for attention, SDPA's backward on the same
    inputs. The float32 flash rows: the path's shapes
    (``float32_bwd_shapes``) and two that fill the card
    (``F32_BWD_TIMING``), each also timed with L2 flushed clean. The scan
    backward's row also has its plan (splits, vec, k, threads), its
    device kernels per call (profiler; must be 1), its time with L2
    flushed clean, and ``bytes_yardstick_ms``: a PyTorch add that reads
    two tensors of the states' size and writes one (no PyTorch call
    computes the function, so ``library_ms`` is None)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import mamba2_scan as MS
    from repro_torch.kernels import ref

    dev = torch.device("cuda", 0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev).zero_
    clean = torch.ones(256 << 20, dtype=torch.uint8, device=dev).max
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
    # float32 differs by summation order and the three TF32 passes (each
    # product within about 2**-22 of float32's; modelled in
    # tests/test_torch_flash_bwd_f32_numerics.py). float32 is
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

    def kernel_record(b, h, hkv, s, d, err, args, sdpa_bwd, dt=torch.bfloat16):
        fn = lambda: FA.flash_attention_bwd_cuda(*args)  # noqa: E731
        per_call = device_kernels_per_call(fn)
        want = FA.bwd_kernels(dt, h // hkv)
        check(per_call == want, f"flash_attention backward H={h} Hkv={hkv} {dt}: {per_call:g} "
              f"device kernels per call, not {want}")
        elems, kv_elems, tri = b * h * s * d, b * hkv * s * d, b * h * s * (s + 1) / 2
        # q, o, dout, dq (B, H, S, D), k, v, dk, dv (B, Hkv, S, D) and lse, once
        nbytes = args[0].element_size() * (4 * elems + 4 * kv_elems) + 4 * b * h * s
        bms, by = attention_bound(nbytes, 5 * 2.0 * tri * d, dt == torch.float32)
        rec = dict(shape=[b, h, hkv, s, d], max_abs_err=err, kernels_per_call=per_call,
                   ms=time_ms(fn, 10, flush),
                   plain_ms=time_ms(lambda: ref.flash_attention_bwd_ref(*args), 3, flush),
                   bound_ms=bms, bound_by=by, library_ms=time_ms(sdpa_bwd, 10, flush))
        if dt == torch.float32:
            rec["ms_clean_l2"] = time_ms(fn, 10, clean)
        return rec

    flash_case(2, 8, 2, 1000, 64, torch.bfloat16, "ragged")
    flash_case(2, 8, 8, 1000, 64, torch.float32, "float32")
    f32 = {}
    for key, (b, h, hkv, s, d) in {**float32_bwd_shapes(), **F32_BWD_TIMING}.items():
        err, args = flash_case(b, h, hkv, s, d, torch.float32, key)
        f32[key] = kernel_record(b, h, hkv, s, d, err, args, sdpa_case(args, key),
                                 torch.float32)
        del args
        gc.collect()
        torch.cuda.empty_cache()
    b, h, hkv, s, d = 1, 32, 8, 1024, 128
    err, args = flash_case(b, h, hkv, s, d, torch.bfloat16, "GQA")
    gqa = kernel_record(b, h, hkv, s, d, err, args, sdpa_case(args, "GQA"))
    del args
    ((key, (b, h, hkv, s, d, _)),) = rank_shapes()[0].items()
    err, args = flash_case(b, h, hkv, s, d, torch.bfloat16, key)
    rank = kernel_record(b, h, hkv, s, d, err, args, sdpa_case(args, key))
    del args
    b, h, s, d = 4, 32, 1024, 64
    err, args = flash_case(b, h, h, s, d, torch.bfloat16, "training shape")
    results["flash_attention_bwd"] = dict(
        kernel_record(b, h, h, s, d, err, args, sdpa_case(args, "training shape")),
        gqa_d128=gqa, **{key: rank}, float32=f32)
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


def step_agreement(c: dict, g: dict, opt, what: str, c_name: str, g_name: str) -> dict:
    """One AdamW step from the same weights and tokens, ``g`` against
    ``c`` (each a dict of ``loss`` and per-parameter ``grads``, ``old``
    and ``new`` weights and ``g_used``, the first moment over 1 - b1):
    loss within 1e-4 relative; each gradient within 2e-3 of its tensor's
    norm; each updated parameter within 1e-6 plus what the two
    gradients' difference can move AdamW's first step, with the
    sign-flip allowance (``phase_train_card_vs_cpu``) on at most
    ``FLIP_SHARE`` of the elements, each at a gradient under
    ``FLIP_GRAD`` of its tensor's norm. Logs and checks; returns the
    numbers."""
    import torch

    lc, lg = c["loss"], g["loss"]
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
    out = dict(loss_ref=lc, loss=lg, grad_err_of_norm=grad_rel[worst_g],
               worst_grad=worst_g, update_err_of_bound=upd_over[worst_p], worst_update=worst_p,
               update_err_of_update_norm=upd_rel, sign_flips=n_flips,
               sign_flip_grad_of_norm=flip_g[worst_f])
    log(f"  loss {g_name} {lg:.6f}, {c_name} {lc:.6f}; worst gradient error "
        f"{grad_rel[worst_g]:.3g} of its norm ({worst_g}); worst updated parameter "
        f"{upd_over[worst_p]:.3g} of its bound ({worst_p}), {upd_rel:.3g} of its update's norm "
        f"at most ({len(grad_rel)} tensors); sign-flip allowance taken by {n_flips} of "
        f"{n_elems} elements ({dict((k, n) for k, n in flips.items() if n)}), their largest "
        f"gradient {flip_g[worst_f]:.3g} of its tensor's norm ({worst_f})")
    check(abs(lg - lc) <= 1e-4 * abs(lc), f"{what} loss: {g_name} {lg}, {c_name} {lc}")
    check(grad_rel[worst_g] <= 2e-3, f"{what} gradient {worst_g}: max abs err "
          f"{grad_rel[worst_g]:.3g} of its norm")
    check(upd_over[worst_p] <= 1.0, f"{what} updated {worst_p}: beyond its bound "
          f"({upd_over[worst_p]:.3g} of it)")
    check(n_flips <= FLIP_SHARE * n_elems, f"{what}: {n_flips} of {n_elems} elements took "
          f"the sign-flip allowance (limit {FLIP_SHARE:g} of them)")
    check(flip_g[worst_f] <= FLIP_GRAD, f"{what} {worst_f}: a sign flip at a gradient "
          f"{flip_g[worst_f]:.3g} of its norm (limit {FLIP_GRAD:g})")
    return out


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
    c, g = res["cpu"], res["card"]
    out = dict(step_agreement(c, g, opt, "phase 7b", "CPU", "card"), cpu_s=c["seconds"],
               card_s=g["seconds"], launches=counts)
    log(f"  CPU {c['seconds']:.1f} s; launches {counts}")
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


#: Phase 7d: the bar and the run of ``tests/test_torch_train.py::
#: test_train_loss_curve_bfloat16_matches_reference``: smoke zamba2,
#: bfloat16 activations over float32 masters, AdamW at 1e-3, the same
#: batch of 2 x 33 tokens five times.
BF16_CURVE = dict(batch=2, seq=33, steps=5, lr=1e-3, seed=8, tol=2e-2)


def phase_train_bf16_curve() -> dict:
    """Phase 7d: five ``make_train_step`` steps of smoke zamba2 in
    bfloat16 from the same weights and tokens on the CPU (plain
    versions) and on the card (kernels): every loss within rtol/atol
    ``BF16_CURVE["tol"]`` of the CPU's, the card's last below its first,
    and the flash and scan kernels launched forward and backward."""
    import copy

    import numpy as np
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops as K
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.train import TrainState, make_train_step

    c = BF16_CURVE
    cfg = get_smoke_config(TRAIN["arch"])
    toks = torch.as_tensor(np.random.default_rng(c["seed"]).integers(
        0, cfg.vocab_size, (c["batch"], c["seq"])))
    cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(c["seed"]),
                      trainable=True, act_dtype=torch.bfloat16)
    card = copy.deepcopy(cpu).to(torch.device("cuda", 0))
    losses = {}
    K.reset_launch_counts()
    for name, model in (("cpu", cpu), ("card", card)):
        opt = AdamW(lr=c["lr"])
        params = dict(model.named_parameters())
        state = TrainState(params, opt.init(params))
        step = make_train_step(model, opt)
        batch = {"tokens": toks.to(next(iter(params.values())).device)}
        losses[name] = []
        for _ in range(c["steps"]):
            state, metrics = step(state, batch)
            losses[name].append(float(metrics["loss"]))
    counts = K.launch_counts()
    for name in ("flash_attention", "flash_attention_bwd", "mamba2_chunk_scan",
                 "mamba2_chunk_scan_bwd"):
        check(counts[name] > 0, f"phase 7d launched no {name} kernel")
    check_close(losses["card"], losses["cpu"], c["tol"], c["tol"],
                "phase 7d: bf16 loss curve, card against CPU")
    check(losses["card"][-1] < losses["card"][0], f"phase 7d: loss did not fall: {losses['card']}")
    err = float(np.abs(np.subtract(losses["card"], losses["cpu"])).max())
    log(f"  losses card {[round(x, 6) for x in losses['card']]}, CPU "
        f"{[round(x, 6) for x in losses['cpu']]}: max abs difference {err:.3g} (bar "
        f"{c['tol']} + {c['tol']} x |CPU|); launches {counts}")
    del cpu, card
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, max_abs_diff=err, launches=counts)


# --------------------------------------------------------------------------


# --------------------------------------------------------------------------
# phase 9: the other families at the published widths; card against CPU
# --------------------------------------------------------------------------

#: Phase 9 (a), (b), (d), (e): each model's published widths, only the
#: depth cut (``layers``) where the card cannot hold it: dbrx-132b's 40
#: layers are ~6.5 GB of bfloat16 experts each, arctic-480b's 35 ~27 GB.
#: Prefill of ``batch`` x ``prompt`` (whisper: its decoder prompt, beside
#: 1500 encoder frames; pixtral: patch and text embeddings), then
#: ``steps`` greedy decode steps with a ``max_len`` cache (whisper's
#: decoder stops at 448 positions).
FAMILIES = {
    "dbrx-132b": dict(layers=4, batch=4, prompt=1024, steps=32, max_len=2048),
    "arctic-480b": dict(layers=1, batch=2, prompt=512, steps=8, max_len=1024),
    "whisper-small": dict(layers=None, batch=4, prompt=384, steps=32, max_len=448),
    "pixtral-12b": dict(layers=None, batch=4, prompt=1024, steps=32, max_len=2048),
}
#: Phase 9 (c): xlstm-125m at full size through ``serve_requests``.
XLSTM_SERVE = dict(arch="xlstm-125m", smoke=False, n_requests=4, batch_size=4,
                   prompt_len=1024, max_new=32, max_len=1056)
#: Phase 9 (f): smoke configs, card against CPU in float32, at
#: ``FAMILY_F32_TOL`` (rtol and atol), not phase 5's 2e-2: on an H100
#: these models read 2.2e-6 to 2.1e-5, and a wiring fault that moves
#: the logits by less than 2e-2 must still fail.
FAMILY_SMOKE = ("dbrx-132b", "arctic-480b", "xlstm-125m", "whisper-small", "pixtral-12b")
FAMILY_F32_TOL = 1e-3


def _family_inputs(cfg, batch: int, n: int, gen, dev) -> dict:
    """Seeded inputs of a prompt: token ids (and the encoder's frames for
    whisper), or patch and text embeddings (pixtral), bfloat16."""
    import torch

    if cfg.frontend == "vision_stub":
        return {"embeds": torch.randn((batch, n, cfg.d_model), generator=gen, device=dev)
                .bfloat16()}
    inputs = {"tokens": torch.randint(0, cfg.vocab_size, (batch, n), generator=gen, device=dev)}
    if cfg.family == "audio":
        inputs["embeds"] = torch.randn((batch, cfg.encoder_frames, cfg.d_model), generator=gen,
                                       device=dev).bfloat16()
    return inputs


def moe_drops(model, inputs) -> tuple[int, int, list[float]]:
    """The prompt's (token, slot) pairs past capacity, over every MoE
    layer, and the pairs routed: each layer's MoE input recomputed as the
    prefill computes it (``T._dense_block``), routed by ``moe.route``;
    also each layer's balance loss."""
    import torch

    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    from repro_torch.models.attention import attention_train
    from repro_torch.models.layers import apply_norm

    cfg = model.cfg
    dropped, routed, aux = 0, 0, []
    with torch.no_grad():
        x = T._inputs_in(model, cfg, inputs)
        for blk in model["blocks"]:
            h = x + attention_train(blk["attn"], apply_norm(cfg.norm, blk["ln1"], x, cfg.norm_eps),
                                    cfg)
            h = apply_norm(cfg.norm, blk["ln2"], h, cfg.norm_eps)
            *_, keep, _, a = MOE.route(blk["moe"], h.reshape(-1, cfg.d_model), cfg)
            dropped += int((~keep).sum())
            routed += keep.numel()
            aux.append(float(a))
            x = T._dense_block(blk, x, cfg)[0]
    return dropped, routed, aux


def serve_family(name: str, spec: dict) -> dict:
    """One model of :data:`FAMILIES` on the card: weights from a seed,
    drawn tensor by tensor; a short warm-up; prefill, then greedy decode
    steps. Checks every row got its tokens, every logit finite, and
    flash_attention and decode_attention launched (counts zeroed just
    before the prefill); for MoE, that the prefill's capacity dropped at
    least one pair and a ``train_forward``'s balance loss is finite and
    positive. Returns the times, the launches and the peak memory."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as K
    from repro_torch.models import build_model

    dev = torch.device("cuda", 0)
    cfg = get_config(name)
    if spec["layers"]:
        log(f"  {name}: depth cut from {cfg.n_layers} to {spec['layers']} layers; "
            f"widths as published")
        cfg = dataclasses.replace(cfg, n_layers=spec["layers"])
    b, n, steps, max_len = spec["batch"], spec["prompt"], spec["steps"], spec["max_len"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=9)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    gen = torch.Generator(dev).manual_seed(9)
    inputs = _family_inputs(cfg, b, n, gen, dev)

    def run(inputs, n, steps):
        logits, caches = model.prefill(inputs, max_len)
        lengths = torch.full((b,), n, dtype=torch.int32, device=dev)
        finite = torch.isfinite(logits).all()
        tokens = [torch.argmax(logits, -1)]
        torch.cuda.synchronize()
        t_pre = time.perf_counter()
        for _ in range(steps):
            logits, caches = model.decode_step(caches, tokens[-1], lengths)
            finite &= torch.isfinite(logits).all()
            tokens.append(torch.argmax(logits, -1))
            lengths += 1
        torch.cuda.synchronize()
        return t_pre, time.perf_counter() - t_pre, torch.stack(tokens, 1), bool(finite)

    with torch.no_grad():
        run({k: v[:, :128] if k == "tokens" or cfg.frontend == "vision_stub" else v
             for k, v in inputs.items()}, 128, 2)  # first cuBLAS use, allocator
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t_pre, decode_s, tokens, finite = run(inputs, n, steps)
    prefill_s = t_pre - t0
    counts = K.launch_counts()
    check(finite, f"{name}: a non-finite logit")
    check(tokens.shape == (b, steps + 1), f"{name}: tokens {tuple(tokens.shape)}")
    for kernel in ("flash_attention", "decode_attention"):
        check(counts[kernel] > 0, f"{name}: no {kernel} launch")
    out = dict(n_layers=cfg.n_layers, weights_gib=weights / 2**30, build_s=build_s,
               prefill_s=prefill_s, decode_s=decode_s, decode_tokens_per_s=b * steps / decode_s,
               launches=counts)
    if cfg.n_experts:
        dropped, routed, aux = moe_drops(model, inputs)
        check(dropped > 0, f"{name}: no pair dropped at capacity factor {cfg.capacity_factor}")
        with torch.no_grad():
            _, aux_train = model.train_forward(inputs)
        aux_train = float(aux_train)
        check(math.isfinite(aux_train) and aux_train > 0, f"{name}: train_forward aux {aux_train}")
        out.update(dropped_pairs=dropped, routed_pairs=routed, aux_per_layer=aux,
                   aux_train_forward=aux_train)
    out["peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
    del model, inputs
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  {name}: {cfg.n_layers} layers, {out['weights_gib']:.2f} GiB of weights built in "
        f"{build_s:.2f} s; prefill {b}x{n} {prefill_s:.4f} s; {steps} decode steps "
        f"{decode_s:.4f} s = {out['decode_tokens_per_s']:.1f} tokens/s; peak "
        f"{out['peak_gib']:.2f} GiB; launches {counts}"
        + (f"; dropped {out['dropped_pairs']} of {out['routed_pairs']} pairs, aux per layer "
           f"{[round(a, 4) for a in out['aux_per_layer']]}, train_forward aux "
           f"{out['aux_train_forward']:.4f}" if cfg.n_experts else ""))
    return out


def serve_xlstm() -> dict:
    """xlstm-125m at full size through ``serve_requests``."""
    import torch

    from repro_torch.launch.serve import serve_requests

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    serve_requests(**dict(XLSTM_SERVE, n_requests=XLSTM_SERVE["batch_size"], max_new=2,
                          prompt_len=128, max_len=256), device="cuda")  # warm-up
    out = serve_requests(**XLSTM_SERVE, device="cuda")
    out["peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
    check(out["requests"] == XLSTM_SERVE["n_requests"], f"xlstm: {out['requests']} requests")
    check(out["tokens"] == XLSTM_SERVE["n_requests"] * XLSTM_SERVE["max_new"],
          f"xlstm: {out['tokens']} tokens")
    log(f"  xlstm-125m: served {out['requests']} requests, {out['tokens']} tokens in "
        f"{out['wall_s']:.3f} s: {out['tokens_per_s']:.2f} tokens/s, mean time to first token "
        f"(the prefill of 4x1024) {out['mean_ttft_s']:.4f} s, mean decode step "
        f"{1e3 * out['mean_decode_step_s']:.3f} ms "
        f"({XLSTM_SERVE['batch_size'] / out['mean_decode_step_s']:.1f} decode tokens/s), peak "
        f"{out['peak_gib']:.2f} GiB")
    return out


def _greedy_agrees(got, want, err: float, what: str) -> None:
    """The same greedy token in every row, except where the CPU's two best
    logits lie within twice the measured error of each other."""
    best = want.topk(2, dim=-1).values
    differ = got.argmax(-1) != want.argmax(-1)
    tie = (best[..., 0] - best[..., 1]) <= 2 * err
    check(not bool((differ & ~tie).any()),
          f"{what}: greedy tokens differ: CPU {want.argmax(-1).tolist()}, "
          f"card {got.argmax(-1).tolist()}")


def families_card_vs_cpu() -> dict:
    """Phase 9 (f): each family's smoke config (:data:`FAMILY_SMOKE`) in
    float32, one seeded state dict on the CPU and a copy on the card:
    prefill logits and 4 teacher-forced decode steps within rtol/atol
    :data:`FAMILY_F32_TOL` and the same greedy tokens; then smoke
    mistral-nemo's int8 KV cache (``attention_options(kv_quant=True)``):
    a decode chain of 12 steps from empty caches, card against CPU within
    2e-2 (phase 5's bar: float32 noise rounds a code across .5 and the
    chains part from there), which launches decode_attention in float32.
    Also returns, per layer, the int8 codes of the last caches that the
    card and the CPU wrote differently."""
    import copy

    import numpy as np
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops as K
    from repro_torch.models import attention as A
    from repro_torch.models import build_model

    dev, cpu = torch.device("cuda", 0), torch.device("cpu")
    b, n, steps, max_len = 2, 64, 4, 128
    out = {}
    for name in FAMILY_SMOKE:
        cfg = get_smoke_config(name)
        rng = np.random.default_rng(21)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, n + steps)))
        frames = cfg.encoder_frames if cfg.family == "audio" else n
        embeds = (torch.as_tensor(rng.normal(size=(b, frames, cfg.d_model)).astype(np.float32))
                  if cfg.frontend != "none" else None)
        f32_cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(21)).float()
        f32_card = copy.deepcopy(f32_cpu).to(dev)
        K.reset_launch_counts()
        want = _teacher_forced(f32_cpu, toks, n, steps, max_len, cpu, embeds)
        got = _teacher_forced(f32_card, toks, n, steps, max_len, dev, embeds)
        counts = K.launch_counts()
        errs = [max_err(g, w, FAMILY_F32_TOL, FAMILY_F32_TOL,
                        f"{name} float32 step {i} logits, card vs CPU")
                for i, (g, w) in enumerate(zip(got, want))]
        for i, (g, w) in enumerate(zip(got, want)):
            _greedy_agrees(g, w, errs[i], f"{name} step {i}")
        if cfg.family != "ssm":
            for kernel in ("flash_attention", "decode_attention"):
                check(counts[kernel] > 0, f"{name} card vs CPU: no {kernel} launch")
        out[name] = errs
        log(f"  {name} smoke, float32, prompt {n}, batch {b}: max abs err (prefill, "
            f"{steps} decode steps) {[float(f'{e:.3g}') for e in errs]}, greedy tokens agree")
        del f32_cpu, f32_card

    cfg = get_smoke_config("mistral-nemo-12b")
    toks = torch.as_tensor(np.random.default_rng(22).integers(0, cfg.vocab_size, (b, 12)))
    f32_cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(22)).float()
    f32_card = copy.deepcopy(f32_cpu).to(dev)
    chains, kv = [], []
    K.reset_launch_counts()
    with A.attention_options(kv_quant=True):
        for model, d in ((f32_cpu, cpu), (f32_card, dev)):
            caches = model.init_caches(b, 16)
            check(set(caches["kv"][0]) == {"k_q", "k_s", "v_q", "v_s"}, "kv_quant: no int8 cache")
            logits = []
            for i in range(toks.shape[1]):
                lg, caches = model.decode_step(caches, toks[:, i].to(d),
                                               torch.full((b,), i, dtype=torch.int32, device=d))
                logits.append(lg.float().cpu())
            chains.append(logits)
            kv.append(caches["kv"])
    counts = K.launch_counts()
    codes = [{key: int((w[key] != g[key].cpu()).sum()) for key in ("k_q", "v_q")}
             for w, g in zip(*kv)]
    check(counts["decode_attention"] > 0, "kv_quant chain: no decode_attention launch")
    errs = [max_err(g, w, 2e-2, 2e-2, f"kv_quant step {i} logits, card vs CPU")
            for i, (w, g) in enumerate(zip(*chains))]
    for i, (w, g) in enumerate(zip(*chains)):
        _greedy_agrees(g, w, errs[i], f"kv_quant step {i}")
    out["kv_quant"] = errs
    out["kv_quant_codes_differ"] = codes
    log(f"  mistral-nemo-12b smoke, int8 KV cache, float32, 12 decode steps from empty "
        f"caches: max abs err {[float(f'{e:.3g}') for e in errs]}, greedy tokens agree, "
        f"int8 codes that differ per layer {codes}, launches {counts}")
    return out


def phase_families() -> dict:
    """Phase 9: (a)-(e) on the card, then (f) card against CPU."""
    t0 = time.perf_counter()
    out = {name: serve_family(name, spec) for name, spec in FAMILIES.items()}
    out["xlstm-125m"] = serve_xlstm()
    out["card_vs_cpu"] = families_card_vs_cpu()
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 9: {out['seconds']:.1f} s")
    return out


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


def _teacher_forced(model, toks, n, steps, max_len, dev, embeds=None):
    """Prefill logits of ``toks[:, :n]`` and of ``steps`` decode steps fed
    ``toks[:, n + i]``, on ``dev``. With ``embeds``, the prompt is the
    frontend stub's embeddings as the family reads them (whisper: the
    encoder's frames beside the tokens; pixtral: ``embeds[:, :n]``)."""
    import torch

    b = toks.shape[0]
    inputs = {"tokens": toks[:, :n].to(dev)}
    if embeds is not None and model.cfg.family == "audio":
        inputs["embeds"] = embeds.to(dev)
    elif embeds is not None:
        inputs = {"embeds": embeds[:, :n].to(dev)}
    logits, caches = model.prefill(inputs, max_len)
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


#: Phase 5b: one step that fits the card, counted by the dry run's
#: ``LiveBytes`` on ``meta`` and measured by the card's allocator:
#: qwen1.5-4b at its published widths cut to 8 layers, serving (bf16
#: weights), prefill of 4 x 1024 into caches of 2048.
DRYRUN_STEP = dict(arch="qwen1.5-4b", layers=8, batch=4, prompt=1024, max_len=2048, seed=21)
#: The band the card's bytes over the dry run's must lie in (``PERF.md``
#: section 2 says why): the card adds a few percent (the allocator rounds
#: each block up to 512 B and holds cuBLAS's workspace; the kernel
#: wrappers' copies and scratch are not made by their ``meta`` entries),
#: while the smallest tensor class a miscount could drop or double, the
#: KV caches, is 17% of the dry run's 3.88 GB.
DRYRUN_BAND = (0.9, 1.1)


def phase_dryrun_bytes() -> dict:
    """Phase 5b: ``DRYRUN_STEP``'s prefill on ``meta`` under
    ``launch/dryrun.py``'s ``LiveBytes`` (the arguments' bytes plus the
    peak of live storage during the step, as the dry run records
    ``peak_live_bytes``), then on the card from seeded weights: the
    arguments' bytes after a warm-up step (weights, tokens, cuBLAS's
    workspace) plus the step's ``max_memory_allocated()``, both less the
    bytes held before the model was built. Fails on a ratio card / meta
    outside ``DRYRUN_BAND``."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import LiveBytes, _tree_bytes
    from repro_torch.models import Model, build_model, make_plan
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import stored
    from repro_torch.train import make_prefill_step

    d = DRYRUN_STEP
    cfg = dataclasses.replace(get_config(d["arch"]), n_layers=d["layers"])
    toks = np.random.default_rng(d["seed"]).integers(0, cfg.vocab_size, (d["batch"], d["prompt"]))
    with torch.device("meta"):
        plan = make_plan(cfg)
        model = Model(cfg, plan, T.init_model_params(
            None, cfg, plan, "meta", store=lambda name, t: stored(name, t, False)), False, None)
        inputs = {"tokens": torch.empty(toks.shape, dtype=torch.int32)}
        meta_args = _tree_bytes((inputs, dict(model.named_parameters())))
        live = LiveBytes()
        with live:
            out = make_prefill_step(model, d["max_len"])(inputs)
        del out, model, inputs
    meta = dict(args=meta_args, temp=live.peak, total=meta_args + live.peak)

    dev = torch.device("cuda", 0)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    model = build_model(cfg, device=dev, seed=d["seed"])
    inputs = {"tokens": torch.as_tensor(toks, dtype=torch.int32, device=dev)}
    step = make_prefill_step(model, d["max_len"])
    out = step(inputs)  # warm-up: cuBLAS's workspace, the kernels' first launch
    del out
    torch.cuda.synchronize()
    card_args = torch.cuda.memory_allocated() - before
    torch.cuda.reset_peak_memory_stats()
    out = step(inputs)
    torch.cuda.synchronize()
    card_total = torch.cuda.max_memory_allocated() - before
    del out, model, inputs, step
    gc.collect()
    torch.cuda.empty_cache()
    card = dict(args=card_args, temp=card_total - card_args, total=card_total)
    ratio = card_total / meta["total"]
    log(f"  {d}: dry run on meta {json.dumps(meta)} B; card {json.dumps(card)} B; card / dry "
        f"run {ratio:.6f} (band {DRYRUN_BAND[0]}-{DRYRUN_BAND[1]}), arguments "
        f"{card_args / meta_args:.6f}, temporaries {card['temp'] / max(meta['temp'], 1):.6f}")
    check(DRYRUN_BAND[0] <= ratio <= DRYRUN_BAND[1],
          f"phase 5b: the card's bytes are {ratio:.4f} of the dry run's")
    return dict(meta=meta, card=card, ratio=ratio)


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


# --------------------------------------------------------------------------
# phase 10: the launchers beyond one card, as ranks that share the card
# --------------------------------------------------------------------------

#: (a): qwen1.5-4b at its published widths, tensor-parallel on mesh
#: (data 1, model 2): float32 masters, bf16 activations, AdamW (cosine),
#: remat; depth cut to what fits (``dist_layers``).
DIST = dict(arch="qwen1.5-4b", batch=4, seq=1024, steps=12, min_layers=8, lr=3e-4, seed=0)
#: (b)-(d) at the same widths cut to 2 layers: (b) one float32 step,
#: (c) int8 error-feedback data parallelism on (2, 1), (d) greedy decode.
DIST_SMALL = dict(layers=2, batch=2, seq=256, seed=10)
DIST_EF = dict(batch=4, seq=256, steps=4, lr=1e-3)
DIST_SERVE = dict(batch=4, prompt=1024, steps=16, small_prompt=128)
#: (e): smoke qwen1.5 on (2, 2), then on (1, 2): the reference's
#: ``test_elastic_remesh_subprocess`` (batch 8 x 32 tokens, 3 + 3 steps).
DIST_ELASTIC = dict(arch="qwen1.5-4b", batch=8, seq=33, steps=3, lr=1e-3, seed=5)
#: Bytes a trained parameter holds at the optimizer's peak: the float32
#: master, its gradient, two moments and AdamW's two update temporaries.
STATE_BYTES = 24
#: Per rank, beside the state: its CUDA context, the logits of its block
#: of the vocabulary and their softmax, the rematerialised activations.
RANK_RESERVE = 8 << 30
DIST_TIMEOUT = 420.0


def dense_param_counts(cfg) -> tuple[int, int]:
    """(parameters per layer, parameters outside the layers) of a dense
    model (unpadded attention: the plan adds no slot at tp=2 here)."""
    d, h, kv, hd, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.d_ff
    attn = 2 * d * h * hd + 2 * d * kv * hd + h + ((h + 2 * kv) * hd if cfg.qkv_bias else 0)
    mlp = (3 if cfg.act == "swiglu" else 2) * d * ff
    norms = 2 * d if cfg.norm == "rmsnorm" else 4 * d
    head = 0 if cfg.tie_embeddings else cfg.vocab_size * d
    return attn + mlp + 2 * norms, cfg.vocab_size * d + head + norms


def dist_layers(free_bytes: int, ranks: int = 2) -> tuple[int, str]:
    """The depth of phase 10 (a): the most layers whose training state
    (``STATE_BYTES`` a parameter) fits the card's free memory beside
    ``RANK_RESERVE`` per rank, at least ``DIST["min_layers"]``."""
    from repro_torch.configs import get_config

    cfg = get_config(DIST["arch"])
    per_layer, fixed = dense_param_counts(cfg)
    fit = int((0.92 * free_bytes - ranks * RANK_RESERVE - STATE_BYTES * fixed)
              // (STATE_BYTES * per_layer))
    layers = max(DIST["min_layers"], min(cfg.n_layers, fit))
    whole = STATE_BYTES * (fixed + cfg.n_layers * per_layer)
    why = (f"{cfg.n_layers} layers are {(fixed + cfg.n_layers * per_layer) / 1e9:.2f} B "
           f"parameters: {whole / 1e9:.1f} GB at {STATE_BYTES} bytes each (float32 master, "
           f"gradient, two moments, AdamW's two temporaries) beside {ranks} x "
           f"{RANK_RESERVE >> 30} GiB of activations and logits, on {free_bytes / 2**30:.1f} GiB "
           f"free; {fit} layers fit, {layers} run")
    return layers, why


def _zipf_tokens(rng, vocab: int, shape) -> "torch.Tensor":
    import numpy as np
    import torch

    return torch.as_tensor(np.minimum(rng.zipf(1.2, shape) - 1, vocab - 1).astype(np.int64))


def _gloo_cuda_probe() -> dict:
    """Which ``gloo`` collectives take CUDA tensors on this machine (the
    port stages every CUDA collective through host memory on ``gloo``
    all the same, and counts the bytes)."""
    import torch
    import torch.distributed as dist

    n = dist.get_world_size()
    x = torch.ones(8 * n, device="cuda")
    calls = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_reduce_bfloat16": lambda: dist.all_reduce(x.to(torch.bfloat16)),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(8 * n * n, device="cuda"), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(8, device="cuda"), x),
    }
    out = {"backend": dist.get_backend()}
    for name, call in calls.items():
        try:
            call()
            torch.cuda.synchronize()
            out[name] = "runs"
        except (RuntimeError, ValueError) as exc:  # the answer, recorded and printed
            out[name] = "refused: " + str(exc).strip().splitlines()[0][:160]
    return out


def _whole_tree(model, tree: dict) -> dict:
    """Every leaf of a parameter-shaped tree of this rank's chunks, whole."""
    from repro_torch.launch.spmd import gather_whole

    sp = model.spmd
    return {k: gather_whole(t.detach(), sp.specs[k], sp.mesh) for k, t in tree.items()}


def _one_step(model, opt, toks, shards: bool) -> dict:
    """One ``loss_and_grads`` + AdamW step; -> the numbers
    :func:`step_agreement` reads, whole (gathered on a mesh)."""
    from repro_torch.train import loss_and_grads

    params = dict(model.named_parameters())
    loss, _, grads = loss_and_grads(model, {"tokens": toks})
    old = {k: p.detach().clone() for k, p in params.items()}
    kept = {k: g.clone() for k, g in grads.items()}
    _, state = opt.update(grads, opt.init(params), params,
                          **({"shards": model.spmd} if shards else {}))
    g_used = {k: m / (1 - opt.b1) for k, m in state.mu.items()}
    new = {k: p.detach() for k, p in params.items()}
    if shards:
        old, kept, new, g_used = (_whole_tree(model, t) for t in (old, kept, new, g_used))
    return dict(loss=float(loss), grads=kept, old=old, new=new, g_used=g_used)


def _dist_card_vs_card(rank: int, mesh) -> dict:
    """(b): one float32 step at 2 layers on ``mesh`` against one step on
    a single rank (rank 0, the other waiting), from the same seed."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as K
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW

    cfg = dataclasses.replace(get_config(DIST["arch"]), n_layers=DIST_SMALL["layers"])
    dev = torch.device("cuda", 0)
    toks = torch.as_tensor(np.random.default_rng(DIST_SMALL["seed"]).integers(
        0, cfg.vocab_size, (DIST_SMALL["batch"], DIST_SMALL["seq"]))).to(dev)
    opt = AdamW(lr=1e-3)
    build = lambda **kw: build_model(cfg, device=dev, seed=DIST_SMALL["seed"],  # noqa: E731
                                     trainable=True, act_dtype=torch.float32, **kw)
    K.reset_launch_counts()
    sharded = _one_step(build(mesh=mesh), opt, toks, shards=True)
    counts = K.launch_counts()
    out = {"launches": counts}
    if rank == 0:
        torch.cuda.empty_cache()
        single = _one_step(build(), opt, toks, shards=False)
        out.update(step_agreement(single, sharded, opt, "phase 10 (b)", "one rank",
                                  "mesh (1, 2)"))
        del single
    del sharded
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def _dist_ef(rank: int) -> dict:
    """(c): ``make_compressed_dp_grads`` on mesh (data 2, model 1) at 2
    layers, float32; then the loss over ``DIST_EF["steps"]`` steps. The
    first step's gradients (error 0) against the ranks' own gradients:
    each element within one int8 step (the largest rank's scale) of a
    plain version of the reference's arithmetic (each rank's codes from
    ``compress_int8`` of each of the reference's leaves, a stacked one
    holding every layer, summed, times the largest scale, over the ranks),
    and within what that arithmetic allows of the exact mean: a rank's
    codes are off its gradient by half its own step, and are then scaled
    by the largest step, which moves a code q by |q| times the scales'
    difference. So the exact mean is held to ``sum_r (|q_r| (s_max -
    s_r) + s_r / 2) / n`` (plus 1e-3 of a step for float32 rounding); the
    distance in int8 steps is printed."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import reference_path
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, compress_int8
    from repro_torch.train import loss_and_grads, make_compressed_dp_grads

    mesh = make_mesh((2, 1), ("data", "model"), "cuda")
    comm = mesh.comm("data")
    cfg = dataclasses.replace(get_config(DIST["arch"]), n_layers=DIST_SMALL["layers"])
    dev = torch.device("cuda", 0)
    model = build_model(cfg, device=dev, seed=DIST_SMALL["seed"], trainable=True,
                        act_dtype=torch.float32)
    toks = torch.as_tensor(np.random.default_rng(13).integers(
        0, cfg.vocab_size, (DIST_EF["batch"], DIST_EF["seq"]))).to(dev)
    params = dict(model.named_parameters())
    _, _, local = loss_and_grads(model, {"tokens": toks.chunk(comm.size)[comm.rank]})
    grads_fn = make_compressed_dp_grads(model, mesh, ("data",))
    err = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
    before = dict(comm.bytes)
    grads, err, loss = grads_fn({"tokens": toks}, err)
    wire = {k: v - before.get(k, 0) for k, v in comm.bytes.items()}
    steps, over, off_exact = {}, {}, {}
    n = comm.size
    groups: dict[str, list[str]] = {}  # the reference's leaves: a stacked one holds every layer
    for k in local:
        groups.setdefault(reference_path(k), []).append(k)
    for k, names in groups.items():
        g = torch.stack([local[name] for name in names])
        got = torch.stack([grads[name] for name in names])
        ranks = comm.all_gather(g[None], 0)
        codes, scales = zip(*(compress_int8(r) for r in ranks))
        q, s = torch.stack(codes).float(), torch.stack(scales)
        top = s.max()
        plain = q.sum(0) * top / n
        allowed = ((q.abs() * (top - s).view(-1, *[1] * g.dim())).sum(0) + s.sum() / 2) / n
        diff = (got - ranks.mean(0)).abs()
        steps[k] = float((got - plain).abs().max() / top)
        over[k] = float((diff - allowed).max() / top)
        off_exact[k] = float(diff.max() / top)
    del local
    opt = AdamW(lr=DIST_EF["lr"])
    state = opt.init(params)
    losses = [float(loss)]
    for _ in range(DIST_EF["steps"] - 1):
        _, state = opt.update(grads, state, params)
        grads, err, loss = grads_fn({"tokens": toks}, err)
        losses.append(float(loss))
    worst = max(steps, key=steps.get)
    worst_over = max(over, key=over.get)
    worst_exact = max(off_exact, key=off_exact.get)
    del model, params, grads, err, state
    gc.collect()
    torch.cuda.empty_cache()
    return dict(int8_steps_off_plain=steps[worst], worst=worst,
                steps_beyond_allowed=over[worst_over], worst_over=worst_over,
                int8_steps_off_exact=off_exact[worst_exact], worst_exact=worst_exact,
                losses=losses, wire_bytes=wire, leaves=len(steps))


def _dist_serve(rank: int, mesh, layers: int) -> dict:
    """(d): the bf16 model of (a) (``layers`` deep) on ``mesh``: a warm-up,
    prefill of ``DIST_SERVE`` rows, greedy decode; then 2 layers in
    float32, teacher-forced on a single rank's greedy tokens (rank 0)."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as K
    from repro_torch.models import build_model
    from repro_torch.train import make_serve_step

    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config(DIST["arch"]), n_layers=layers)
    b, n, steps = DIST_SERVE["batch"], DIST_SERVE["prompt"], DIST_SERVE["steps"]
    rng = np.random.default_rng(21)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, n))).to(dev)
    model = build_model(cfg, device=dev, seed=11, mesh=mesh)
    model.prefill({"tokens": toks[:, :128]}, 128 + steps)  # warm-up
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = model.prefill({"tokens": toks}, n + steps)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    slots = caches["kv"][0]["k"].shape[1]
    step = make_serve_step(model)
    nxt = logits.argmax(-1).to(torch.int32)
    lengths = torch.full((b,), n, dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        nxt, logits, caches, lengths = step(caches, nxt, lengths)
    final = nxt.tolist()  # the host read ends the timed loop
    decode_s = time.perf_counter() - t0
    counts = K.launch_counts()
    finite = bool(torch.isfinite(logits).all())
    del model, caches, logits
    gc.collect()
    torch.cuda.empty_cache()

    small = dataclasses.replace(cfg, n_layers=DIST_SMALL["layers"])
    p = DIST_SERVE["small_prompt"]
    prompt = toks[:, :p]

    def greedy(model, forced=None):
        logits, caches = model.prefill({"tokens": prompt}, p + steps)
        out, toks_ = [logits], []
        lengths = torch.full((b,), p, dtype=torch.int32, device=dev)
        serve = make_serve_step(model)
        for i in range(steps):
            t = logits.argmax(-1).to(torch.int32) if forced is None else forced[i]
            toks_.append(t)
            _, logits, caches, lengths = serve(caches, t, lengths)
            out.append(logits)
        return torch.stack(out), toks_

    agree = {}
    ref = [None]
    if rank == 0:
        ref = [greedy(build_model(small, device=dev, seed=12).float())]
        torch.cuda.empty_cache()
    obj = [None if rank else [t.cpu() for t in ref[0][1]]]
    dist.broadcast_object_list(obj, src=0)
    got, _ = greedy(build_model(small, device=dev, seed=12, mesh=mesh).float(),
                    forced=[t.to(dev) for t in obj[0]])
    if rank == 0:
        want = ref[0][0]
        err = float((got - want).abs().max())
        _greedy_agrees(got, want, err, "phase 10 (d) float32, mesh (1, 2) against one rank")
        agree = dict(logits_max_abs_err=err, steps=steps + 1,
                     tokens=[t.tolist() for t in ref[0][1]])
    del got
    gc.collect()
    torch.cuda.empty_cache()
    return dict(prefill_s=prefill_s, decode_s=decode_s, decode_tokens_per_s=b * steps / decode_s,
                slots_per_rank=slots, launches=counts, finite=finite, last_tokens=final,
                small=agree)


def _dist_train(rank: int, mesh, layers: int) -> dict:
    """(a): ``DIST`` on ``mesh``, ``layers`` deep."""
    import dataclasses
    import statistics

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as K
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.train import TrainState, make_train_step

    dev = torch.device("cuda", 0)
    cfg = dataclasses.replace(get_config(DIST["arch"]), n_layers=layers)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=DIST["seed"], trainable=True, mesh=mesh)
    build_s = time.perf_counter() - t0
    opt = AdamW(lr=cosine_schedule(DIST["lr"], 2, DIST["steps"]))
    params = dict(model.named_parameters())
    state = TrainState(params, opt.init(params))
    step = make_train_step(model, opt)
    rng = np.random.default_rng(DIST["seed"])
    batches = [_zipf_tokens(rng, cfg.vocab_size, (DIST["batch"], DIST["seq"])).to(dev)
               for _ in range(DIST["steps"])]
    comm = mesh.comm("model")
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, secs, per_step = [], [], {}
    for i, toks in enumerate(batches):
        if i == 2:
            comm.bytes.clear()
            comm.staged.clear()
        t0 = time.perf_counter()
        state, metrics = step(state, {"tokens": toks})
        losses.append(float(metrics["loss"]))  # the host read ends the step
        secs.append(time.perf_counter() - t0)
        if i == 2:
            per_step = dict(bytes=dict(comm.bytes), staged=dict(comm.staged))
    med = statistics.median(secs[2:])
    out = dict(layers=layers, losses=losses, step_s=secs, step_s_median=med,
               tokens_per_s=DIST["batch"] * DIST["seq"] / med,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30, build_s=build_s,
               launches=K.launch_counts(), collective_bytes_per_step=per_step["bytes"],
               staged_bytes_per_step=per_step["staged"],
               params_per_rank=sum(p.numel() for p in params.values()))
    del model, params, state, step, batches
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _staging_ms(comm, n: int = 10) -> dict:
    """One staged all-reduce of a bf16 activation of (a) (batch x seq x
    d_model), ms per call, and its parts: the copy to pinned host memory,
    gloo's all-reduce there, the copy back."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config

    d = get_config(DIST["arch"]).d_model
    x = torch.randn(DIST["batch"], DIST["seq"], d, device="cuda").to(torch.bfloat16)
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    out = dict(bytes=x.numel() * x.element_size(), all_reduce=ms(lambda: comm.all_reduce(x)),
               to_host=ms(lambda: host.copy_(x)),
               gloo=ms(lambda: dist.all_reduce(host, group=comm.group)),
               to_card=ms(lambda: host.to(x.device)))
    comm.bytes.clear()
    comm.staged.clear()
    return out


def _dist_job_tp(rank: int, layers: int) -> dict:
    """The 2-rank job: the gloo probe, (b), (c), (d), then (a)."""
    from repro_torch.launch.mesh import make_mesh

    res = {"probe": _gloo_cuda_probe(), "seconds": {}}
    mesh = make_mesh((1, 2), ("data", "model"), "cuda")
    res["staging_ms"] = _staging_ms(mesh.comm("model"))
    for part, run in (("b", lambda: _dist_card_vs_card(rank, mesh)),
                      ("c", lambda: _dist_ef(rank)),
                      ("d", lambda: _dist_serve(rank, mesh, layers)),
                      ("a", lambda: _dist_train(rank, mesh, layers))):
        t0 = time.perf_counter()
        res[part] = run()
        res["seconds"][part] = time.perf_counter() - t0
    return res


def _dist_job_elastic(rank: int, layers: int) -> dict:
    """(e), 4 ranks: 3 steps on (2, 2), ``reshard_state`` onto (1, 2),
    3 more; rank 0 then runs the 6 steps alone and compares."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.elastic import reshard_state
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.spmd import gather_whole
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.train import TrainState, make_train_step

    del layers
    e = DIST_ELASTIC
    dev = torch.device("cuda", 0)
    cfg = get_smoke_config(e["arch"])
    toks = torch.as_tensor(np.random.default_rng(e["seed"]).integers(
        0, cfg.vocab_size, (e["batch"], e["seq"]))).to(dev)
    mesh_a = make_mesh((2, 2), ("data", "model"), "cuda")
    mesh_b = make_mesh((1, 2), ("data", "model"), "cuda", ranks=(0, 1))
    build = lambda **kw: build_model(cfg, device=dev, seed=e["seed"], trainable=True,  # noqa: E731
                                     act_dtype=torch.float32, **kw)
    model = build(mesh=mesh_a)
    opt = AdamW(lr=e["lr"])
    params = dict(model.named_parameters())
    state = TrainState(params, opt.init(params))
    step = make_train_step(model, opt)
    losses = []
    for _ in range(e["steps"]):
        state, m = step(state, {"tokens": toks})
        losses.append(float(m["loss"]))
    state = reshard_state(state, cfg, mesh_b, model=model)
    out = {"losses": losses}
    if state is not None:
        for _ in range(e["steps"]):
            state, m = step(state, {"tokens": toks})
            losses.append(float(m["loss"]))
        whole = {k: gather_whole(p.detach(), model.spmd.specs[k], mesh_b)
                 for k, p in state.params.items()}
        if rank == 0:
            one = build()
            params1 = dict(one.named_parameters())
            s1, step1 = TrainState(params1, opt.init(params1)), make_train_step(one, opt)
            single = []
            for _ in range(2 * e["steps"]):
                s1, m1 = step1(s1, {"tokens": toks})
                single.append(float(m1["loss"]))
            worst = max((float(((whole[k] - p.detach()).abs() - 2e-3 * p.detach().abs()).max()),
                         k) for k, p in s1.params.items())
            out.update(single=single, param_excess_over_2e3=worst[0], worst=worst[1])
    dist.barrier()
    return out


def _dist_rank(rank: int, world: int, init: str, job: str, layers: int, out_dir: str,
               src: str) -> None:
    """A spawned rank of phase 10: joins the ``gloo`` process group (ranks
    that share one card cannot use ``nccl``), runs ``job`` and saves what
    it returns. An exception ends the rank with a non-zero code."""
    sys.path.insert(0, src)
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=DIST_TIMEOUT))
    try:
        jobs = {"tp": _dist_job_tp, "elastic": _dist_job_elastic, "long": _dist_job_long}
        res = jobs[job](rank, layers)
        torch.save(res, Path(out_dir) / f"{job}_{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn_ranks(job: str, world: int, layers: int) -> list[dict]:
    """Run ``job`` on ``world`` spawned ranks that share the card; every
    rank must exit 0 within ``DIST_TIMEOUT`` (the others are killed when
    one fails). -> each rank's result."""
    import multiprocessing as mp
    import shutil

    import torch

    out = ROOT / "build" / "phase10" / job
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_dist_rank, args=(r, world, str(out / "rendezvous"), job,
                                                  layers, str(out), str(SRC)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + DIST_TIMEOUT
    try:
        while any(p.is_alive() for p in procs):
            failed = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            check(not failed, f"phase 10 {job}: a rank exited with {failed}")
            check(time.perf_counter() < deadline,
                  f"phase 10 {job}: ranks still running after {DIST_TIMEOUT:.0f} s")
            time.sleep(0.2)
        codes = [p.exitcode for p in procs]
        check(codes == [0] * world, f"phase 10 {job}: rank exit codes {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(30)
    res = [torch.load(out / f"{job}_{r}.pt", weights_only=False) for r in range(world)]
    shutil.rmtree(out, ignore_errors=True)
    return res


def phase_distributed() -> dict:
    """Phase 10: the port's multi-rank layer (``launch/{mesh,sharding,
    spmd,elastic}.py``) on ranks that share the one card, over ``gloo``
    with every collective staged through host memory (counted). Two
    ranks on one card measure correctness and the cost of the
    collectives on one card, not scaling across cards."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    layers, why = dist_layers(free)
    log(f"  (a) depth: {why}")
    t0 = time.perf_counter()
    tp = spawn_ranks("tp", 2, layers)
    tp_s = time.perf_counter() - t0
    probe = tp[0]["probe"]
    log(f"  gloo with CUDA tensors on this machine: {json.dumps(probe)}; a staged all-reduce "
        f"of one activation of (a), ms: {json.dumps(tp[0]['staging_ms'])}; seconds by part "
        f"(rank 0): {json.dumps(tp[0]['seconds'])}")
    b = tp[0]["b"]
    check(all(r["b"]["launches"]["flash_attention"] > 0
              and r["b"]["launches"]["flash_attention_bwd"] > 0 for r in tp),
          "phase 10 (b): a rank launched no flash kernel")
    c = tp[0]["c"]
    log(f"  (c) int8 error feedback on (2, 1), first step, in int8 steps of the largest "
        f"scale: {c['int8_steps_off_plain']:.3g} from the plain arithmetic ({c['worst']}), "
        f"{c['steps_beyond_allowed']:.3g} beyond what it allows of the exact mean "
        f"({c['worst_over']}), {c['int8_steps_off_exact']:.3g} from the exact mean "
        f"({c['worst_exact']}); {c['leaves']} tensors; losses "
        f"{[round(x, 4) for x in c['losses']]}; bytes a step {c['wire_bytes']}")
    check(c["int8_steps_off_plain"] <= 1.0, f"phase 10 (c): {c['worst']} is "
          f"{c['int8_steps_off_plain']:.3g} int8 steps from the plain arithmetic")
    check(c["steps_beyond_allowed"] <= 1e-3, f"phase 10 (c): {c['worst_over']} is "
          f"{c['steps_beyond_allowed']:.3g} int8 steps beyond its bound from the exact mean")
    check(c["losses"][-1] < c["losses"][0], f"phase 10 (c): loss did not fall: {c['losses']}")
    d = tp[0]["d"]
    log(f"  (d) serving {layers} layers, bf16, on (1, 2): prefill {DIST_SERVE['batch']} x "
        f"{DIST_SERVE['prompt']} in {d['prefill_s']:.4f} s, {DIST_SERVE['steps']} greedy steps "
        f"{d['decode_tokens_per_s']:.1f} tokens/s; {d['slots_per_rank']} KV slots a rank; "
        f"launches {d['launches']}; 2 layers float32 against one rank: {d['small']}")
    check(d["slots_per_rank"] == 10, f"phase 10 (d): {d['slots_per_rank']} slots a rank")
    check(d["finite"], "phase 10 (d): non-finite logits")
    for r in tp:
        check(r["d"]["launches"]["decode_attention"] > 0
              and r["d"]["launches"]["flash_attention"] > 0,
              "phase 10 (d): a rank launched no decode or flash kernel")
    a = [r["a"] for r in tp]
    losses = a[0]["losses"]
    check(all(math.isfinite(x) for x in losses), f"phase 10 (a): non-finite loss {losses}")
    check(losses[-1] < losses[0], f"phase 10 (a): loss did not fall: {losses}")
    for i, r in enumerate(a):
        for name in ("flash_attention", "flash_attention_bwd"):
            check(r["launches"][name] > 0, f"phase 10 (a): rank {i} launched no {name} kernel")
    log(f"  (a) training {DIST['arch']} {layers} of 40 layers on (1, 2): loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; step {a[0]['step_s_median']:.4f} s (median "
        f"after step 2), {a[0]['tokens_per_s']:.1f} tokens/s; peak "
        f"{[round(r['peak_gib'], 2) for r in a]} GiB a rank; collective bytes a step and rank "
        f"{a[0]['collective_bytes_per_step']}, staged through the host "
        f"{a[0]['staged_bytes_per_step']} (backend {probe['backend']}); launches a rank "
        f"{[r['launches'] for r in a]}; build {a[0]['build_s']:.1f} s")
    log(f"  (a) losses {[round(x, 4) for x in losses]}")
    t0 = time.perf_counter()
    el = spawn_ranks("elastic", 4, layers)
    el_s = time.perf_counter() - t0
    e = el[0]
    log(f"  (e) elastic smoke qwen1.5: (2, 2) losses {e['losses'][:3]}, then (1, 2) "
        f"{e['losses'][3:]}; one rank {e['single']}; worst parameter beyond 2e-3 "
        f"{e['param_excess_over_2e3']:.3g} ({e['worst']})")
    check(e["losses"][-1] < e["losses"][0], f"phase 10 (e): loss did not fall: {e['losses']}")
    check(abs(e["losses"][-1] - e["single"][-1]) <= 2e-3 + 2e-3 * abs(e["single"][-1]),
          f"phase 10 (e): loss {e['losses'][-1]} against one rank's {e['single'][-1]}")
    check(e["param_excess_over_2e3"] <= 2e-3, f"phase 10 (e): {e['worst']} beyond 2e-3")
    log(f"  phase 10: {tp_s:.1f} s (2 ranks), {el_s:.1f} s (4 ranks)")
    return dict(layers=layers, depth=why, probe=probe, staging_ms=tp[0]["staging_ms"],
                part_seconds=tp[0]["seconds"], b=b, c=c, d=d, a=a, e=e,
                seconds=dict(tp=tp_s, elastic=el_s),
                launches=dict(flash_attention=a[0]["launches"]["flash_attention"],
                              flash_attention_bwd=a[0]["launches"]["flash_attention_bwd"],
                              decode_attention=d["launches"]["decode_attention"]))


# --------------------------------------------------------------------------
# phase 11: long-context decode and every family's serving on a mesh
# --------------------------------------------------------------------------

#: Phase 11's meshes: (a) and (b) on the data axis, (c) on the model axis.
LONG_MESH, FAMILY_MESH = (2, 1), (1, 2)
#: (a): zamba2-1.2B whole in ``long_500k``'s layout (batch 1, the cache's
#: sequence over the data axis of (2, 1)), its KV caches seeded up to
#: ``filled`` positions; no prefill, as in the reference's cell.
LONG = dict(arch="zamba2-1.2b", max_len=524288, filled=400000, steps=16, seed=31)
#: (b): float32, batch 1, against one rank holding the whole cache; the
#: prompt runs past the ranks' boundary at max_len / 2 (5,120 tokens: the
#: hybrid family's chunked scan takes whole chunks of 128). Depths:
#: zamba2 with one shared-attention application, qwen1.5-4b at 2 layers.
LONG_SMALL = dict(layers={"zamba2-1.2b": 7, "qwen1.5-4b": 2}, max_len=8192, prompt=5120,
                  steps=16, seed=32)
#: (b) also: the int8 KV cache (``attention_options(kv_quant=True)``) in
#: the long-context layout, the chain of ``tests/test_torch_long_context.py
#: ::test_int8_cache_in_the_long_context_layout_equals_one_rank`` on the
#: card: smoke qwen1.5-4b in float32, 20 teacher-forced decode steps from
#: empty caches of 32 positions on (2, 1), so the second rank's chunk is
#: empty for the first 16, against one rank's int8 chain at rtol/atol
#: 1e-5. At the smoke widths a float32 difference of the merge moves few
#: values near a code's rounding edge; the two chains part by a code
#: where one does, and the logits then by far more than 1e-5.
LONG_INT8 = dict(arch="qwen1.5-4b", max_len=32, steps=20, seed=62, tol=1e-5)
#: (c): the families whose serving on a mesh is new, at full width on
#: (1, 2), bf16; then at ``small_layers`` in float32 against one rank.
MESH_FAMILIES = {
    "zamba2-1.2b": dict(prompt=1024, max_len=1040, small_layers=7),
    "xlstm-125m": dict(prompt=1024, max_len=1040, small_layers=2),
    "whisper-small": dict(prompt=384, max_len=448, small_layers=2),
}
MESH_SERVE = dict(batch=4, steps=16, small_batch=2, small_prompt=128, seed=33)
#: Logits of a mesh against one rank, float32 (phase 10 (d) reads ~1e-5).
MESH_TOL = 1e-4


def _decode_chain(model, inputs: dict, batch: int, n: int, max_len: int, steps: int,
                  forced=None):
    """Prefill ``inputs`` (on a mesh, the rank keeps its chunk of the
    caches), then ``steps`` decode steps in the caches' layout, greedy or
    on the ``forced`` tokens. -> (logits (steps + 1, B, V), the tokens
    fed)."""
    import torch

    from repro_torch.train import make_serve_step

    logits, caches = model.prefill(inputs, max_len)
    sp = getattr(model, "spmd", None)
    lengths = torch.full((batch,), n, dtype=torch.int32, device=logits.device)
    serve = make_serve_step(model, None if sp is None else sp.serve_layout(batch, max_len))
    out, fed = [logits], []
    for i in range(steps):
        t = logits.argmax(-1).to(torch.int32) if forced is None else forced[i]
        fed.append(t)
        _, logits, caches, lengths = serve(caches, t, lengths)
        out.append(logits)
    return torch.stack(out), fed


def _against_one_rank(rank: int, mesh, cfg, inputs: dict, batch: int, n: int, max_len: int,
                      steps: int, seed: int, what: str) -> dict:
    """float32: rank 0 alone, greedy, holding the whole caches; then
    every rank of ``mesh`` teacher-forced on its tokens. Rank 0 checks
    the logits within ``MESH_TOL`` and the greedy tokens
    (``_greedy_agrees``). -> the launches, and on rank 0 the error."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import ops as K
    from repro_torch.models import build_model

    dev = torch.device("cuda", 0)
    want = [None]
    if rank == 0:
        want = list(_decode_chain(build_model(cfg, device=dev, seed=seed).float(), inputs,
                                  batch, n, max_len, steps))
        torch.cuda.empty_cache()
    obj = [None if rank else [t.cpu() for t in want[1]]]
    dist.broadcast_object_list(obj, src=0)
    K.reset_launch_counts()
    got, _ = _decode_chain(build_model(cfg, device=dev, seed=seed, mesh=mesh).float(), inputs,
                           batch, n, max_len, steps, forced=[t.to(dev) for t in obj[0]])
    out = {"launches": K.launch_counts()}
    if rank == 0:
        err = float((got - want[0]).abs().max())
        check(err <= MESH_TOL, f"{what}: logits {err:.3g} from one rank's")
        _greedy_agrees(got, want[0], err, what)
        out["logits_max_abs_err"] = err
    del got, want
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _int8_chain(model, tokens, max_len: int, layout=None):
    """Decode ``tokens`` one by one from empty int8 caches (on a mesh in
    ``layout``) -> the logits of each step (steps, 1, V)."""
    import torch

    from repro_torch.models.attention import attention_options
    from repro_torch.train import make_serve_step

    with attention_options(kv_quant=True):
        caches = model.init_caches(1, max_len)
        check("k_q" in caches["kv"][0], "phase 11 (b) int8: the caches are not int8")
        step = make_serve_step(model, layout)
        lengths = torch.zeros((1,), dtype=torch.int32, device=tokens.device)
        seq = []
        for t in tokens:
            _, logits, caches, lengths = step(caches, t[None], lengths)
            seq.append(logits)
    return torch.stack(seq)


def _long_int8(rank: int, mesh) -> dict:
    """(b)'s int8 chain (``LONG_INT8``) on ``mesh`` (2, 1) against rank
    0 alone; rank 0 checks."""
    import numpy as np
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops as K
    from repro_torch.models import build_model

    q = LONG_INT8
    dev = torch.device("cuda", 0)
    cfg = get_smoke_config(q["arch"])
    toks = torch.as_tensor(np.random.default_rng(q["seed"]).integers(
        0, cfg.vocab_size, q["steps"]), dtype=torch.int32, device=dev)
    want = None
    if rank == 0:
        want = _int8_chain(build_model(cfg, device=dev, seed=q["seed"]).float(), toks,
                           q["max_len"])
    K.reset_launch_counts()
    model = build_model(cfg, device=dev, seed=q["seed"], mesh=mesh).float()
    layout = model.spmd.serve_layout(1, q["max_len"])
    check(layout.seq is not None, "phase 11 (b) int8: not the long-context layout")
    got = _int8_chain(model, toks, q["max_len"], layout)
    out = {"launches": K.launch_counts()}
    if rank == 0:
        check_close(got.cpu(), want.cpu(), q["tol"], q["tol"],
                    f"phase 11 (b) int8 chain on (2, 1) against one rank")
        out["logits_max_abs_err"] = float((got - want).abs().max())
    return out


def _long_a(rank: int, mesh) -> dict:
    """(a): ``LONG`` on ``mesh`` (2, 1)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as K
    from repro_torch.models import build_model
    from repro_torch.train import make_serve_step

    dev = torch.device("cuda", 0)
    cfg = get_config(LONG["arch"])
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=dev, seed=LONG["seed"], mesh=mesh)
    caches = model.init_caches(1, LONG["max_len"])
    sp = model.spmd
    layout = sp.serve_layout(1, LONG["max_len"])
    check(layout.seq is not None and not layout.rows_split,
          "phase 11 (a): not the long-context layout")
    chunk = caches["shared_kv"][0]["k"].shape[2]
    filled = max(0, min(chunk, LONG["filled"] - sp.data.rank * chunk))
    # Each rank its positions of one seeded cache; the Mamba2 states alike on every rank.
    gen = torch.Generator(dev).manual_seed(LONG["seed"] + 1 + sp.data.rank)
    for kv in caches["shared_kv"]:
        for t in kv.values():
            t[:, :, :filled].normal_(generator=gen)
    gen.manual_seed(LONG["seed"])
    for m in caches["mamba"]:
        for t in m.values():
            t.normal_(0.0, 0.1, generator=gen)
    cache_gib = sum(t.numel() * t.element_size() for kv in caches["shared_kv"]
                    for t in kv.values()) / 2**30
    step = make_serve_step(model, layout)
    nxt = torch.ones((1,), dtype=torch.int32, device=dev)
    lengths = torch.full((1,), LONG["filled"], dtype=torch.int32, device=dev)
    nxt, logits, caches, lengths = step(caches, nxt, lengths)  # warm-up: cuBLAS, allocator
    comm = mesh.comm("data")
    comm.bytes.clear()
    comm.staged.clear()
    K.reset_launch_counts()
    finite = torch.isfinite(logits).all()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LONG["steps"]):
        nxt, logits, caches, lengths = step(caches, nxt, lengths)
        finite &= torch.isfinite(logits).all()
    tokens = nxt.tolist()  # the host read ends the timed loop
    decode_s = time.perf_counter() - t0
    n = LONG["steps"]
    out = dict(decode_s=decode_s, step_s=decode_s / n, tokens_per_s=n / decode_s,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30, cache_gib_per_rank=cache_gib,
               positions_per_rank=chunk, filled_on_rank=filled, launches=K.launch_counts(),
               staged_bytes_per_step=sum(comm.staged.values()) / n,
               collective_bytes_per_step={k: v / n for k, v in comm.bytes.items()},
               finite=bool(finite), last_tokens=tokens)
    del model, caches, logits
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _long_b(rank: int, mesh) -> dict:
    """(b): ``LONG_SMALL`` on ``mesh`` (2, 1) against one rank."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config

    dev = torch.device("cuda", 0)
    b = LONG_SMALL
    out = {}
    for arch, layers in b["layers"].items():
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        toks = torch.as_tensor(np.random.default_rng(b["seed"]).integers(
            0, cfg.vocab_size, (1, b["prompt"]))).to(dev)
        out[arch] = _against_one_rank(
            rank, mesh, cfg, {"tokens": toks}, 1, b["prompt"], b["max_len"], b["steps"],
            b["seed"], f"phase 11 (b) {arch} {layers} layers, cache {b['max_len']} on (2, 1)")
    out["int8"] = _long_int8(rank, mesh)
    return out


def _mesh_families(rank: int, mesh) -> dict:
    """(c): each of ``MESH_FAMILIES`` on ``mesh`` (1, 2): bf16 at full
    width (a warm-up, then prefill and greedy decode timed), then float32
    at ``small_layers`` against one rank."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as K
    from repro_torch.models import build_model
    from repro_torch.train import make_serve_step

    dev = torch.device("cuda", 0)
    sv = MESH_SERVE
    out = {}
    for arch, spec in MESH_FAMILIES.items():
        cfg = get_config(arch)
        b, n, steps = sv["batch"], spec["prompt"], sv["steps"]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = build_model(cfg, device=dev, seed=sv["seed"], mesh=mesh)
        inputs = _family_inputs(cfg, b, n, torch.Generator(dev).manual_seed(sv["seed"]), dev)
        warm = {k: v[:, :128] if k == "tokens" else v for k, v in inputs.items()}
        model.prefill(warm, 128 + 2)  # first cuBLAS use, allocator
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = model.prefill(inputs, spec["max_len"])
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        step = make_serve_step(model)
        nxt = logits.argmax(-1).to(torch.int32)
        lengths = torch.full((b,), n, dtype=torch.int32, device=dev)
        finite = torch.isfinite(logits).all()
        t0 = time.perf_counter()
        for _ in range(steps):
            nxt, logits, caches, lengths = step(caches, nxt, lengths)
            finite &= torch.isfinite(logits).all()
        nxt.tolist()  # the host read ends the timed loop
        decode_s = time.perf_counter() - t0
        res = dict(prefill_s=prefill_s, decode_s=decode_s,
                   decode_tokens_per_s=b * steps / decode_s,
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   launches=K.launch_counts(), finite=bool(finite))
        del model, caches, logits, inputs
        gc.collect()
        torch.cuda.empty_cache()
        small = dataclasses.replace(cfg, n_layers=spec["small_layers"],
                                    encoder_layers=min(cfg.encoder_layers, 2))
        sb, sn = sv["small_batch"], sv["small_prompt"]
        inputs = _family_inputs(small, sb, sn, torch.Generator(dev).manual_seed(sv["seed"]), dev)
        res["small"] = _against_one_rank(
            rank, mesh, small, inputs, sb, sn, sn + steps, steps, sv["seed"],
            f"phase 11 (c) {arch} {spec['small_layers']} layers on (1, 2)")
        out[arch] = res
    return out


def _dist_job_long(rank: int, layers: int) -> dict:
    """Phase 11 on 2 ranks: (a) and (b) on (2, 1), (c) on (1, 2)."""
    from repro_torch.launch.mesh import make_mesh

    del layers
    by_data = make_mesh(LONG_MESH, ("data", "model"), "cuda")
    by_model = make_mesh(FAMILY_MESH, ("data", "model"), "cuda")
    res = {"seconds": {}}
    for part, run in (("a", lambda: _long_a(rank, by_data)),
                      ("b", lambda: _long_b(rank, by_data)),
                      ("c", lambda: _mesh_families(rank, by_model))):
        t0 = time.perf_counter()
        res[part] = run()
        res["seconds"][part] = time.perf_counter() - t0
    return res


def shared_applications(cfg) -> int:
    """The shared-attention applications of a hybrid config (one after
    every Mamba2 segment but the last): its decode_attention calls a
    decode step."""
    from repro_torch.models.transformer import zamba_segments

    return len(zamba_segments(cfg)) - 1


def family_kernels(cfg) -> tuple[str, ...]:
    """The LM kernels a prefill and decode of ``cfg``'s family launch:
    the Mamba2 scan in the hybrid family, the two attention kernels in
    every family but xLSTM's (no attention layer)."""
    scan = ("mamba2_chunk_scan",) if cfg.family == "hybrid" else ()
    return scan + (() if cfg.family == "ssm" else ("flash_attention", "decode_attention"))


def phase_long_context() -> dict:
    """Phase 11: long-context decode (the caches' sequence over the data
    axis, decode_attention's log-sum-exp merged across ranks) and the
    hybrid, xLSTM and whisper families served on a mesh, by two ranks
    that share the card over ``gloo``."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = spawn_ranks("long", 2, 0)
    seconds = time.perf_counter() - t0
    from repro_torch.configs import get_config

    a = [r["a"] for r in res]
    steps = LONG["steps"]
    calls = shared_applications(get_config(LONG["arch"])) * steps
    for i, r in enumerate(a):
        check(r["finite"], f"phase 11 (a): rank {i} non-finite logits")
        check(r["launches"]["decode_attention"] == calls,
              f"phase 11 (a): rank {i} launched decode_attention "
              f"{r['launches']['decode_attention']} times, not {calls}")
        check(r["filled_on_rank"] > 0, f"phase 11 (a): rank {i} holds no key")
    log(f"  (a) {LONG['arch']} whole, batch 1, cache {LONG['max_len']} on (2, 1): "
        f"{a[0]['positions_per_rank']} positions a rank ({[r['filled_on_rank'] for r in a]} "
        f"seeded), {a[0]['cache_gib_per_rank']:.2f} GiB of KV a rank; {steps} greedy steps "
        f"{a[0]['decode_s']:.4f} s = {a[0]['tokens_per_s']:.2f} tokens/s, "
        f"{a[0]['step_s']:.4f} s a step; peak {[round(r['peak_gib'], 2) for r in a]} GiB a "
        f"rank; staged {a[0]['staged_bytes_per_step']:.4g} bytes a step and rank, "
        f"collectives {a[0]['collective_bytes_per_step']}; decode_attention launches with lse "
        f"{[r['launches']['decode_attention'] for r in a]}; tokens {a[0]['last_tokens']}")
    for arch in (*LONG_SMALL["layers"], "int8"):
        check(all(x["b"][arch]["launches"]["decode_attention"] > 0 for x in res),
              f"phase 11 (b) {arch}: a rank launched no decode_attention")
    for arch in LONG_SMALL["layers"]:
        r = res[0]["b"][arch]
        log(f"  (b) {arch} {LONG_SMALL['layers'][arch]} layers float32, cache "
            f"{LONG_SMALL['max_len']} on (2, 1), prompt {LONG_SMALL['prompt']}: logits "
            f"{r['logits_max_abs_err']:.3g} from one rank's over {LONG_SMALL['steps'] + 1} "
            f"steps; launches {r['launches']}")
    r = res[0]["b"]["int8"]
    log(f"  (b) int8 KV cache, smoke {LONG_INT8['arch']} float32, {LONG_INT8['steps']} "
        f"teacher-forced steps from empty caches of {LONG_INT8['max_len']} on (2, 1): logits "
        f"{r['logits_max_abs_err']:.3g} from one rank's int8 chain (bar {LONG_INT8['tol']}); "
        f"launches {r['launches']}")
    c = res[0]["c"]
    for arch, r in c.items():
        check(all(x["c"][arch]["finite"] for x in res),
              f"phase 11 (c) {arch}: non-finite logits")
        for name in family_kernels(get_config(arch)):
            check(all(x["c"][arch]["launches"][name] > 0 for x in res),
                  f"phase 11 (c) {arch}: a rank launched no {name}")
        log(f"  (c) {arch} full width on (1, 2), bf16: prefill {MESH_SERVE['batch']} x "
            f"{MESH_FAMILIES[arch]['prompt']} {r['prefill_s']:.4f} s, {MESH_SERVE['steps']} "
            f"greedy steps {r['decode_tokens_per_s']:.1f} tokens/s, peak "
            f"{[round(x['c'][arch]['peak_gib'], 2) for x in res]} GiB a rank, launches "
            f"{r['launches']}; {MESH_FAMILIES[arch]['small_layers']} layers float32: logits "
            f"{r['small']['logits_max_abs_err']:.3g} from one rank's")
    log(f"  phase 11: {seconds:.1f} s; seconds by part (rank 0) {json.dumps(res[0]['seconds'])}")
    return dict(a=a, b=res[0]["b"], c=c, seconds=seconds, part_seconds=res[0]["seconds"],
                launches=dict(decode_attention=a[0]["launches"]["decode_attention"],
                              flash_attention=sum(r["launches"]["flash_attention"]
                                                  for r in c.values())))


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    t_main = time.perf_counter()
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
    numpy_tile = start_numpy_whole_tile()  # phase 3b's numpy path, beside every phase

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
    # The backward kernels' profiler counts come before the LM rows' many
    # profiler sessions and multi-GB plain versions: after those, one
    # whole run saw the profiler drop a kernel record in every session.
    kres.update(phase_backward_kernels())
    kres.update(phase_lm_kernels())
    kres["flash_attention"]["build"] = flash_build
    kres["mamba2_chunk_scan_bwd"]["build"] = scan_bwd_build
    phase1_counts = K.launch_counts()
    log(f"phase 2: main path, {N_TILES} tiles of {TILE}x{TILE}, one gpu lane")
    runs = phase_main_path(tiles)
    log(f"phase 6: main path across processes, {MP_TILES} tiles of {TILE}x{TILE}, "
        f"{MP_WORKERS} worker processes with one gpu lane each, SocketBus")
    procs = phase_processes(tiles[:MP_TILES], runs[True]["feats"])
    log_processes(procs, runs[True])
    # With push off (direct pulls from the sibling) the crossing is held
    # on the CPU only: a second run here would cost 65-95 s of 1200.
    log("phase 6b: phase 6 with locality off, predictive push True: regions cross "
        "worker to worker")
    log_processes(phase_processes(tiles[:MP_TILES], runs[True]["feats"], locality=False,
                                  label="phase 6b"), runs[True], procs)
    log("phase 3: 256x256 tile, card vs numpy")
    phase_parity()
    log(f"phase 8: hybrid node, {HYBRID_TILES} tiles of {HYBRID_SIZE}x{HYBRID_SIZE}, "
        f"runs {HYBRID_RUNS}")
    hybrid = phase_hybrid()
    tile0 = tiles[0]  # phase 3b's, last: its numpy path runs beside every phase
    del tiles
    gc.collect()
    log(f"phase 4: serving {SERVE['arch']} at full width: {SERVE}")
    served = phase_serving()
    log("phase 5: zamba2-1.2B, 8 layers at full width, card vs CPU")
    phase_card_vs_cpu()
    log(f"phase 5b: the dry run's bytes against the card: {DRYRUN_STEP}")
    phase_dryrun_bytes()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 7: training {TRAIN['arch']} at full width: {TRAIN}")
    trained = phase_training()
    log("phase 7b: one train step, zamba2-1.2B cut to 8 layers, float32, card vs CPU")
    phase_train_card_vs_cpu()
    log("phase 7c: smoke zamba2, checkpoint, resume")
    phase_train_resume()
    log(f"phase 7d: smoke zamba2, bf16 loss curve, card vs CPU: {BF16_CURVE}")
    phase_train_bf16_curve()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 9: the other families at the published widths: {FAMILIES}; {XLSTM_SERVE}; "
        f"card against CPU: {FAMILY_SMOKE} and the int8 KV cache")
    families = phase_families()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 10: ranks that share this card over gloo: (a) {DIST}, (b) {DIST_SMALL}, "
        f"(c) {DIST_EF}, (d) {DIST_SERVE}, (e) {DIST_ELASTIC}")
    distributed = phase_distributed()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 11: long-context decode and serving on a mesh, ranks that share this card: "
        f"(a) {LONG}, (b) {LONG_SMALL} and {LONG_INT8}, (c) {MESH_FAMILIES} {MESH_SERVE}")
    long_ctx = phase_long_context()
    log(f"phase 3b: phase 2's tile 0, {TILE}x{TILE}, card vs numpy")
    phase_whole_tile(tile0, numpy_tile)
    log(f"whole run: {time.perf_counter() - t_main:.1f} s")

    records = []
    family_keys = [key for shapes in (*family_shapes(), *rank_shapes(), *long_shapes()[:2])
                   for key in shapes]
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
               if k in ("inputs", "gqa_d128", "gqa_long", "plan", "shape", "build", "float32",
                        *DECODE_SHAPES, *family_keys,
                        "ms_clean_l2", "device_ms", "kernels_per_call", "copy_device_ms",
                        "fused_op_vs_cpu", "bytes_yardstick_ms")},
        ))
        if name in ("flash_attention", "mamba2_chunk_scan"):
            records[-1]["launches_training"] = trained["launches"][name]
        if name in ("color_deconv", "morph_recon"):
            records[-1]["launches_hybrid"] = hybrid["runs"]["B"]["launches"][name]
        if name in ("flash_attention", "decode_attention"):
            records[-1]["launches_families"] = {m: families[m]["launches"][name]
                                                for m in FAMILIES}
        if name in ("flash_attention", "flash_attention_bwd", "decode_attention"):
            n = distributed["launches"][name]
            check(n > 0, f"{name}: no launch in phase 10's rank 0")
            records[-1]["launches_distributed_rank0"] = n
        if name in ("flash_attention", "decode_attention"):
            n = long_ctx["launches"][name]
            check(n > 0, f"{name}: no launch in phase 11's rank 0")
            records[-1]["launches_long_context_rank0"] = n
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
