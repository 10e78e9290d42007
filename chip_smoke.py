#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Before the main path: prints the card's name and its ``nvidia-smi``
name and power limit, then builds every kernel from ``csrc/*.cu`` (one
``nvcc`` per source, all at once) into ``build/torch_kernels/``.

Phase 1, kernels: each hand-written kernel (color_deconv, morph_recon,
feature_fused) against its plain PyTorch version on the card, at the
main-path shape 4096x4096 (strided uint8 channel views of a tile) and
at a ragged 1000x1500; times over many launches with CUDA events (L2
flushed before each) beside the plain version's time and the bound
from the bytes the function must move.

Phase 2, the main path: the Manager over one WorkerRuntime with one
``gpu`` lane (PATS, locality) runs 8 tiles of 4096x4096, once with
``build_workflow(fused=False)`` and once with ``fused=True``. Checks
every stage completed on the ``gpu`` lane, the kernels' launch counts
(zeroed just before each run) rose, and both runs agree per tile.

Phase 3: one 256x256 tile through ``run_tile`` on the card and through
the numpy path, at the bars of the reference's ``tests/test_app.py``.

Any failed check exits non-zero. The last lines are a JSON ``kernels``
record and ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS = 67e12           # H100 SXM, float32 outside the tensor cores
REPLACES = {
    "color_deconv": "src/repro/kernels/color_deconv.py:48",
    "morph_recon": "src/repro/kernels/morph_recon.py:82",
    "feature_fused": "src/repro/kernels/feature_fused.py:128",
}
N_TILES, TILE, POOL_TILE = 8, 4096, 1024


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
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    check(not bool(bad.any()), f"{what}: {int(bad.sum())} elements beyond "
          f"rtol={rtol} atol={atol} (max abs err {float(err.max())})")
    return float(err.max()) if err.numel() else 0.0


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / F32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def phase_kernels(tile) -> dict:
    import numpy as np
    import torch

    from repro_torch.app import segmentation as S
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
    mask = torch.as_tensor(rng.uniform(0, 255, (1000, 1500)).astype(np.float32), device=dev)
    marker = torch.clamp_min(mask - 55.0, 0.0) * torch.as_tensor(
        (rng.uniform(0, 1, (1000, 1500)) > 0.6).astype(np.float32), device=dev
    )
    n0 = MR.launches
    e = max_err(MR.morph_recon_cuda(marker, mask), ref.morph_recon_ref(marker, mask),
                0.0, 1e-5, "morph_recon 1000x1500")
    log(f"  morph_recon 1000x1500: max abs err {e:.3g}, {MR.launches - n0} launches")

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

    got, want = FF.feature_fused_cuda(r, g, b), ref.feature_fused_ref(r, g, b)
    err = max(max_err(k, p, 3e-5, 1e-4, f"feature_fused {h}x{w}") for k, p in zip(got[:3], want[:3]))
    max_err(got[3], want[3], 1e-4, 0.0, f"feature_fused stats {h}x{w}")
    bms, by = bound(3 * px + 12 * px + 24, 60 * px)
    results["feature_fused"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: FF.feature_fused_cuda(r, g, b), 50, flush),
        plain_ms=time_ms(lambda: ref.feature_fused_ref(r, g, b), 10, flush),
        bound_ms=bms, bound_by=by,
    )

    # morph_recon on the recon_to_nuclei input of the tile.
    inv = 255.0 - S._gray_t(rgb)
    marker = inv
    for _ in range(8):
        marker = S._erode_t(marker)
    n0 = MR.launches
    got = MR.morph_recon_cuda(marker, inv)
    per_call = MR.launches - n0
    err = max_err(got, ref.morph_recon_ref(marker, inv), 0.0, 1e-5, f"morph_recon {h}x{w}")
    bms, by = bound(12 * px, 10 * px)
    results["morph_recon"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: MR.morph_recon_cuda(marker, inv), 10, flush),
        plain_ms=time_ms(lambda: ref.morph_recon_ref(marker, inv), 3, flush),
        bound_ms=bms, bound_by=by,
        launches_per_call=per_call,
        bound_all_launches_ms=bound(12 * px, 0)[0] * per_call,
    )
    for name, res in results.items():
        log(f"  {name} {h}x{w}: " + ", ".join(
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


# --------------------------------------------------------------------------


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
    check(c0["morph_recon"] > 0 and c1["morph_recon"] > 0,
          "a run launched no morph_recon kernel")
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

    t0 = time.perf_counter()
    tiles = mosaic_tiles(N_TILES, TILE)
    log(f"tiles: {len(tiles)} x {TILE}x{TILE} mosaics in {time.perf_counter() - t0:.1f} s")

    log("phase 1: kernels vs plain versions")
    kres = phase_kernels(tiles[0])
    log(f"phase 2: main path, {N_TILES} tiles of {TILE}x{TILE}, one gpu lane")
    runs = phase_main_path(tiles)
    log("phase 3: 256x256 tile, card vs numpy")
    phase_parity()

    records = []
    for name in ("color_deconv", "morph_recon", "feature_fused"):
        res = kres[name]
        launches = sum(r["launches"][name] for r in runs.values())
        check(launches > 0, f"{name}: no launch on the main path")
        records.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces=REPLACES[name], launches=launches,
            max_abs_err=res["max_abs_err"], ms=res["ms"], plain_ms=res["plain_ms"],
            bound_ms=res["bound_ms"], bound_by=res["bound_by"], library_ms=None,
            **{k: v for k, v in res.items() if k in ("launches_per_call", "bound_all_launches_ms")},
        ))
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
