"""One benchmark per paper table/figure (§V of the paper), on the
PyTorch/CUDA port: the port of ``benchmarks/paper_figs.py``.

    PYTHONPATH=src python -m benchmarks.torch_paper_figs --only fig9
    PYTHONPATH=src python -m benchmarks.torch_paper_figs --only fig7 --device cpu --size 64

Each function returns a list of CSV rows ``(name, value, derived)``;
``main`` prints them as ``name,value,derived``. Simulator-backed
results run the port's copy of the calibrated cluster simulator
(``repro_torch.core.simulator``) at the paper's scale (or a documented
reduction), so their rows equal the reference's; ``fig7`` also
*measures* the port's function variants on a synthetic tile: the numpy
``cpu`` variant against the PyTorch ``gpu`` variant on ``--device``
(the card by default; raises without one).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.calibration import OP_PROFILES, aggregate_gpu_speedup  # noqa: E402
from repro_torch.core.simulator import SimConfig, run_simulation  # noqa: E402

Row = tuple[str, float, str]


def bench_fig7_op_speedups(measure: bool = True, device="cuda",
                           size: int = 256) -> list[Row]:
    """Per-op accelerator speedups (calibrated) + measured variant
    runtimes (numpy vs PyTorch on ``device``) on a real ``size``² tile.
    Each shape is warmed first; on a CUDA device every clock read is
    preceded by ``torch.cuda.synchronize()``."""
    rows: list[Row] = []
    for name, p in OP_PROFILES.items():
        rows.append((f"fig7/{name}/speedup_calibrated", p.gpu_speedup,
                     f"cpu_fraction={p.cpu_fraction}"))
    rows.append(("fig7/aggregate/speedup", aggregate_gpu_speedup(),
                 "paper~6.5"))
    if measure:
        import torch

        from repro_torch.app._device import resolve_device
        from repro_torch.app.pipeline import OP_IMPLS, _SEG_ORDER, run_tile
        from repro_torch.app.tiles import synth_tile
        from repro_torch.core.calibration import PARALLEL_FEATURE_OPS

        dev = resolve_device(device)

        def clock() -> float:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return time.perf_counter()

        tile = synth_tile(0, size=size, seed=0)
        # Warm the kernels' builds and caches, then measure both variants per op.
        run_tile(tile, "accel", device=dev)
        state_by_op: dict[str, object] = {}
        state = tile
        order = [*_SEG_ORDER, "color_deconv", *PARALLEL_FEATURE_OPS]
        for op in order:
            state_by_op[op] = state
            state = OP_IMPLS[op][0](state)
        for op in order:
            inp = state_by_op[op]
            t0 = time.perf_counter()
            OP_IMPLS[op][0](inp)
            t_cpu = time.perf_counter() - t0
            OP_IMPLS[op][1](inp, device=dev)  # warm this shape
            t0 = clock()
            OP_IMPLS[op][1](inp, device=dev)
            t_acc = clock() - t0
            rows.append(
                (f"fig7/{op}/measured_ratio", t_cpu / max(t_acc, 1e-9),
                 f"cpu={t_cpu*1e3:.1f}ms accel={t_acc*1e3:.1f}ms device={dev}")
            )
    return rows


def bench_fig8_placement() -> list[Row]:
    rows: list[Row] = []
    cpu1 = run_simulation(
        100, SimConfig(n_gpus=0, n_cpu_cores=1, policy="fcfs", window=15)
    )
    for ngpu in (1, 2, 3):
        for placement in ("closest", "os"):
            r = run_simulation(
                100,
                SimConfig(n_gpus=ngpu, n_cpu_cores=0, policy="fcfs",
                          window=15, placement=placement),
            )
            rows.append(
                (f"fig8/{ngpu}gpu/{placement}/speedup",
                 cpu1.makespan / r.makespan,
                 f"makespan={r.makespan:.1f}s")
            )
    # derived: closest-vs-os gains (paper: ~3/6/8%)
    for ngpu in (1, 2, 3):
        c = [v for n, v, _ in rows if n == f"fig8/{ngpu}gpu/closest/speedup"][0]
        o = [v for n, v, _ in rows if n == f"fig8/{ngpu}gpu/os/speedup"][0]
        rows.append((f"fig8/{ngpu}gpu/closest_gain_pct", 100 * (c / o - 1),
                     "paper~3/6/8%"))
    return rows


def bench_fig9_coordination() -> list[Row]:
    rows: list[Row] = []
    n = 100
    cpu1 = run_simulation(n, SimConfig(n_gpus=0, n_cpu_cores=1, window=15))
    cpu12 = run_simulation(n, SimConfig(n_gpus=0, n_cpu_cores=12, window=15))
    gpu3 = run_simulation(n, SimConfig(n_gpus=3, n_cpu_cores=0, window=15))
    configs = {
        "nonpipelined_fcfs": SimConfig(policy="fcfs", window=15, pipelined=False),
        "nonpipelined_pats": SimConfig(policy="pats", window=15, pipelined=False),
        "pipelined_fcfs": SimConfig(policy="fcfs", window=15),
        "pipelined_pats": SimConfig(policy="pats", window=17),
    }
    rows.append(("fig9/cpu12/speedup", cpu1.makespan / cpu12.makespan,
                 "paper~9"))
    rows.append(("fig9/gpu3/speedup", cpu1.makespan / gpu3.makespan,
                 "3 GPUs, ~linear in 1-GPU rate"))
    base_fcfs = None
    for name, cfg in configs.items():
        r = run_simulation(n, cfg)
        rows.append((f"fig9/{name}/speedup", cpu1.makespan / r.makespan,
                     f"makespan={r.makespan:.1f}s"))
        if name == "pipelined_fcfs":
            base_fcfs = r.makespan
        if name == "pipelined_pats":
            rows.append(("fig9/pats_over_fcfs", base_fcfs / r.makespan,
                         "paper~1.33"))
    return rows


def bench_fig10_profile() -> list[Row]:
    r = run_simulation(100, SimConfig(policy="pats", window=17))
    return [
        (f"fig10/{op}/gpu_fraction", frac, "PATS device profile")
        for op, frac in sorted(r.gpu_fraction_by_op().items())
    ]


def bench_fig11_locality() -> list[Row]:
    rows: list[Row] = []
    n = 100
    mono = run_simulation(n, SimConfig(policy="fcfs", window=15,
                                       pipelined=False))
    variants = {
        "fcfs": SimConfig(policy="fcfs", window=15),
        "fcfs_dl": SimConfig(policy="fcfs", window=15, locality=True),
        "fcfs_dl_prefetch": SimConfig(policy="fcfs", window=15, locality=True,
                                      prefetch=True),
        "pats": SimConfig(policy="pats", window=15),
        "pats_dl": SimConfig(policy="pats", window=15, locality=True),
        "pats_dl_prefetch": SimConfig(policy="pats", window=15, locality=True,
                                      prefetch=True),
    }
    rows.append(("fig11/nonpipelined_fcfs/makespan_s", mono.makespan, "base"))
    for name, cfg in variants.items():
        r = run_simulation(n, cfg)
        rows.append((f"fig11/{name}/makespan_s", r.makespan,
                     f"vs mono {mono.makespan / r.makespan:.2f}x "
                     f"reuse={r.reuse_hits}"))
    return rows


def bench_table2_window() -> list[Row]:
    rows: list[Row] = []
    for policy in ("fcfs", "pats"):
        for w in (12, 13, 14, 15, 16, 17, 18, 19):
            r = run_simulation(100, SimConfig(policy=policy, window=w))
            rows.append(
                (f"table2/{policy}/w{w}/makespan_s", r.makespan,
                 "paper: fcfs~73-75 flat, pats 75->51 sat@15")
            )
    return rows


def bench_fig13_error() -> list[Row]:
    rows: list[Row] = []
    base = run_simulation(100, SimConfig(policy="pats", window=17))
    fcfs = run_simulation(100, SimConfig(policy="fcfs", window=17))
    for err in (0.0, 0.2, 0.4, 0.6, 0.8, 1.0):
        r = run_simulation(
            100, SimConfig(policy="pats", window=17, speedup_error=err)
        )
        rows.append(
            (f"fig13/err{int(err*100)}/makespan_s", r.makespan,
             f"vs err0 {r.makespan / base.makespan:.2f}x "
             f"vs fcfs {r.makespan / fcfs.makespan:.2f}x")
        )
    return rows


def bench_fig14_scaling(full: bool = False) -> list[Row]:
    """Strong scaling.  full=True reruns 36,848 tiles (minutes);
    otherwise a 1/8 dataset plus the recorded full-run numbers."""
    rows: list[Row] = []
    tiles = 36848 if full else 36848 // 8
    for nodes in (8, 25, 50, 100):
        for io in (True, False):
            r = run_simulation(
                tiles,
                SimConfig(n_nodes=nodes, policy="pats", window=15,
                          locality=True, prefetch=True, include_io=io),
            )
            tag = "io" if io else "compute_only"
            rows.append(
                (f"fig14/{nodes}nodes/{tag}/tiles_per_s", r.tiles_per_second,
                 f"makespan={r.makespan:.0f}s tiles={tiles}")
            )
    # Efficiency derivations at the benched scale.
    per8 = [v for n, v, _ in rows if n == "fig14/8nodes/io/tiles_per_s"][0]
    per100 = [v for n, v, _ in rows if n == "fig14/100nodes/io/tiles_per_s"][0]
    rows.append(("fig14/efficiency_100v8_io", (per100 / 100) / (per8 / 8),
                 "paper~0.77 (full dataset: 0.76, see EXPERIMENTS.md)"))
    return rows


ALL_BENCHES = {
    "fig7": bench_fig7_op_speedups,
    "fig8": bench_fig8_placement,
    "fig9": bench_fig9_coordination,
    "fig10": bench_fig10_profile,
    "fig11": bench_fig11_locality,
    "table2": bench_table2_window,
    "fig13": bench_fig13_error,
    "fig14": bench_fig14_scaling,
}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None,
                    help=f"comma-separated bench names ({','.join(ALL_BENCHES)})")
    ap.add_argument("--device", default="cuda",
                    help="torch device of fig7's measured gpu variants")
    ap.add_argument("--size", type=int, default=256, help="fig7's tile side")
    args = ap.parse_args()
    selected = args.only.split(",") if args.only else list(ALL_BENCHES)
    print("name,value,derived")
    for name in selected:
        if name == "fig7":
            bench_rows = bench_fig7_op_speedups(device=args.device, size=args.size)
        else:
            bench_rows = ALL_BENCHES[name]()
        for row_name, value, derived in bench_rows:
            print(f"{row_name},{value:.6g},{derived}", flush=True)


if __name__ == "__main__":
    main()
