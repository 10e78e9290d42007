#!/usr/bin/env python3
"""Where a traced window of a WSI cell goes, on the card.

    python3 benchmarks/torch_wsi_trace.py --workload <cell> --seed <n> [--seconds 51] [--out FILE]

From the root of a checkout. Runs the cell's driver (``bench/drivers/``)
once with the instruments of ``bench/run.py --trace 1`` (the program's
``Tracer`` and ``torch.profiler`` over the window), skips the
comparison with the reference, and prints one JSON object (also written
to ``--out``): the cell's per-layer metrics, the device's idle seconds
by the innermost program span the host was in (``gc``, ``sync:<site>``,
an op's own time by ``op:<name>``, ``lane:between``, ``no span``), and
per tile: device and host milliseconds by op, queue waits by op, host
reads by site, the allocator's counts, and a turnaround's parts (the
lane in the tile's own ops, in other tiles' ops, between ops).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]

from benchkit.spans import device_s_by_op, idle_by_span, op_intervals, tile_spans  # noqa: E402
from benchkit.spec import load_cell, load_module, metrics_of  # noqa: E402
from benchkit.tiles import make_traffic  # noqa: E402
from benchkit.trace import union_seconds  # noqa: E402


def _sum_by(spans, key, value) -> dict:
    out: dict = {}
    for s in spans:
        k = key(s)
        out[k] = out.get(k, 0.0) + value(s)
    return out


def turnaround_parts(record) -> dict:
    """Seconds of a tile's turnaround (the lease of its first stage to the
    completion of its last), on average over the window's tiles: the lane
    in the tile's own ops, in other tiles' ops, between ops, and the rest."""
    lane = [(s["ts"], s["ts"] + s["dur"], "own" if s["name"].startswith("op:") else "between",
             record.op_chunks.get(s["args"].get("uid")) if s["name"].startswith("op:")
             else s["args"].get("chunk"))
            for s in record.spans if s["name"].startswith("op:") or s["name"] == "lane:between"]
    done = [t for t in record.done() if t.leased is not None]
    parts = {"own_ops": 0.0, "other_tiles_ops": 0.0, "lane_between": 0.0, "rest": 0.0}
    for t in done:
        lo = record.wall_open + (t.leased - record.t_open)
        hi = record.wall_open + (t.done - record.t_open)
        covered = 0.0
        for a, b, kind, chunk in lane:
            d = min(b, hi) - max(a, lo)
            if d <= 0:
                continue
            covered += d
            key = "lane_between" if kind == "between" else (
                "own_ops" if chunk == t.chunk else "other_tiles_ops")
            parts[key] += d
        parts["rest"] += (hi - lo) - covered
    return {k: v / len(done) for k, v in parts.items()} if done else {}


def summary(record, cell_name: str) -> dict:
    dev = record.device
    n = len(record.done())
    window = dev.window_s
    idle = idle_by_span(dev, record.spans)
    per_tile = lambda d, scale=1e3: {k: scale * v / n for k, v in sorted(d.items())}  # noqa: E731
    between = tile_spans(record, "lane:between")
    return {
        "tiles": n,
        "window_s": window,
        "metrics": {m["name"]: load_module("metrics", m["name"]).read(record)
                    for m in metrics_of(cell_name, True)},
        "idle_share": 100.0 * (1.0 - union_seconds(dev.clipped()) / window),
        "idle_share_by_span": {k: 100.0 * v / window
                               for k, v in sorted(idle.items(), key=lambda kv: -kv[1])},
        "device_ms_per_tile_by_op": per_tile(device_s_by_op(record)),
        "host_ms_per_tile_by_op": per_tile(_sum_by(op_intervals(record), lambda i: i[0],
                                                   lambda i: i[2] - i[1])),
        "wait_op_ms_per_tile_by_op": per_tile(_sum_by(tile_spans(record, "wait:op"),
                                                      lambda s: s["args"]["op"],
                                                      lambda s: s["dur"])),
        "syncs_per_tile_by_site": per_tile(_sum_by(tile_spans(record, "sync"),
                                                   lambda s: s["args"]["site"], lambda s: 1),
                                           scale=1.0),
        "sync_ms_per_tile_by_site": per_tile(_sum_by(tile_spans(record, "sync"),
                                                     lambda s: s["args"]["site"],
                                                     lambda s: s["dur"])),
        "allocator_per_tile": per_tile(
            {k: sum(s["args"].get(k, 0) for s in between) for k in ("allocs", "frees", "retries")},
            scale=1.0),
        "allocs_per_tile_by_op": per_tile(_sum_by(between, lambda s: s["args"]["op"],
                                                  lambda s: s["args"].get("allocs", 0)), scale=1.0),
        "lane_between_ms_per_tile": 1e3 * sum(s["dur"] for s in between) / n,
        "turnaround_s_by_part": turnaround_parts(record),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_wsi_trace.py: needs a CUDA card", file=sys.stderr)
        return 3
    cell = load_cell(args.workload)
    traffic = make_traffic(cell.traffic, args.seed, int(cell.config["tile"]))
    driver = load_module("drivers", cell.config["driver"])
    record, _ = driver.run(cell, traffic, args.seed, args.seconds, True, "cuda", T_START)
    out = {"workload": cell.name, "seed": args.seed, "device": torch.cuda.get_device_name(0),
           **summary(record, cell.name)}
    text = json.dumps(out)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
