"""Where a WSI stage completion's time goes on the wire, one tile.

    python3 benchmarks/torch_wire.py [--size 4096] [--device cuda] [--repeat 2]

Runs one tile of the fused workflow through the port's ops on
``--device`` and takes the two ``stage_complete`` payloads a worker
sends the Manager (every op's state dict: the 8 segmentation ops, then
``feature_fused`` and the 3 other feature ops). For each it times, on
this host: the download of its tensors (``.cpu()``), its canonical CRC
(``faults.region_crc``), ``WireCodec.encode`` and ``decode`` of the
message, and one ``SocketBus`` call carrying it to a second process
(encode, 1 MB segments, localhost TCP, reassembly, decode, reply),
once with the default 1 MB frames and once unsegmented. Prints the
card's ``nvidia-smi`` name and power limit (with ``--device cuda``) and
one JSON line. The tile is ``chip_smoke.mosaic_tiles``' first (below
1024x1024, a ``synth_tile``).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import resource
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def _serve(conn) -> None:
    """Child process: a SocketBus server whose ``sink`` decodes the
    message and answers with the number of op states it carried."""
    from repro_torch.transport import SocketBus

    bus = SocketBus()
    conn.send(bus.serve({"sink": lambda peer, payload: len(payload[1])}))
    conn.recv()
    bus.close()


def _completions(size: int, device: str) -> dict:
    import torch

    import chip_smoke
    from repro_torch.app import synth_tile
    from repro_torch.app.pipeline import OP_IMPLS, _SEG_ORDER, _feature_fused_accel
    from repro_torch.core.calibration import FUSED_FEATURE_OPS, PARALLEL_FEATURE_OPS

    dev = torch.device(device)
    if size >= chip_smoke.POOL_TILE:
        tile = chip_smoke.mosaic_tiles(1, size)[0]
    else:  # a small tile for a rehearsal on the CPU
        tile = synth_tile(0, size=size)
    seg, state = {}, tile
    for name in _SEG_ORDER:
        state = seg[name] = OP_IMPLS[name][1](state, device=dev)
    feat = {"feature_fused": _feature_fused_accel(state, device=dev)}
    for name in PARALLEL_FEATURE_OPS:
        if name not in FUSED_FEATURE_OPS:
            feat[name] = OP_IMPLS[name][1](feat["feature_fused"], device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return {"segmentation": seg, "features": feat}


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _download(outputs: dict) -> int:
    import torch

    seen, nbytes = set(), 0
    for state in outputs.values():
        for v in state.values():
            if isinstance(v, torch.Tensor) and id(v) not in seen:
                seen.add(id(v))
                v.cpu()
                nbytes += v.nbytes
    return nbytes


def measure(outputs: dict, address: str, repeat: int) -> dict:
    from repro_torch.faults import region_crc
    from repro_torch.transport import SocketBus, default_codec

    msg = ("req", 1, "stage_complete", (7, outputs, 0.1))
    codec = default_codec()
    rec: dict = {"unique_tensor_bytes": _download(outputs)}
    for key in ("download_s", "crc_s", "encode_s", "decode_s",
                "socket_1mb_frames_s", "socket_unsegmented_s"):
        rec[key] = []
    for _ in range(repeat):
        rec["download_s"].append(_timed(lambda: _download(outputs))[1])
        rec["crc_s"].append(_timed(lambda: region_crc(outputs))[1])
        data, s = _timed(lambda: codec.encode(msg))
        rec["encode_s"].append(s)
        rec["wire_bytes"] = len(data)
        rec["decode_s"].append(_timed(lambda: codec.decode(data))[1])
        del data
        for key, frame in (("socket_1mb_frames_s", 1 << 20), ("socket_unsegmented_s", 0)):
            bus = SocketBus(max_frame_bytes=frame)
            peer = bus.connect(address)
            n, s = _timed(lambda: peer.call("sink", msg[3], timeout=900.0))
            if n != len(outputs):
                raise RuntimeError(f"the server decoded {n} op states of {len(outputs)}")
            rec[key].append(s)
            rec[f"{key[:-2]}_segments"] = peer.sent_segments
            peer.close()
            bus.close()
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--repeat", type=int, default=2)
    args = ap.parse_args()
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("torch_wire: no CUDA card", file=sys.stderr)
            return 2
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(f"nvidia-smi: {smi.stdout.strip()}", flush=True)
        from repro_torch.kernels import _build

        _build.build_all(("morph_recon", "feature_fused"))
    ctx = mp.get_context("spawn")
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=_serve, args=(child,), daemon=True)
    proc.start()
    try:
        address = parent.recv()
        comps = _completions(args.size, args.device)
        out = {"size": args.size, "device": args.device}
        for name, outputs in comps.items():
            out[name] = measure(outputs, address, args.repeat)
        out["peak_rss_bytes"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    finally:
        parent.send("stop")
        proc.join(timeout=30.0)
        if proc.is_alive():
            proc.kill()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
