"""End-to-end example of the PyTorch/CUDA port: train a ~100M-parameter
LM for a few hundred steps (the port of ``examples/train_lm.py``).

Full stack: demand-driven chunk ledger, prefetching loader (side-stream
copies to the card), AdamW with cosine schedule, per-layer remat, async
atomic checkpoints, and restart-from-checkpoint (kill it mid-run and
re-run with --resume). Runs on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 300
    PYTHONPATH=src python examples/train_lm_torch.py --steps 300 --resume
    PYTHONPATH=src python examples/train_lm_torch.py --steps 5 --device cpu
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.train import run_training  # noqa: E402
from repro_torch.models.config import reduced  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=str(Path(__file__).resolve().parents[1]
                                               / "build" / "train_lm_torch"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    # ~100M-parameter config of the qwen1.5 family (QKV bias etc.).
    cfg = reduced(
        get_config("qwen1p5_4b"),
        n_layers=8, d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
        d_ff=2048, vocab_size=50_304,
    )
    print(f"config: {cfg.name} {cfg.n_params() / 1e6:.1f}M params, device {args.device}")
    out = run_training(
        cfg=cfg, steps=args.steps, batch=args.batch, seq=args.seq,
        ckpt_dir=args.ckpt_dir, ckpt_every=50, resume=args.resume, log_every=10,
        device=args.device,
    )
    losses = [m["loss"] for m in out["metrics"]]
    print(
        f"done: {out['final_step']} steps; loss {losses[0]:.3f} -> "
        f"{losses[-1]:.3f}; checkpoints in {args.ckpt_dir}"
    )


if __name__ == "__main__":
    main()
