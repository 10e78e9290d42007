"""End-to-end training entry point (the port of ``repro/launch/train.py``).

Composes the whole stack: demand-driven chunk ledger (Manager), the
double-buffered prefetching loader (pinned, ``non_blocking`` copies on a
side stream), the train step (autograd through the flash and scan
kernels' backward, per-layer rematerialisation, AdamW with a cosine
schedule), async atomic checkpointing with the ledger's state, and
checkpoint/restart fault tolerance. Runs on the card by default; the
CPU only when asked (``device="cpu"``: the kernels' plain versions).

Examples::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \\
        --smoke --steps 50 --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --resume \\
        --ckpt-dir build/ck --steps 100     # restart resumes mid-epoch
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b --full \\
        --batch 4 --seq 1023 --steps 24

The hybrid family's chunked SSD needs the sequence (``seq + 1`` tokens
per row, the loader's next-token layout) to be a multiple of
``min(128, seq + 1)``: at full width use ``seq=1023``.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..app._device import resolve_device
from ..ckpt import AsyncCheckpointer, latest_step, load_checkpoint
from ..configs import get_config, get_smoke_config
from ..data import ChunkLedger, PrefetchLoader, TokenChunkSource
from ..models import build_model
from ..models.config import ArchConfig
from ..optim import AdamW, cosine_schedule
from ..train import TrainState, make_train_step

__all__ = ["main", "run_training"]


@torch.no_grad()
def _copy_into(live, saved) -> None:
    """Copy a checkpoint's CPU leaves into the live state, in place."""
    if isinstance(live, dict):
        for k in live:
            _copy_into(live[k], saved[k])
    elif isinstance(live, tuple):
        for a, b in zip(live, saved):
            _copy_into(a, b)
    else:
        live.copy_(saved)


def run_training(
    arch: str = "qwen1.5-4b",
    smoke: bool = True,
    steps: int = 50,
    batch: int = 8,
    seq: int = 128,
    ckpt_dir: str | None = None,
    ckpt_every: int = 20,
    resume: bool = False,
    microbatches: int = 1,
    fail_at: int | None = None,
    n_chunks: int = 10_000,
    log_every: int = 10,
    seed: int = 0,
    device="cuda",
    cfg: ArchConfig | None = None,
) -> dict:
    """Train ``arch`` (or ``cfg``, when given) from seeded weights.
    Returns the reference's dict (``final_step``, ``metrics`` with
    ``step``, ``loss``, ``tps`` per logged step, ``final_loss``,
    ``chunks``) plus each logged step's ``seconds`` since the start,
    ``device`` and the final ``state`` (its tensors are the live ones)."""
    dev = resolve_device(device)
    if cfg is None:
        cfg = get_smoke_config(arch) if smoke else get_config(arch)
    model = build_model(cfg, device=dev, seed=seed, trainable=True)
    opt = AdamW(lr=cosine_schedule(3e-4, warmup_steps=20, total_steps=steps))
    step_fn = make_train_step(model, opt, microbatches=microbatches)

    params = dict(model.named_parameters())
    state = TrainState(params=params, opt=opt.init(params))
    ledger = ChunkLedger(n_chunks, lease_timeout=60.0)
    start_step = 0

    ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    if resume and ckpt_dir and latest_step(ckpt_dir) is not None:
        # Tensors restore from the shard; ledger state (variable-length
        # chunk lists) rides in the JSON manifest.
        saved, manifest = load_checkpoint(ckpt_dir, state)
        _copy_into(state, saved)
        ledger = ChunkLedger.from_state(manifest["meta"]["ledger"])
        start_step = int(manifest["step"])
        print(f"[train] resumed from step {start_step}")

    source = TokenChunkSource(cfg.vocab_size, seq, batch, seed=seed)
    loader = PrefetchLoader(ledger, source, lease_block=4, depth=2, device=dev)

    metrics_hist: list[dict] = []
    t0 = time.monotonic()
    step_idx = start_step
    tokens_done = 0
    for cid, chunk in loader:
        if step_idx >= steps:
            break
        batch_d = {"tokens": chunk["tokens"].long()}
        state, metrics = step_fn(state, batch_d)
        loader.commit(cid)
        step_idx += 1
        tokens_done += batch * seq
        if fail_at is not None and step_idx == fail_at:
            loader.stop()
            raise RuntimeError(f"injected failure at step {step_idx}")
        if step_idx % log_every == 0 or step_idx == steps:
            loss = float(metrics["loss"])  # the one host read of a logged step
            elapsed = time.monotonic() - t0
            tps = tokens_done / elapsed
            print(
                f"[train] step {step_idx:5d} loss={loss:.4f} "
                f"tokens/s={tps:,.0f}",
                flush=True,
            )
            metrics_hist.append({"step": step_idx, "loss": loss, "tps": tps,
                                 "seconds": elapsed})
        if ckpt is not None and step_idx % ckpt_every == 0:
            ckpt.save(step_idx, state,
                      meta={"arch": cfg.name, "ledger": ledger.state_dict()})
    loader.stop()
    if ckpt is not None:
        ckpt.save(step_idx, state,
                  meta={"arch": cfg.name, "ledger": ledger.state_dict()})
        ckpt.wait()
    return {
        "final_step": step_idx,
        "metrics": metrics_hist,
        "final_loss": metrics_hist[-1]["loss"] if metrics_hist else None,
        "chunks": len(loader.chunks_seen),
        "device": str(dev),
        "state": state,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out = run_training(
        arch=args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
        seq=args.seq, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        resume=args.resume, microbatches=args.microbatches,
        fail_at=args.fail_at, seed=args.seed, device=args.device,
    )
    print(f"[train] done: {out['final_step']} steps, "
          f"final loss {out['final_loss']}")


if __name__ == "__main__":
    main()
