"""Serving driver: batched prefill + decode with PATS lane estimates.

The port of ``repro/launch/serve.py``, with the same batcher: a group
of ``batch_size`` requests is prefilled once the decode batch has
drained, then decoded one token per step until every request in it has
``max_new`` tokens. Prefill is compute-bound and decode memory-bound;
the PATS estimates of the two op kinds are computed against an H100
lane (:mod:`.costs_h100`) instead of the reference's TPU v5e.

Runs on the card by default (weights from the port's seeded init on
the device; nothing falls back to the CPU)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b --full \\
        --requests 8 --prompt-len 1024 --max-new 32 --max-len 2048
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..app._device import resolve_device
from ..configs import get_config, get_smoke_config
from ..core.cost_model import OpCost, estimate_speedup
from ..models import build_model
from ..train import make_prefill_step, make_serve_step
from .costs_h100 import H100_SXM

__all__ = ["main", "serve_requests"]


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out_tokens: list[int] = field(default_factory=list)
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0


def _speedups(cfg, batch: int, prompt_len: int, cache_len: int):
    """Roofline PATS estimates for the two op kinds, on an H100 lane."""
    d = cfg.d_model
    n = cfg.active_params()
    prefill = OpCost(
        flops=2 * n * batch * prompt_len,
        bytes=2 * n + batch * prompt_len * d * 2,
        mxu_friendly=True,
    )
    decode = OpCost(
        flops=2 * n * batch,
        bytes=2 * n + batch * cache_len * d * 2,
        mxu_friendly=False,
    )
    return estimate_speedup(prefill, H100_SXM), estimate_speedup(decode, H100_SXM)


def serve_requests(
    arch: str = "qwen1.5-4b",
    smoke: bool = True,
    n_requests: int = 16,
    batch_size: int = 4,
    prompt_len: int = 32,
    max_new: int = 8,
    max_len: int = 128,
    seed: int = 0,
    device="cuda",
) -> dict:
    """Serve ``n_requests`` seeded random prompts of token ids (every
    family whose input is tokens: dense, moe, hybrid, ssm). Returns the
    reference's dict (``requests``, ``tokens``, ``tokens_per_s``,
    ``wall_s``, ``steps``, ``mean_ttft_s``, ``pats_estimates``) plus
    ``mean_decode_step_s`` and ``device``."""
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if prompt_len + max_new > max_len:
        raise ValueError(f"prompt_len {prompt_len} + max_new {max_new} > max_len {max_len}")
    if cfg.frontend != "none":
        raise ValueError(f"{cfg.name} reads precomputed embeddings, and serve_requests "
                         f"builds token prompts (as the reference's does): serve it through "
                         f"Model.prefill and Model.decode_step")
    model = build_model(cfg, device=dev, seed=seed)
    serve_step = make_serve_step(model)
    prefill = make_prefill_step(model, max_len)

    rs = np.random.default_rng(seed)
    waiting = [
        Request(
            rid=i,
            prompt=rs.integers(0, cfg.vocab_size, prompt_len).astype(np.int32),
            max_new=max_new,
            t_submit=time.monotonic(),
        )
        for i in range(n_requests)
    ]
    s_pre, s_dec = _speedups(cfg, batch_size, prompt_len, max_len)
    active: list[Request] = []
    caches = lengths = tokens = None
    done: list[Request] = []
    decode_s = 0.0
    t0 = time.monotonic()
    steps = {"prefill": 0, "decode": 0}

    while waiting or active:
        # Admission: one decode batch at a time, so prefill admits when
        # the decode batch has drained (as the reference's batcher).
        if waiting and not active:
            group = waiting[:batch_size]
            waiting = waiting[batch_size:]
            prompts = torch.as_tensor(np.stack([r.prompt for r in group]), device=dev)
            logits, caches = prefill({"tokens": prompts.long()})
            lengths = torch.full((len(group),), prompt_len, dtype=torch.int32, device=dev)
            tokens = torch.argmax(logits, dim=-1).to(torch.int32)
            for r, t in zip(group, tokens.cpu().tolist()):
                r.out_tokens.append(int(t))
                r.t_first = time.monotonic()
            active = group
            steps["prefill"] += 1
            continue
        # Decode one step for the active batch.
        t_step = time.monotonic()
        tokens, logits, caches, lengths = serve_step(caches, tokens.long(), lengths)
        host_tokens = tokens.cpu().tolist()  # waits for the step
        decode_s += time.monotonic() - t_step
        steps["decode"] += 1
        for r, t in zip(active, host_tokens):
            r.out_tokens.append(int(t))
        finished = [r for r in active if len(r.out_tokens) >= r.max_new]
        if finished:
            for r in finished:
                r.t_done = time.monotonic()
            done.extend(finished)
            active = [r for r in active if len(r.out_tokens) < r.max_new]
            if not active:
                caches = None
    wall = time.monotonic() - t0
    total_tokens = sum(len(r.out_tokens) for r in done)
    ttft = [r.t_first - r.t_submit for r in done if r.t_first]
    return {
        "requests": len(done),
        "tokens": total_tokens,
        "tokens_per_s": total_tokens / wall,
        "wall_s": wall,
        "steps": steps,
        "mean_ttft_s": float(np.mean(ttft)) if ttft else None,
        "mean_decode_step_s": decode_s / steps["decode"] if steps["decode"] else None,
        "pats_estimates": {"prefill": s_pre, "decode": s_dec},
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--full", action="store_true",
                    help="the architecture's full configuration, not its smoke one")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out = serve_requests(
        arch=args.arch, smoke=not args.full, n_requests=args.requests,
        batch_size=args.batch, prompt_len=args.prompt_len, max_new=args.max_new,
        max_len=args.max_len, seed=args.seed, device=args.device,
    )
    print(
        f"[serve] {out['requests']} requests, {out['tokens']} tokens, "
        f"{out['tokens_per_s']:.1f} tok/s, ttft={out['mean_ttft_s']:.3f}s, "
        f"steps={out['steps']}, pats={out['pats_estimates']}, device={out['device']}"
    )


if __name__ == "__main__":
    main()
