"""Serving scenario on the PyTorch/CUDA port (the port of
``examples/serve_lm.py``): batched requests through prefill/decode.

The request scheduler uses the middleware's roofline cost model to
order work: prefill (compute-bound, high accelerator speedup) vs
decode (HBM-bound, low speedup) — serving is the LM-era instance of
the paper's performance-variability observation. The estimates are
those of one H100 lane (``launch/costs_h100.py``). Runs the smoke
configuration on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/serve_lm_torch.py --requests 12 --max-new 12
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.serve import serve_requests  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (raises if absent)")
    args = ap.parse_args()
    out = serve_requests(
        arch=args.arch, n_requests=args.requests, batch_size=args.batch,
        prompt_len=args.prompt_len, max_new=args.max_new, max_len=128,
        device=args.device,
    )
    est = out["pats_estimates"]
    print(
        f"{out['requests']} requests -> {out['tokens']} tokens at "
        f"{out['tokens_per_s']:.1f} tok/s (ttft {out['mean_ttft_s']:.2f}s)\n"
        f"steps: {out['steps']}\n"
        f"PATS roofline estimates: prefill {est['prefill']:.0f}x vs "
        f"decode {est['decode']:.0f}x — compute-bound prefill owns the "
        f"tensor-core lane, memory-bound decode fills the gaps."
    )


if __name__ == "__main__":
    main()
