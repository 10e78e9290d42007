"""Feed-forward blocks: SwiGLU / GeLU MLP (the port of ``repro/models/mlp.py``)."""

from __future__ import annotations

import torch

from .layers import dense_init, gelu, swish

__all__ = ["init_mlp", "apply_mlp"]


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, act: str,
             device=None) -> dict[str, torch.Tensor]:
    p = {
        "w_up": dense_init(gen, (d_model, d_ff), device=device),
        "w_down": dense_init(gen, (d_ff, d_model), fan_in=d_ff, device=device),
    }
    if act == "swiglu":
        p["w_gate"] = dense_init(gen, (d_model, d_ff), device=device)
    return p


def apply_mlp(p, x: torch.Tensor, act: str) -> torch.Tensor:
    up = x @ p["w_up"].to(x.dtype)
    if act == "swiglu":
        gate = x @ p["w_gate"].to(x.dtype)
        h = swish(gate) * up
    else:
        h = gelu(up)
    return h @ p["w_down"].to(x.dtype)
