"""Feed-forward blocks: SwiGLU / GeLU MLP (the port of ``repro/models/mlp.py``)."""

from __future__ import annotations

import torch

from .layers import dense_init, gelu, swish, tp_enter, tp_exit

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
    """On a tensor-parallel rank (``p.tp``): its columns of ``w_up`` and
    ``w_gate``, its rows of ``w_down``, the outputs summed over the ranks."""
    x = tp_enter(p, x)
    up = x @ p["w_up"].to(x.dtype)
    if act == "swiglu":
        gate = x @ p["w_gate"].to(x.dtype)
        h = swish(gate) * up
    else:
        h = gelu(up)
    return tp_exit(p, h @ p["w_down"].to(x.dtype))
