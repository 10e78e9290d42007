"""Int8 gradient compression (the port of ``repro/optim/compress.py``).

``compress_int8`` quantizes a gradient to int8 with one float32
per-tensor scale; ``decompress_int8`` undoes it. The reference's
``ef_roundtrip`` (error feedback around an int8 all-reduce) needs a
collective across the data-parallel ranks (``psum``/``pmax``): it comes
with ``make_compressed_dp_grads`` when the launchers beyond one card are
ported (ROADMAP.md, queue 1, item 6).
"""

from __future__ import annotations

import torch

__all__ = ["compress_int8", "decompress_int8"]


def compress_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = g.abs().max().float() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale
