"""Int8 gradient compression (the port of ``repro/optim/compress.py``).

``compress_int8`` quantizes a gradient to int8 with one float32
per-tensor scale; ``decompress_int8`` undoes it. ``ef_roundtrip`` is the
data-parallel exchange with error feedback (Karimireddy et al., EF-SGD):
the int8 codes of ``g + err`` summed over the ranks in int32, times the
largest rank's scale, over the number of ranks; the quantisation
residual is the next step's ``err``. ``torch.round`` rounds half to
even, as ``jnp.round`` does. Used by ``train.make_compressed_dp_grads``.
"""

from __future__ import annotations

import torch

__all__ = ["compress_int8", "decompress_int8", "ef_roundtrip"]


def compress_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = g.abs().max().float() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_roundtrip(g: torch.Tensor, err: torch.Tensor, group) -> tuple[torch.Tensor, torch.Tensor]:
    """Compress ``g + err``, all-reduce the codes in int32 over ``group``
    (a ``launch.mesh.Comm``) -> (the mean gradient, the new error)."""
    g32 = g.float() + err
    q, scale = compress_int8(g32)
    new_err = g32 - decompress_int8(q, scale)
    total = group.all_reduce(q.to(torch.int32))
    scale = group.all_reduce(scale, "max")
    return total.float() * scale / float(group.size), new_err
