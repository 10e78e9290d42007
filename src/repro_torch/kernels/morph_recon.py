"""Morphological reconstruction on the card: wrapper of
``csrc/morph_recon.cu``.

Replaces the TPU kernels ``morph_recon_step`` / ``morph_recon_pallas``
(``repro/kernels/morph_recon.py``). The plain version is
:func:`repro_torch.kernels.ref.morph_recon_ref`. One cooperative,
persistent launch computes a whole reconstruction on the card; the
host never waits on it. The source's header says what bounds the
kernel, how its dirty-tile rounds go and why the result is exact.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import morph_recon_ref

__all__ = ["morph_recon_cuda", "morph_recon_step", "morph_recon_ref", "launches"]

#: Kernel launches since the last reset: one per reconstruction (and
#: one per :func:`morph_recon_step`).
launches = 0

#: ``(rounds, tile visits, in-tile sweeps)`` of the last launch, an
#: int32 tensor on the card that the kernel fills in; read it only after
#: the work is done (the wrapper never reads it).
last_stats: torch.Tensor | None = None

#: Sweeps a block may run inside its tile per visit (it stops earlier
#: once its tile no longer changes; a tile stopped at the cap is
#: visited again in the next round).
MAX_SWEEPS = 128

#: Tile of one block, as in the source (its tile visits count these).
TILE_H, TILE_W = 32, 64

_NO_ROUND_CAP = 2**31 - 1
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]


def _check(*planes: torch.Tensor) -> None:
    ref = planes[0]
    if ref.dim() != 2:
        raise ValueError(f"expected (H, W) planes, got shape {tuple(ref.shape)}")
    for p in planes:
        if p.device != ref.device or p.device.type != "cuda":
            raise ValueError("planes must lie on one CUDA device")
        if p.shape != ref.shape or p.dtype != torch.float32 or not p.is_contiguous():
            raise ValueError("planes must be contiguous float32 of one shape")


def _launch(marker: torch.Tensor, mask: torch.Tensor, out: torch.Tensor,
            max_rounds: int) -> torch.Tensor:
    """One cooperative launch; returns its int32 workspace (rounds,
    visits, sweeps, changed, ...). A refused launch raises."""
    global launches, last_stats
    h, w = int(mask.shape[0]), int(mask.shape[1])
    lib = _build.load("morph_recon")
    lib.morph_recon_ws_ints.argtypes, lib.morph_recon_ws_ints.restype = [_I, _I], _I
    ws_ints = lib.morph_recon_ws_ints(h, w)
    ws = torch.zeros(ws_ints, dtype=torch.int32, device=mask.device)
    fn = lib.morph_recon_run
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(mask.device):
        stream = torch.cuda.current_stream(mask.device).cuda_stream
        err = fn(
            marker.data_ptr(), mask.data_ptr(), out.data_ptr(), ws.data_ptr(), ws_ints,
            h, w, MAX_SWEEPS, max_rounds, stream,
        )
    if err:
        raise RuntimeError(f"morph_recon cooperative launch failed: cudaError {err}")
    launches += 1
    last_stats = ws[:3]
    return ws


def morph_recon_step(
    marker: torch.Tensor,
    mask: torch.Tensor,
    *,
    out: torch.Tensor | None = None,
):
    """One round of the kernel (its round 0): every tile runs up to
    ``MAX_SWEEPS`` sweeps of ``min(marker, mask)`` with its halo held at
    ``min(marker, mask)``. Returns ``(new_marker, changed)``, ``changed`` a
    (1,) int32 device tensor that is nonzero unless the step left every
    pixel of ``min(marker, mask)`` as it was (then that is the fixpoint)."""
    out = torch.empty_like(mask) if out is None else out
    _check(marker, mask, out)
    if out.data_ptr() in (marker.data_ptr(), mask.data_ptr()):
        raise ValueError("out must not alias the inputs")
    if mask.numel() == 0:
        return out, torch.zeros(1, dtype=torch.int32, device=mask.device)
    ws = _launch(marker, mask, out, 1)
    return out, ws[3:4]


def morph_recon_cuda(marker: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The reconstruction to its fixpoint in one launch, into a new
    plane; the caller's tensors stay as they are. Issues the launch and
    returns without waiting."""
    marker = marker.float().contiguous()
    mask = mask.float().contiguous()
    _check(marker, mask)
    if mask.numel() == 0:
        return torch.minimum(marker, mask)
    out = torch.empty_like(mask)
    _launch(marker, mask, out, _NO_ROUND_CAP)
    return out
