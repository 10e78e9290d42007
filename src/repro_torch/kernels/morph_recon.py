"""Morphological reconstruction on the card: wrapper of
``csrc/morph_recon.cu``.

Replaces the TPU kernels ``morph_recon_step`` / ``morph_recon_pallas``
(``repro/kernels/morph_recon.py``). The plain version is
:func:`repro_torch.kernels.ref.morph_recon_ref`; the source's header
says what bounds the kernel on the card and how the tiles converge.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import morph_recon_ref

__all__ = ["morph_recon_cuda", "morph_recon_step", "morph_recon_ref", "launches"]

#: Kernel launches since the last reset (one per step; a reconstruction
#: takes as many steps as its data needs).
launches = 0

#: Sweeps a block may run inside its tile per launch (it stops earlier
#: once its tile no longer changes).
MAX_SWEEPS = 128

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _P, _P]


def _check(*planes: torch.Tensor) -> None:
    ref = planes[0]
    if ref.dim() != 2:
        raise ValueError(f"expected (H, W) planes, got shape {tuple(ref.shape)}")
    for p in planes:
        if p.device != ref.device or p.device.type != "cuda":
            raise ValueError("planes must lie on one CUDA device")
        if p.shape != ref.shape or p.dtype != torch.float32 or not p.is_contiguous():
            raise ValueError("planes must be contiguous float32 of one shape")


def morph_recon_step(
    marker: torch.Tensor,
    mask: torch.Tensor,
    *,
    out: torch.Tensor | None = None,
    changed: torch.Tensor | None = None,
):
    """One launch: ``(new_marker, changed)``, ``changed`` a (1,) int32
    device tensor that is nonzero unless the step left every pixel of
    ``min(marker, mask)`` as it was (then that is the fixpoint)."""
    global launches
    out = torch.empty_like(mask) if out is None else out
    changed = (
        torch.empty(1, dtype=torch.int32, device=mask.device)
        if changed is None
        else changed
    )
    _check(marker, mask, out)
    if out.data_ptr() in (marker.data_ptr(), mask.data_ptr()):
        raise ValueError("out must not alias the inputs (ping-pong buffers)")
    h, w = int(mask.shape[0]), int(mask.shape[1])
    fn = _build.load("morph_recon").morph_recon_step
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(mask.device):
        stream = torch.cuda.current_stream(mask.device).cuda_stream
        err = fn(
            marker.data_ptr(), mask.data_ptr(), out.data_ptr(), h, w,
            MAX_SWEEPS, changed.data_ptr(), stream,
        )
    if err:
        raise RuntimeError(f"morph_recon launch failed: cudaError {err}")
    launches += 1
    return out, changed


def morph_recon_cuda(marker: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Steps to the global fixpoint, reading the changed flag once per
    launch; two ping-pong buffers, the caller's tensors stay as they are."""
    marker = marker.float().contiguous()
    mask = mask.float().contiguous()
    _check(marker, mask)
    if mask.numel() == 0:
        return torch.minimum(marker, mask)
    bufs = (torch.empty_like(mask), torch.empty_like(mask))
    changed = torch.empty(1, dtype=torch.int32, device=mask.device)
    src, i = marker, 0
    while True:
        dst = bufs[i & 1]
        morph_recon_step(src, mask, out=dst, changed=changed)
        if not int(changed.item()):
            return dst
        src, i = dst, i + 1
