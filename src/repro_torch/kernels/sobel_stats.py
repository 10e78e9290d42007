"""Sobel magnitude + moments on the card: wrapper of ``csrc/sobel_stats.cu``.

Replaces the TPU kernel ``sobel_stats_pallas``
(``repro/kernels/sobel_stats.py``). The plain version is
:func:`repro_torch.kernels.ref.sobel_stats_ref`; the source's header
says what bounds the kernel on the card.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import sobel_stats_ref

__all__ = ["sobel_stats_cuda", "sobel_stats_ref", "launches"]

#: Wrapper calls that launched the kernel pair (tile pass + the
#: one-block reduction of its partials) since the last reset.
launches = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _L, _L, _I, _I, _P, _P, _P, _P]


def sobel_stats_cuda(gray: torch.Tensor):
    """(H, W) float32 plane on the card (any element strides) ->
    ``(mag, stats)``: mag contiguous float32, stats the (3,) float32
    ``[sum, sumsq, max]`` of mag."""
    global launches
    if gray.dim() != 2:
        raise ValueError(f"expected an (H, W) plane, got shape {tuple(gray.shape)}")
    if gray.device.type != "cuda":
        raise ValueError("gray must lie on a CUDA device")
    if gray.dtype != torch.float32:
        raise TypeError(f"gray must be float32, got {gray.dtype}")
    h, w = int(gray.shape[0]), int(gray.shape[1])
    if h == 0 or w == 0:
        raise ValueError("sobel_stats needs a non-empty plane")
    dev = gray.device
    mag = torch.empty((h, w), dtype=torch.float32, device=dev)
    stats = torch.empty(3, dtype=torch.float32, device=dev)
    lib = _build.load("sobel_stats")
    nblk = lib.sobel_stats_num_blocks
    nblk.argtypes, nblk.restype = [_I, _I], ctypes.c_longlong
    partials = torch.empty((int(nblk(h, w)), 3), dtype=torch.float32, device=dev)
    fn = lib.sobel_stats_f32
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(gray.data_ptr(), *gray.stride(), h, w, mag.data_ptr(),
                 partials.data_ptr(), stats.data_ptr(), stream)
    if err:
        raise RuntimeError(f"sobel_stats launch failed: cudaError {err}")
    launches += 1
    return mag, stats
