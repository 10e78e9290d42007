"""Sobel magnitude + moments on the card: wrapper of ``csrc/sobel_stats.cu``.

Replaces the TPU kernel ``sobel_stats_pallas``
(``repro/kernels/sobel_stats.py``). The plain version is
:func:`repro_torch.kernels.ref.sobel_stats_ref`; the source's header
says what bounds the kernel on the card. One launch per call, planned
and merged as :mod:`.feature_fused` does (same strip walk, its own
workspaces); :func:`rows_aligned` picks the kernel's fast path.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .feature_fused import Plan, Workspaces, plan, sm_count
from .ref import sobel_stats_ref

__all__ = ["sobel_stats_cuda", "sobel_stats_ref", "launches", "last_plan", "rows_aligned"]

#: Kernel launches since the last reset (one per wrapper call).
launches = 0

#: The :class:`~.feature_fused.Plan` of the latest launch (None before the first).
last_plan: Plan | None = None

#: Kernel modes of the source: contiguous 16-byte aligned rows, any strides.
ROWS_ALIGNED, STRIDED = 0, 1

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_I, _P, _L, _L, _I, _I, _I, _P, _P, _L, _P, _P, _P]
_lib = None
_workspaces = Workspaces()


def rows_aligned(gray: torch.Tensor) -> bool:
    """True when the plane's rows are contiguous and start 16-byte
    aligned: the kernel then copies each row segment as 16-byte vectors."""
    return gray.stride(1) == 1 and gray.stride(0) % 4 == 0 and gray.data_ptr() % 16 == 0


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("sobel_stats")
        lib.sobel_stats.argtypes, lib.sobel_stats.restype = _ARGTYPES, ctypes.c_int
        _lib = lib
    return _lib


def sobel_stats_cuda(gray: torch.Tensor):
    """(H, W) float32 plane on the card (any element strides) ->
    ``(mag, stats)``: mag contiguous float32, stats the (3,) float32
    ``[sum, sumsq, max]`` of mag. One launch; no host sync."""
    global launches, last_plan
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
    p = plan(h, w, sm_count(dev))
    mode = ROWS_ALIGNED if rows_aligned(gray) else STRIDED
    fn = _load().sobel_stats
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        cnt, part = _workspaces.get(dev, stream, 3 * p.blocks)
        err = fn(mode, gray.data_ptr(), *gray.stride(), h, w, p.rows, mag.data_ptr(),
                 part.data_ptr(), part.numel(), cnt.data_ptr(), stats.data_ptr(), stream)
    if err:
        raise RuntimeError(f"sobel_stats launch failed: cudaError {err}")
    launches += 1
    last_plan = p
    return mag, stats
