"""Fused feature kernel on the card: wrapper of ``csrc/feature_fused.cu``.

Replaces the TPU kernel ``feature_fused_pallas``
(``repro/kernels/feature_fused.py``). The plain version is
:func:`repro_torch.kernels.ref.feature_fused_ref`; the source's header
says what bounds the kernel on the card.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .color_deconv import _check_planes
from .ref import DECONV_MATRIX, feature_fused_ref

__all__ = ["feature_fused_cuda", "feature_fused_ref", "launches"]

#: Wrapper calls that launched the kernel pair (tile pass + the
#: one-block reduction of its partials) since the last reset.
launches = 0

_M6 = (ctypes.c_float * 6)(*[float(x) for x in DECONV_MATRIX[:2].reshape(-1)])
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _L, _L, _L, _L, _L, _L, _I, _I] + [_P] * 7


def feature_fused_cuda(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor):
    """(H,W) uint8/float32 planes on the card (any element strides) ->
    ``(hema, eosin, mag, stats)``; planes contiguous float32, ``stats``
    the (6,) float32 ``[h_sum, h_sumsq, h_max, g_sum, g_sumsq, g_max]``."""
    global launches
    h, w = _check_planes(r, g, b)
    if h == 0 or w == 0:
        raise ValueError("feature_fused needs a non-empty image")
    dev = r.device
    planes = [torch.empty((h, w), dtype=torch.float32, device=dev) for _ in range(3)]
    stats = torch.empty(6, dtype=torch.float32, device=dev)
    lib = _build.load("feature_fused")
    nblk = lib.feature_fused_num_blocks
    nblk.argtypes, nblk.restype = [_I, _I], ctypes.c_longlong
    partials = torch.empty((int(nblk(h, w)), 6), dtype=torch.float32, device=dev)
    fn = lib.feature_fused_u8 if r.dtype == torch.uint8 else lib.feature_fused_f32
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            r.data_ptr(), g.data_ptr(), b.data_ptr(),
            *r.stride(), *g.stride(), *b.stride(), h, w,
            ctypes.cast(_M6, ctypes.c_void_p),
            planes[0].data_ptr(), planes[1].data_ptr(), planes[2].data_ptr(),
            partials.data_ptr(), stats.data_ptr(), stream,
        )
    if err:
        raise RuntimeError(f"feature_fused launch failed: cudaError {err}")
    launches += 1
    return planes[0], planes[1], planes[2], stats
