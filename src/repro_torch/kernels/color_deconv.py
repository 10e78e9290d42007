"""Color deconvolution on the card: wrapper of ``csrc/color_deconv.cu``.

Replaces the TPU kernel ``color_deconv_pallas``
(``repro/kernels/color_deconv.py``). The plain version is
:func:`repro_torch.kernels.ref.color_deconv_ref`; the source's header
says what bounds the kernel on the card.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import DECONV_MATRIX, color_deconv_ref

__all__ = ["color_deconv_cuda", "color_deconv_ref", "launches"]

#: Kernel launches since the last reset (one per wrapper call).
launches = 0

_M9 = (ctypes.c_float * 9)(*[float(x) for x in DECONV_MATRIX.reshape(-1)])
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _L, _L, _L, _L, _L, _L, _I, _I, _P, _P, _P, _P, _P]


def _check_planes(*planes: torch.Tensor) -> tuple[int, int]:
    r = planes[0]
    if r.dim() != 2:
        raise ValueError(f"expected (H, W) planes, got shape {tuple(r.shape)}")
    for p in planes:
        if p.device != r.device or p.device.type != "cuda":
            raise ValueError("planes must lie on one CUDA device")
        if p.shape != r.shape or p.dtype != r.dtype:
            raise ValueError("planes differ in shape or dtype")
        if p.dtype not in (torch.uint8, torch.float32):
            raise TypeError(f"unsupported plane dtype {p.dtype}")
    return int(r.shape[0]), int(r.shape[1])


def color_deconv_cuda(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor):
    """(H,W) uint8/float32 planes on the card (any element strides) ->
    ``(hema, eosin, resid)`` contiguous float32 planes."""
    global launches
    h, w = _check_planes(r, g, b)
    out = [torch.empty((h, w), dtype=torch.float32, device=r.device) for _ in range(3)]
    if h == 0 or w == 0:
        return tuple(out)
    lib = _build.load("color_deconv")
    fn = lib.color_deconv_u8 if r.dtype == torch.uint8 else lib.color_deconv_f32
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(
            r.data_ptr(), g.data_ptr(), b.data_ptr(),
            *r.stride(), *g.stride(), *b.stride(), h, w,
            ctypes.cast(_M9, ctypes.c_void_p),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), stream,
        )
    if err:
        raise RuntimeError(f"color_deconv launch failed: cudaError {err}")
    launches += 1
    return tuple(out)
