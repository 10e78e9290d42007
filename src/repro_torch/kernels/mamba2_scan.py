"""Mamba2 chunk-state scan on the card: wrapper of ``csrc/mamba2_scan.cu``.

Replaces the TPU kernel ``mamba2_chunk_scan_pallas``
(``repro/kernels/mamba2_scan.py``). The plain version is
:func:`repro_torch.kernels.ref.mamba2_chunk_scan_ref`; the source's
header says what bounds the kernel on the card.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import mamba2_chunk_scan_ref

__all__ = ["mamba2_chunk_scan_cuda", "mamba2_chunk_scan_ref", "launches"]

#: Kernel launches since the last reset (one per wrapper call).
launches = 0

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, _P]
_FNS = {torch.float32: "mamba2_scan_f32", torch.bfloat16: "mamba2_scan_bf16"}


def mamba2_chunk_scan_cuda(decay: torch.Tensor, inc: torch.Tensor):
    """decay (C, H) float32, inc (C, H, F) float32 or bfloat16, both on
    the card and contiguous -> (states entering each chunk (C, H, F),
    final state (H, F)), in inc's type."""
    global launches
    if decay.dim() != 2 or inc.dim() != 3 or decay.shape != inc.shape[:2]:
        raise ValueError(f"expected decay (C,H) and inc (C,H,F); got "
                         f"{tuple(decay.shape)}, {tuple(inc.shape)}")
    for t in (decay, inc):
        if t.device.type != "cuda" or t.device != inc.device:
            raise ValueError("decay and inc must lie on one CUDA device")
        if not t.is_contiguous():
            raise ValueError("decay and inc must be contiguous")
    if decay.dtype != torch.float32 or inc.dtype not in _FNS:
        raise TypeError(f"decay must be float32 and inc in {list(_FNS)}; "
                        f"got {decay.dtype}, {inc.dtype}")
    c, h, f = inc.shape
    states = torch.empty_like(inc)
    final = torch.zeros((h, f), dtype=inc.dtype, device=inc.device)
    if h * f == 0 or c == 0:
        return states, final
    fn = getattr(_build.load("mamba2_scan"), _FNS[inc.dtype])
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(inc.device):
        stream = torch.cuda.current_stream(inc.device).cuda_stream
        err = fn(decay.data_ptr(), inc.data_ptr(), states.data_ptr(), final.data_ptr(),
                 c, h, f, stream)
    if err:
        raise RuntimeError(f"mamba2_chunk_scan launch failed: cudaError {err}")
    launches += 1
    return states, final
