"""Flash attention on the card: wrapper of ``csrc/flash_attention.cu``.

Replaces the TPU kernel ``flash_attention_pallas``
(``repro/kernels/flash_attention.py``). The plain version is
:func:`repro_torch.kernels.ref.flash_attention_ref`; the source's header
says what bounds the kernel on the card.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .ref import flash_attention_ref

__all__ = ["flash_attention_cuda", "flash_attention_ref", "launches", "HEAD_DIMS"]

#: Kernel launches since the last reset (one per wrapper call).
launches = 0

#: Head dims the kernel is instantiated for.
HEAD_DIMS = (32, 64, 128)
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P]
_FNS = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """q (B, H, S, D), k/v (B, Hkv, S, D) on the card, contiguous,
    float32 or bfloat16 (all one type), H a multiple of Hkv, D in
    :data:`HEAD_DIMS`, any S -> (B, H, S, D) in q's type. bfloat16
    tensors must start 16-byte aligned (the kernel copies 16-byte
    chunks with ``cp.async``)."""
    global launches
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B,H,S,D) and k, v (B,Hkv,S,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, d = q.shape
    hkv = k.shape[1]
    if k.shape[0] != b or k.shape[2] != s or k.shape[3] != d or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do not match")
    for t in (q, k, v):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError("q, k, v must lie on one CUDA device")
        if t.dtype != q.dtype or t.dtype not in _FNS:
            raise TypeError(f"q, k, v must share a dtype in {list(_FNS)}; got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("q, k, v must be contiguous")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("bfloat16 q, k, v must start 16-byte aligned")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    fn = getattr(_build.load("flash_attention"), _FNS[q.dtype])
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, h, hkv, s, d, 1.0 / math.sqrt(d), int(causal), stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    launches += 1
    return out
