"""Decode attention on the card: wrapper of ``csrc/decode_attention.cu``.

Replaces the TPU kernel ``decode_attention_pallas``
(``repro/kernels/decode_attention.py``). The plain version is
:func:`repro_torch.kernels.ref.decode_attention_ref`; the source's
header says what bounds the kernel on the card.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .ref import decode_attention_ref

__all__ = ["decode_attention_cuda", "decode_attention_ref", "launches", "HEAD_DIMS"]

#: Wrapper calls that launched the kernel pair (per-split pass + the
#: combine of the splits) since the last reset.
launches = 0

#: Head dims the kernel is instantiated for.
HEAD_DIMS = (32, 64, 128)
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 7 + [_I] * 5 + [ctypes.c_float, _P]
_FNS = {torch.float32: "decode_attention_f32", torch.bfloat16: "decode_attention_bf16"}


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """q (B, Hq, D), k/v (B, Hkv, S, D), lengths (B,) int32, all on the
    card and contiguous; q, k, v float32 or bfloat16 (one type), Hq a
    multiple of Hkv, D in :data:`HEAD_DIMS`, any S. Positions
    ``< lengths[b]`` attend (clamped to [0, S]; a length of 0 gives
    zeros) -> (B, Hq, D) in q's type."""
    global launches
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B,Hq,D) and k, v (B,Hkv,S,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do not match")
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be (B,) int32; got {tuple(lengths.shape)} {lengths.dtype}")
    for t in (q, k, v, lengths):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError("q, k, v, lengths must lie on one CUDA device")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("q, k, v, lengths must be contiguous and 16-byte aligned")
    for t in (q, k, v):
        if t.dtype != q.dtype or t.dtype not in _FNS:
            raise TypeError(f"q, k, v must share a dtype in {list(_FNS)}; got {t.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    out = torch.empty_like(q)
    if q.numel() == 0 or s == 0:
        return out.zero_()
    lib = _build.load("decode_attention")
    splits_fn = lib.decode_attention_splits
    splits_fn.argtypes, splits_fn.restype = [_I], _I
    splits = int(splits_fn(s))
    part_o = torch.empty((b, hq, splits, d), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((b, hq, splits, 2), dtype=torch.float32, device=q.device)
    fn = getattr(lib, _FNS[q.dtype])
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                 out.data_ptr(), part_o.data_ptr(), part_ml.data_ptr(),
                 b, hq, hkv, s, d, 1.0 / math.sqrt(d), stream)
    if err:
        raise RuntimeError(f"decode_attention launch failed: cudaError {err}")
    launches += 1
    return out
