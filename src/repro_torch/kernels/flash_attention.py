"""Flash attention on the card: wrapper of ``csrc/flash_attention.cu``.

Replaces the TPU kernel ``flash_attention_pallas``
(``repro/kernels/flash_attention.py``). The plain versions are
:func:`repro_torch.kernels.ref.flash_attention_ref` (forward, with
``flash_attention_fwd_ref`` also giving the log-sum-exp) and
:func:`repro_torch.kernels.ref.flash_attention_bwd_ref` (backward, which
has no TPU counterpart); the source's header says what bounds each
kernel on the card.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .ref import flash_attention_ref

__all__ = ["flash_attention_cuda", "flash_attention_bwd_cuda", "flash_attention_ref",
           "launches", "bwd_launches", "bwd_kernels", "HEAD_DIMS"]

#: Forward kernel launches since the last reset (one per wrapper call).
launches = 0
#: Backward kernel launches since the last reset: :func:`bwd_kernels`
#: per wrapper call.
bwd_launches = 0

#: Head dims the kernel is instantiated for.
HEAD_DIMS = (32, 64, 128)
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _I, _P]
_BWD_ARGTYPES = [_P] * 12 + [_I] * 5 + [ctypes.c_float, _I, _P]
_FNS = {torch.float32: "flash_attention_f32", torch.bfloat16: "flash_attention_bf16"}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *more: torch.Tensor) -> None:
    """Shapes, device, type, layout and 16-byte alignment of q, k, v and
    of ``more`` tensors shaped like q."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B,H,S,D) and k, v (B,Hkv,S,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, d = q.shape
    hkv = k.shape[1]
    if k.shape[0] != b or k.shape[2] != s or k.shape[3] != d or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do not match")
    for t in more:
        if t.shape != q.shape:
            raise ValueError(f"expected {tuple(q.shape)} like q; got {tuple(t.shape)}")
    for t in (q, k, v, *more):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError("q, k, v must lie on one CUDA device")
        if t.dtype != q.dtype or t.dtype not in _FNS:
            raise TypeError(f"q, k, v must share a dtype in {list(_FNS)}; got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("q, k, v must be contiguous")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if any(t.data_ptr() % 16 for t in (q, k, v, *more)):
        raise ValueError(f"{str(q.dtype).removeprefix('torch.')} q, k, v must start "
                         "16-byte aligned")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, return_lse: bool = False):
    """q (B, H, S, D), k/v (B, Hkv, S, D) on the card, contiguous,
    float32 or bfloat16 (all one type), H a multiple of Hkv, D in
    :data:`HEAD_DIMS`, any S -> (B, H, S, D) in q's type, and with
    ``return_lse`` also the float32 log-sum-exp of each row (B, H, S)
    that the backward needs. The tensors must start 16-byte aligned
    (both forward kernels copy 16-byte chunks with ``cp.async``): a
    misaligned one raises. float32 runs three-pass TF32 on the tensor
    cores, bfloat16 bf16 products; both accumulate in float32."""
    global launches
    _check(q, k, v)
    b, h, s, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if return_lse else None
    if q.numel() == 0:
        return (out, lse) if return_lse else out
    fn = getattr(_build.load("flash_attention"), _FNS[q.dtype])
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if return_lse else None,
                 b, h, k.shape[1], s, d, 1.0 / math.sqrt(d), int(causal), stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: cudaError {err}")
    launches += 1
    return (out, lse) if return_lse else out


def bwd_kernels(dtype: torch.dtype, group: int) -> int:
    """Kernels one backward call launches, float32 or bfloat16: two (dQ
    with the row sums, dK/dV), and a third that sums the float32 partials
    of a query group when ``group`` > 1."""
    return 2 if group == 1 else 3


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                             causal: bool = True):
    """Gradients (dq, dk, dv) of the attention ``out`` = flash(q, k, v)
    given its float32 row log-sum-exp ``lse`` (B, H, S) and the output's
    gradient ``dout``, each in its input's type; dk and dv sum over the
    query heads that share a KV head. Same layout rules as the forward;
    a non-contiguous ``dout`` is copied. With more than one query head
    per KV head, two float32 (B, H, S, D) scratch tensors hold each
    head's dK and dV partials. float32 runs three-pass TF32 on the tensor
    cores, bfloat16 bf16 products; both accumulate in float32."""
    global bwd_launches
    dout = dout.contiguous()
    _check(q, k, v, out, dout)
    b, h, s, d = q.shape
    if lse.shape != (b, h, s) or lse.dtype != torch.float32 or lse.device != q.device:
        raise ValueError(f"lse must be float32 {(b, h, s)} on {q.device}")
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    hkv = k.shape[1]
    dvec = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    # float32 dK, dV partials per query head, summed by group
    partials = [torch.empty(q.shape, dtype=torch.float32, device=q.device) if h != hkv
                else None for _ in range(2)]
    ptrs = [q, k, v, out, lse, dout, dvec, dq, dk, dv, *partials]
    fn = getattr(_build.load("flash_attention"), "flash_attention_bwd_"
                 + ("f32" if q.dtype == torch.float32 else "bf16"))
    fn.argtypes, fn.restype = _BWD_ARGTYPES, ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*(None if t is None else t.data_ptr() for t in ptrs), b, h, hkv, s, d,
                 1.0 / math.sqrt(d), int(causal), stream)
    if err:
        raise RuntimeError(f"flash_attention backward launch failed: cudaError {err}")
    bwd_launches += bwd_kernels(q.dtype, h // hkv)
    return dq, dk, dv
