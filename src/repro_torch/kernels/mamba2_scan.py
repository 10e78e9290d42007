"""Mamba2 chunk-state scan on the card: wrapper of ``csrc/mamba2_scan.cu``.

Replaces the TPU kernel ``mamba2_chunk_scan_pallas``
(``repro/kernels/mamba2_scan.py``). The plain versions are
:func:`repro_torch.kernels.ref.mamba2_chunk_scan_ref` and, for the
backward (no TPU counterpart),
:func:`repro_torch.kernels.ref.mamba2_chunk_scan_bwd_ref`; the source's
header says what bounds each kernel on the card.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import mamba2_chunk_scan_ref

__all__ = ["mamba2_chunk_scan_cuda", "mamba2_chunk_scan_bwd_cuda", "mamba2_chunk_scan_ref",
           "launches", "bwd_launches", "MAX_BWD_F"]

#: Kernel launches since the last reset (one per wrapper call).
launches = 0
#: Backward kernel launches since the last reset (one per wrapper call).
bwd_launches = 0
#: Largest F the backward takes: its float32 carry of one head's F
#: elements sits in shared memory.
MAX_BWD_F = 57344

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


def mamba2_chunk_scan_bwd_cuda(decay: torch.Tensor, states: torch.Tensor,
                               g_states: torch.Tensor | None, g_final: torch.Tensor | None):
    """Gradients (g_decay (C, H) float32, g_inc (C, H, F) in the states'
    type) of the scan, from its float32 ``decay``, the ``states`` it
    returned and the gradients of its two outputs (None: zeros), all on
    the card; non-contiguous gradients are copied."""
    global bwd_launches
    if decay.dim() != 2 or states.dim() != 3 or decay.shape != states.shape[:2]:
        raise ValueError(f"expected decay (C,H) and states (C,H,F); got "
                         f"{tuple(decay.shape)}, {tuple(states.shape)}")
    c, h, f = states.shape
    grads = []
    for g, shape in ((g_states, (c, h, f)), (g_final, (h, f))):
        if g is not None:
            if g.shape != shape or g.dtype != states.dtype:
                raise ValueError(f"gradient {tuple(g.shape)} {g.dtype} does not match "
                                 f"{shape} {states.dtype}")
            g = g.contiguous()
        grads.append(g)
    for t in (decay, states, *(g for g in grads if g is not None)):
        if t.device.type != "cuda" or t.device != states.device:
            raise ValueError("decay, states and gradients must lie on one CUDA device")
        if not t.is_contiguous():
            raise ValueError("decay and states must be contiguous")
    if decay.dtype != torch.float32 or states.dtype not in _FNS:
        raise TypeError(f"decay must be float32 and states in {list(_FNS)}; "
                        f"got {decay.dtype}, {states.dtype}")
    if f > MAX_BWD_F:
        raise ValueError(f"F={f} exceeds the backward's {MAX_BWD_F}")
    g_inc = torch.empty_like(states)
    g_decay = torch.zeros_like(decay)
    if h * f == 0 or c == 0:
        return g_decay, g_inc
    fn = getattr(_build.load("mamba2_scan"), "mamba2_scan_bwd_"
                 + ("f32" if states.dtype == torch.float32 else "bf16"))
    fn.argtypes, fn.restype = [_P] * 6 + [ctypes.c_int] * 3 + [_P], ctypes.c_int
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(states.device):
        stream = torch.cuda.current_stream(states.device).cuda_stream
        err = fn(decay.data_ptr(), states.data_ptr(), ptr(grads[0]), ptr(grads[1]),
                 g_inc.data_ptr(), g_decay.data_ptr(), c, h, f, stream)
    if err:
        raise RuntimeError(f"mamba2_chunk_scan backward launch failed: cudaError {err}")
    bwd_launches += 1
    return g_decay, g_inc
