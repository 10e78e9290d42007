"""Mamba2 chunk-state scan on the card: wrapper of ``csrc/mamba2_scan.cu``.

Replaces the TPU kernel ``mamba2_chunk_scan_pallas``
(``repro/kernels/mamba2_scan.py``). The plain versions are
:func:`repro_torch.kernels.ref.mamba2_chunk_scan_ref` and, for the
backward (no TPU counterpart),
:func:`repro_torch.kernels.ref.mamba2_chunk_scan_bwd_ref`; the source's
header says what bounds each kernel on the card. The backward is one
launch that splits F across blocks and merges g_decay inside it, through
workspaces (int32 counters, float32 partial sums) that the wrapper keeps
per device and stream and grows when a larger shape needs them;
:func:`bwd_plan` is the host's choice of its instantiation and grid.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _build
from .feature_fused import Workspaces
from .ref import mamba2_chunk_scan_ref

__all__ = ["mamba2_chunk_scan_cuda", "mamba2_chunk_scan_bwd_cuda", "mamba2_chunk_scan_ref",
           "launches", "bwd_launches", "last_bwd_plan", "BwdPlan", "bwd_plan"]

#: Kernel launches since the last reset (one per wrapper call).
launches = 0
#: Backward kernel launches since the last reset (one per wrapper call).
bwd_launches = 0
#: The :class:`BwdPlan` of the latest backward launch (None before the first).
last_bwd_plan: BwdPlan | None = None

#: The backward's threads a block and elements a thread, as in the
#: source (``BWD_THREADS``, ``BWD_ELEMS``): a block covers a span of
#: ``BWD_THREADS * BWD_ELEMS`` elements of one head's row.
BWD_THREADS = 128
BWD_ELEMS = 8

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, _P]
_FNS = {torch.float32: "mamba2_scan_f32", torch.bfloat16: "mamba2_scan_bf16"}
_BWD_FNS = {torch.float32: "mamba2_scan_bwd_f32", torch.bfloat16: "mamba2_scan_bwd_bf16"}
_BWD_ARGTYPES = [_P] * 8 + [ctypes.c_int] * 5 + [_P]
_workspaces = Workspaces()


@dataclass(frozen=True)
class BwdPlan:
    """The backward's launch: blocks of ``threads`` threads, each thread
    ``k`` vectors of ``vec`` elements (16 bytes, or 1 element where a row
    is not 16-byte aligned), ``splits`` blocks of ``span`` elements per
    head's row of ``f``; grid ``splits * h`` blocks."""

    c: int
    h: int
    f: int
    vec: int
    k: int
    threads: int
    span: int
    splits: int

    @property
    def warps(self) -> int:
        return self.threads // 32

    @property
    def blocks(self) -> int:
        return self.splits * self.h

    @property
    def counters(self) -> int:
        """int32 counters: one per head."""
        return self.h

    @property
    def partials(self) -> int:
        """float32 partial sums of g_decay: one per (chunk, head, split, warp)."""
        return self.c * self.h * self.splits * self.warps


def bwd_plan(c: int, h: int, f: int, dtype: torch.dtype, aligned: bool = True) -> BwdPlan:
    """The backward's instantiation and grid for (C, H, F) states of
    ``dtype``: 16-byte vectors when every row starts 16-byte aligned
    (``aligned``: the tensors' pointers are, and F is a multiple of the
    vector), else one element a vector; F split into spans of
    ``BWD_THREADS * BWD_ELEMS`` elements."""
    wide = 16 // torch.empty((), dtype=dtype).element_size()
    vec = wide if aligned and f % wide == 0 else 1
    span = BWD_THREADS * BWD_ELEMS
    return BwdPlan(c, h, f, vec, BWD_ELEMS // vec, BWD_THREADS, span, max(1, -(-f // span)))


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
    the card; non-contiguous gradients are copied. One launch (see
    :func:`bwd_plan`); no host sync."""
    global bwd_launches, last_bwd_plan
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
    g_inc = torch.empty_like(states)
    g_decay = torch.empty_like(decay)  # the kernel writes every element
    if h * f == 0 or c == 0:
        return g_decay.zero_(), g_inc
    vectors = (states, g_inc, *(g for g in grads if g is not None))
    p = bwd_plan(c, h, f, states.dtype, aligned=all(t.data_ptr() % 16 == 0 for t in vectors))
    fn = getattr(_build.load("mamba2_scan"), _BWD_FNS[states.dtype])
    fn.argtypes, fn.restype = _BWD_ARGTYPES, ctypes.c_int
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    dev = states.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        cnt, part = _workspaces.get(dev, stream, p.partials, p.counters)
        err = fn(decay.data_ptr(), states.data_ptr(), ptr(grads[0]), ptr(grads[1]),
                 g_inc.data_ptr(), g_decay.data_ptr(), cnt.data_ptr(), part.data_ptr(),
                 c, h, f, p.vec, p.splits, stream)
    if err:
        raise RuntimeError(f"mamba2_chunk_scan backward launch failed: cudaError {err}")
    bwd_launches += 1
    last_bwd_plan = p
    return g_decay, g_inc
