"""Fused feature kernel on the card: wrapper of ``csrc/feature_fused.cu``.

Replaces the TPU kernel ``feature_fused_pallas``
(``repro/kernels/feature_fused.py``). The plain version is
:func:`repro_torch.kernels.ref.feature_fused_ref`; the source's header
says what bounds the kernel on the card. One launch per call: the
blocks' moments merge inside it, through workspaces (an int32 counter,
float32 partial moments) that the wrapper keeps per device and stream.
:func:`plan` is the host's choice of blocks, shared with
:mod:`.sobel_stats`; :func:`interleaved` picks the kernel's fast path.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _build
from .color_deconv import _check_planes
from .ref import DECONV_MATRIX, feature_fused_ref

__all__ = ["feature_fused_cuda", "feature_fused_ref", "launches", "last_plan",
           "Plan", "plan", "interleaved", "Workspaces"]

#: Kernel launches since the last reset (one per wrapper call).
launches = 0

#: The :class:`Plan` of the latest launch (None before the first).
last_plan: Plan | None = None

#: Strip width in pixels, rows one step converts, as in
#: ``csrc/strip_stencil.cuh`` (``TW``, ``RPS``).
STRIP_W = 256
ROWS_PER_STEP = 4

#: Blocks per SM the plan aims at (the source's launch bounds ask the
#: compiler for registers that let this many reside at once): all
#: blocks of a large image in one wave.
BLOCKS_PER_SM = 4

#: Fewest rows a block walks: below this the halo rows (2 per block)
#: and the ring's fill cost more than the parallelism gains.
MIN_ROWS = 32

#: Kernel modes of the source: one HWC uint8 buffer, uint8 planes,
#: float32 planes.
INTERLEAVED, PLANAR_U8, PLANAR_F32 = 0, 1, 2

_M6 = (ctypes.c_float * 6)(*[float(x) for x in DECONV_MATRIX[:2].reshape(-1)])
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_I, _P, _P, _P] + [_L] * 6 + [_I] * 3 + [_P] * 5 + [_L, _P, _P, _P]
_lib = None
_sm_counts: dict[int, int] = {}


@dataclass(frozen=True)
class Plan:
    """The launch of one call: ``strips`` x ``segments`` blocks, each
    walking ``rows`` rows of a ``STRIP_W``-pixel strip."""

    strips: int
    segments: int
    rows: int

    @property
    def blocks(self) -> int:
        return self.strips * self.segments


def plan(h: int, w: int, sm_count: int) -> Plan:
    """Blocks for an (h, w) image, from the shape and the SM count only:
    strips of ``STRIP_W`` columns, cut into runs of ``rows`` rows (a
    multiple of ``ROWS_PER_STEP``, at least ``MIN_ROWS``) so that there
    are at most ``BLOCKS_PER_SM`` blocks per SM where the image allows."""
    strips = -(-w // STRIP_W)
    per_block = -(-h * strips // (BLOCKS_PER_SM * sm_count))
    rows = max(MIN_ROWS, -(-per_block // ROWS_PER_STEP) * ROWS_PER_STEP)
    return Plan(strips, -(-h // rows), rows)


def interleaved(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> bool:
    """True when r, g, b are the channel views ``rgb[..., 0..2]`` of one
    HWC uint8 buffer whose rows start 16-byte aligned: the kernel then
    copies each row segment as 16-byte vectors and de-interleaves it in
    shared memory."""
    p = r.data_ptr()
    return (r.dtype == g.dtype == b.dtype == torch.uint8
            and g.data_ptr() == p + 1 and b.data_ptr() == p + 2
            and r.stride() == g.stride() == b.stride()
            and r.stride(1) == 3 and r.stride(0) % 16 == 0 and p % 16 == 0)


class Workspaces:
    """Per (device, stream): int32 counters zeroed when made (every
    launch leaves them 0, and nothing else is stored there) and a
    float32 buffer of partial sums, each grown when a plan needs more."""

    def __init__(self):
        self._by_key: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}

    def get(self, device: torch.device, stream: int, floats: int, counters: int = 1):
        key = (device.index, stream)
        cnt, part = self._by_key.get(key, (None, None))
        if cnt is None or cnt.numel() < counters:
            cnt = torch.zeros(counters if cnt is None else max(counters, 2 * cnt.numel()),
                              dtype=torch.int32, device=device)
        if part is None or part.numel() < floats:
            part = torch.empty(floats if part is None else max(floats, 2 * part.numel()),
                               dtype=torch.float32, device=device)
        self._by_key[key] = (cnt, part)
        return cnt, part


_workspaces = Workspaces()


def sm_count(device: torch.device) -> int:
    n = _sm_counts.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _sm_counts[device.index] = n
    return n


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("feature_fused")
        lib.feature_fused.argtypes, lib.feature_fused.restype = _ARGTYPES, ctypes.c_int
        _lib = lib
    return _lib


def feature_fused_cuda(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor):
    """(H,W) uint8/float32 planes on the card (any element strides) ->
    ``(hema, eosin, mag, stats)``; planes contiguous float32, ``stats``
    the (6,) float32 ``[h_sum, h_sumsq, h_max, g_sum, g_sumsq, g_max]``.
    One launch; no host sync."""
    global launches, last_plan
    h, w = _check_planes(r, g, b)
    if h == 0 or w == 0:
        raise ValueError("feature_fused needs a non-empty image")
    dev = r.device
    planes = [torch.empty((h, w), dtype=torch.float32, device=dev) for _ in range(3)]
    stats = torch.empty(6, dtype=torch.float32, device=dev)
    p = plan(h, w, sm_count(dev))
    if interleaved(r, g, b):
        mode = INTERLEAVED
    else:
        mode = PLANAR_U8 if r.dtype == torch.uint8 else PLANAR_F32
    fn = _load().feature_fused
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        cnt, part = _workspaces.get(dev, stream, 6 * p.blocks)
        err = fn(
            mode, r.data_ptr(), g.data_ptr(), b.data_ptr(),
            *r.stride(), *g.stride(), *b.stride(), h, w, p.rows,
            ctypes.cast(_M6, ctypes.c_void_p),
            planes[0].data_ptr(), planes[1].data_ptr(), planes[2].data_ptr(),
            part.data_ptr(), part.numel(), cnt.data_ptr(), stats.data_ptr(), stream,
        )
    if err:
        raise RuntimeError(f"feature_fused launch failed: cudaError {err}")
    launches += 1
    last_plan = p
    return planes[0], planes[1], planes[2], stats
