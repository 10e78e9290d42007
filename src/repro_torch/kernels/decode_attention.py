"""Decode attention on the card: wrapper of ``csrc/decode_attention.cu``.

Replaces the TPU kernel ``decode_attention_pallas``
(``repro/kernels/decode_attention.py``). The plain version is
:func:`repro_torch.kernels.ref.decode_attention_ref`; the source's
header says what bounds the kernel on the card. One launch per call:
the splits of the cache length are combined inside it, through
workspaces (int32 counters, float32 partial results) that the wrapper
keeps per device and stream and grows when a larger shape needs them.
:func:`plan` is the host's choice of splits. With ``return_lse`` the
same launch also writes each row's log-sum-exp (natural log, float32,
-inf for a length of 0), by which the partial results of ranks that
each hold one chunk of a cache's sequence merge
(``launch/spmd.merge_partials``).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from . import _build
from .ref import decode_attention_ref

__all__ = ["decode_attention_cuda", "decode_attention_ref", "launches", "last_plan",
           "HEAD_DIMS", "Plan", "plan"]

#: Kernel launches since the last reset (one per wrapper call).
launches = 0

#: The :class:`Plan` of the latest launch (None before the first).
last_plan: Plan | None = None

#: Head dims the kernel is instantiated for.
HEAD_DIMS = (32, 64, 128)

#: Warps per block, and the bytes of K (and of V) in one warp tile, as
#: in the source: a warp tile holds ``TILE_BYTES // (D * itemsize)`` keys.
WARPS = 4
TILE_BYTES = 4096

#: Query heads one block serves: float32 (CUDA cores) takes the least of
#: these that holds the group (the source's instantiations), bfloat16
#: (tensor cores) up to ``MMA_ROWS``, the rows of one mma. A larger
#: group is cut into chunks of the most.
HEADS_PER_BLOCK = (1, 2, 4, 8)
MMA_ROWS = 16

#: Blocks per SM the split choice aims at when every sequence fills the
#: cache: enough that the splits of short sequences, which return at
#: once, still leave the SMs blocks of real work, and few enough that a
#: warp has several tiles to pipeline (4 ran faster than 8 and 16 on both
#: timed shapes; PERF.md, the decode_attention variants).
BLOCKS_PER_SM = 4

#: Most splits of one cache, as in the source (the last block's merge
#: keeps every split's max and sum in shared memory).
MAX_SPLITS = 256

_P, _I = ctypes.c_void_p, ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = [_P] * 7 + [_L, _P, _L] + [_I] * 8 + [ctypes.c_float, _P]
_FNS = {torch.float32: "decode_attention_f32", torch.bfloat16: "decode_attention_bf16"}
_lib = None
_workspaces: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}
_sm_counts: dict[int, int] = {}


@dataclass(frozen=True)
class Plan:
    """The launch of one call: ``heads`` query heads per block (the
    partial results' layout) in ``head_chunks`` chunks per KV head; warp tiles of ``tile_keys`` keys;
    ``splits`` splits of ``split_keys`` keys (whole rounds of
    ``WARPS`` tiles) covering the cache length."""

    batch: int
    kv_heads: int
    head_dim: int
    heads: int
    head_chunks: int
    tile_keys: int
    split_keys: int
    splits: int

    @property
    def blocks(self) -> int:
        return self.splits * self.kv_heads * self.head_chunks * self.batch

    @property
    def counters(self) -> int:
        """int32 counters: one per (batch row, KV head, head chunk)."""
        return self.batch * self.kv_heads * self.head_chunks

    @property
    def partials(self) -> int:
        """float32 partial results: (max, sum) and the accumulator per
        (split, counter, head)."""
        return self.counters * self.splits * self.heads * (2 + self.head_dim)


def plan(batch: int, q_heads: int, kv_heads: int, seq: int, head_dim: int, itemsize: int,
         sm_count: int) -> Plan:
    """Splits of a cache of ``seq`` keys, from the shapes and the SM
    count only (never the lengths): as many as give ``BLOCKS_PER_SM``
    blocks per SM if every sequence were full, but no split shorter than
    one round of ``WARPS`` warp tiles and at most ``MAX_SPLITS``."""
    group = q_heads // kv_heads
    if itemsize == 2:
        heads = min(group, MMA_ROWS)
    else:
        heads = next(n for n in HEADS_PER_BLOCK if n >= min(group, HEADS_PER_BLOCK[-1]))
    chunks = -(-group // heads)
    tile = TILE_BYTES // (head_dim * itemsize)
    rnd = WARPS * tile
    want = -(-BLOCKS_PER_SM * sm_count // (batch * kv_heads * chunks))
    splits = max(1, min(want, MAX_SPLITS, -(-seq // rnd)))
    split_keys = -(-(-(-seq // splits)) // rnd) * rnd
    return Plan(batch, kv_heads, head_dim, heads, chunks, tile, split_keys, -(-seq // split_keys))


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("decode_attention")
        for name in _FNS.values():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        _lib = lib
    return _lib


def _grown(t: torch.Tensor | None, need: int) -> int:
    return need if t is None else max(need, 2 * t.numel())


def _workspace(p: Plan, device: torch.device, stream: int):
    """``(counters, partials)`` of ``stream`` on ``device``: int32
    counters zeroed when made (every launch leaves them 0, and nothing
    else is stored there) and float32 partials, each grown when ``p``
    needs more."""
    key = (device.index, stream)
    cnt, part = _workspaces.get(key, (None, None))
    if cnt is None or cnt.numel() < p.counters:
        cnt = torch.zeros(_grown(cnt, p.counters), dtype=torch.int32, device=device)
    if part is None or part.numel() < p.partials:
        part = torch.empty(_grown(part, p.partials), dtype=torch.float32, device=device)
    _workspaces[key] = (cnt, part)
    return cnt, part


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lengths: torch.Tensor, return_lse: bool = False):
    """q (B, Hq, D), k/v (B, Hkv, S, D), lengths (B,) int32, all on the
    card and contiguous; q, k, v float32 or bfloat16 (one type), Hq a
    multiple of Hkv, D in :data:`HEAD_DIMS`, any S. Positions
    ``< lengths[b]`` attend (clamped to [0, S]; a length of 0 gives
    zeros) -> (B, Hq, D) in q's type; with ``return_lse`` also the
    (B, Hq) float32 log-sum-exp of each row's scaled scores (-inf for a
    length of 0). One launch; no host sync."""
    global launches, last_plan
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
    lse = torch.empty((b, hq), dtype=torch.float32, device=q.device) if return_lse else None
    if q.numel() == 0 or s == 0:
        out.zero_()
        return (out, lse.fill_(float("-inf"))) if return_lse else out
    dev = q.device
    sms = _sm_counts.get(dev.index)
    if sms is None:
        sms = _sm_counts[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    p = plan(b, hq, hkv, s, d, q.element_size(), sms)
    fn = getattr(_load(), _FNS[q.dtype])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        cnt, part = _workspace(p, dev, stream)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(), cnt.data_ptr(), cnt.numel(),
                 part.data_ptr(), part.numel(), b, hq, hkv, s, d, p.heads, p.split_keys,
                 p.splits, 1.0 / math.sqrt(d), stream)
    if err:
        raise RuntimeError(f"decode_attention launch failed: cudaError {err}")
    launches += 1
    last_plan = p
    return (out, lse) if return_lse else out
