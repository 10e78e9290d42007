"""GQA attention in slot layout, on the port's attention kernels.

The port of ``repro/models/attention.py``. Layout (see :mod:`.plan`):

* ``wq``: (d_model, slots, g_eff, head_dim);
* ``wk``/``wv``: (d_model, slots, head_dim);
* ``wo``: (slots, g_eff, head_dim, d_model);
* ``head_mask``: (slots, g_eff) zeroing padded query heads.

Prefill and training go through :func:`repro_torch.kernels.ops.flash_attention`
(q as ``(B, slots*g, S, hd)`` against k/v ``(B, slots, S, hd)``: q head
``h`` reads slot ``h // g``, so no repeated K/V is materialised). Decode
writes the new K/V row in place at ``lengths`` and calls
:func:`repro_torch.kernels.ops.decode_attention` over the ``lengths + 1``
valid positions (the reference attends to positions ``<= lengths``).
On a mesh whose serving layout splits the cache's sequence over the data
axes (``p.seq``, the long-context layout of ``launch/spmd.py``), a rank
holds positions ``[r * chunk, (r + 1) * chunk)``: it writes the new row
only where its chunk holds it, attends over its chunk's valid prefix
with the kernel's log-sum-exp, and the ranks' partial results merge.

Cross-attention (the encoder-decoder's ``kv_override``) has a query
length other than the encoder's, which neither the TPU kernel nor the
port's flash kernel takes; the reference computes it in plain ``jnp``,
and so does :func:`cross_attention` here, with torch products and a
float32 softmax.

:class:`attention_options` carries the reference's two options:

* ``kv_quant``: caches made by :func:`init_kv_cache` hold int8 rows with
  one float32 scale each; a decode step quantises the new row, dequantises
  the cache to float32 and runs the decode kernel in float32. The
  reference's ``prefill`` returns bfloat16 caches all the same, so only a
  decode chain that starts from empty caches reaches this path.
* ``causal_skip``: the reference's triangular kv-block loop, which skips
  blocks past the diagonal. The flash kernel already ends each query
  block's loop at its last unmasked key block, and the plain version's
  masked product gives the same numbers, so the option changes nothing
  on either device.
"""

from __future__ import annotations

import math

import torch

from ..kernels import ops
from .config import ArchConfig
from .layers import COMPUTE_DTYPE, apply_rope, dense_init, tp_enter, tp_exit
from .plan import AttentionPlan

__all__ = [
    "init_attention",
    "attention_train",
    "attention_decode",
    "attention_options",
    "cross_attention",
    "cross_kv",
    "init_kv_cache",
    "attended_length",
]

#: Options set by :class:`attention_options`.
_CAUSAL_SKIP = False   # skip fully-masked kv blocks: the kernels always do
_KV_QUANT = False      # int8 KV cache with per-row scales


class attention_options:
    """Context manager for the reference's attention options
    (``causal_skip``, ``kv_quant``); ``None`` leaves an option as it is."""

    def __init__(self, causal_skip: bool | None = None, kv_quant: bool | None = None):
        self.causal_skip = causal_skip
        self.kv_quant = kv_quant

    def __enter__(self):
        global _CAUSAL_SKIP, _KV_QUANT
        self._prev = (_CAUSAL_SKIP, _KV_QUANT)
        if self.causal_skip is not None:
            _CAUSAL_SKIP = self.causal_skip
        if self.kv_quant is not None:
            _KV_QUANT = self.kv_quant
        return self

    def __exit__(self, *exc):
        global _CAUSAL_SKIP, _KV_QUANT
        _CAUSAL_SKIP, _KV_QUANT = self._prev
        return False


def init_attention(gen: torch.Generator, cfg: ArchConfig, plan: AttentionPlan,
                   device=None) -> dict[str, torch.Tensor]:
    d, hd = cfg.d_model, plan.head_dim
    wq = torch.zeros((d, plan.slots, plan.g_eff, hd), device=device)
    wk = torch.zeros((d, plan.slots, hd), device=device)
    wv = torch.zeros((d, plan.slots, hd), device=device)
    wo = torch.zeros((plan.slots, plan.g_eff, hd, d), device=device)
    # Fill real heads; padded slots stay zero.
    q_real = dense_init(gen, (d, plan.n_heads, hd), device=device)
    k_real = dense_init(gen, (d, plan.n_kv_heads, hd), device=device)
    v_real = dense_init(gen, (d, plan.n_kv_heads, hd), device=device)
    o_real = dense_init(gen, (plan.n_heads, hd, d), fan_in=plan.n_heads * hd,
                        device=device)
    for i, (s, p) in enumerate(plan.q_map()):
        wq[:, s, p, :] = q_real[:, i, :]
        wo[s, p] = o_real[i]
    for s, real in enumerate(plan.kv_map()):
        if real >= 0:
            wk[:, s, :] = k_real[:, real, :]
            wv[:, s, :] = v_real[:, real, :]
    p = {
        "wq": wq, "wk": wk, "wv": wv, "wo": wo,
        "head_mask": torch.as_tensor(plan.head_mask(), device=device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((plan.slots, plan.g_eff, hd), device=device)
        p["bk"] = torch.zeros((plan.slots, hd), device=device)
        p["bv"] = torch.zeros((plan.slots, hd), device=device)
    return p


def _project_qkv(p, x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (B, S, D) -> q (B,slots,g,S,hd), k/v (B,slots,S,hd)."""
    b, s, d = x.shape
    _, slots, g, hd = p["wq"].shape
    q = (x @ p["wq"].to(x.dtype).reshape(d, -1)).view(b, s, slots, g, hd)
    k = (x @ p["wk"].to(x.dtype).reshape(d, -1)).view(b, s, slots, hd)
    v = (x @ p["wv"].to(x.dtype).reshape(d, -1)).view(b, s, slots, hd)
    q, k, v = q.permute(0, 2, 3, 1, 4), k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)[None, :, :, None, :]
        k = k + p["bk"].to(x.dtype)[None, :, None, :]
        v = v + p["bv"].to(x.dtype)[None, :, None, :]
    if theta > 0:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    return q, k, v


def _out_proj(p, out: torch.Tensor) -> torch.Tensor:
    """out (B, slots, g, S, hd) -> (B, S, D) through the masked ``wo``
    (on a tensor-parallel rank: its slots' part, summed over the ranks)."""
    b, slots, g, s, hd = out.shape
    out = out * p["head_mask"].to(out.dtype)[None, :, :, None, None]
    flat = out.permute(0, 3, 1, 2, 4).reshape(b, s, slots * g * hd)
    return tp_exit(p, flat @ p["wo"].to(out.dtype).reshape(slots * g * hd, -1))


def attention_train(p, x: torch.Tensor, cfg: ArchConfig, *, causal: bool = True,
                    positions: torch.Tensor | None = None,
                    kv_override: tuple[torch.Tensor, torch.Tensor] | None = None,
                    return_kv: bool = False):
    """Full-sequence attention (training / prefill). x: (B, S, D).

    With ``return_kv`` also returns the (B, slots, S, hd) K (after RoPE)
    and V that a decode cache keeps. With ``kv_override`` (cross-attention
    of the encoder-decoder) the queries attend to the given K/V through
    :func:`cross_attention`; as in the reference, they are rotated at
    positions ``0..S-1`` and ``causal`` is not read."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    x = tp_enter(p, x)
    q, k, v = _project_qkv(p, x, positions, cfg.rope_theta)
    if kv_override is not None:  # cross-attention (enc-dec)
        k, v = kv_override
        y = _out_proj(p, cross_attention(q, k, v))
    else:
        _, slots, g, _, hd = q.shape
        out = ops.flash_attention(q.reshape(b, slots * g, s, hd).contiguous(),
                                  k.contiguous(), v.contiguous(), causal)
        y = _out_proj(p, out.view(b, slots, g, s, hd))
    return (y, k, v) if return_kv else y


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Full attention of q (B, slots, g, Sq, hd) over k/v (B, slots, Skv,
    hd), any Sq and Skv: the products and the softmax in float32 (the
    reference's ``_chunked_attn`` without a mask, in one block) ->
    (B, slots, g, Sq, hd) in q's type."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bkgqh,bkch->bkgqc", q.float(), k.float()) * scale
    out = torch.einsum("bkgqc,bkch->bkgqh", torch.softmax(s, dim=-1), v.float())
    return out.to(q.dtype)


def cross_kv(p, enc: torch.Tensor):
    """Cross-attention K/V from encoder output (no RoPE)."""
    b, s, d = enc.shape
    enc = tp_enter(p, enc)
    slots, hd = p["wk"].shape[1], p["wk"].shape[2]
    k = (enc @ p["wk"].to(enc.dtype).reshape(d, -1)).view(b, s, slots, hd)
    v = (enc @ p["wv"].to(enc.dtype).reshape(d, -1)).view(b, s, slots, hd)
    k, v = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    if "bk" in p:
        k = k + p["bk"].to(enc.dtype)[None, :, None, :]
        v = v + p["bv"].to(enc.dtype)[None, :, None, :]
    return k, v


def init_kv_cache(batch: int, max_len: int, plan: AttentionPlan,
                  device=None, dtype=COMPUTE_DTYPE) -> dict[str, torch.Tensor]:
    """Empty K/V caches in ``dtype``; under ``attention_options(kv_quant=True)``
    int8 rows ``k_q``/``v_q`` with float32 scales ``k_s``/``v_s``."""
    shape = (batch, plan.slots, max_len, plan.head_dim)
    if _KV_QUANT:
        sshape = (batch, plan.slots, max_len, 1)
        return {"k_q": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_s": torch.zeros(sshape, device=device),
                "v_q": torch.zeros(shape, dtype=torch.int8, device=device),
                "v_s": torch.zeros(sshape, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _quant_rows(x: torch.Tensor):
    """x: (B, slots, hd) -> (int8 rows, (B, slots, 1) float32 scales)."""
    x = x.float()
    scale = x.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), scale


def attended_length(lengths: torch.Tensor) -> torch.Tensor:
    """Valid cache positions once the row at ``lengths`` is written: the
    reference attends to positions ``<= lengths``, the kernel to
    positions ``< length``."""
    return lengths + 1


def attention_decode(p, x: torch.Tensor, cache: dict[str, torch.Tensor],
                     lengths: torch.Tensor, cfg: ArchConfig):
    """Single-step decode: write the new K/V row at each sequence's
    length (in place), attend to the valid prefix.

    x: (B, 1, D); cache {"k","v"}: (B, slots, Smax, hd) (or the int8
    ``k_q``/``k_s``/``v_q``/``v_s``; on a rank of the long-context layout
    its chunk of Smax); lengths: (B,) int32 tokens already in the cache.
    Returns (y (B, 1, D), cache)."""
    b = x.shape[0]
    seq = getattr(p, "seq", None)  # the ranks that split the cache's sequence
    pos, valid, mine = lengths.long(), attended_length(lengths), None
    if seq is not None:  # no host read: the row's rank and each rank's length on the device
        chunk = next(iter(cache.values())).shape[2]
        pos = pos - seq.rank * chunk
        mine = (pos >= 0) & (pos < chunk)
        pos = pos.clamp(0, chunk - 1)
        valid = (valid - seq.rank * chunk).clamp(0, chunk)
    x = tp_enter(p, x)
    # RoPE at each sequence's own position, which broadcasts differently
    # against q (B,slots,g,1,hd) and k (B,slots,1,hd): applied here.
    q, k, v = _project_qkv(p, x, lengths, theta=0.0)
    if cfg.rope_theta > 0:
        q = apply_rope(q, lengths[:, None, None, None], cfg.rope_theta)
        k = apply_rope(k, lengths[:, None, None], cfg.rope_theta)
    bidx = torch.arange(b, device=x.device)

    def put(name: str, row: torch.Tensor) -> None:
        buf = cache[name]
        row = row.to(buf.dtype)
        if mine is not None:  # other ranks write back what they hold
            row = torch.where(mine[:, None, None], row, buf[bidx, :, pos, :])
        buf[bidx, :, pos, :] = row

    _, slots, g, _, hd = q.shape
    q = q.reshape(b, slots * g, hd)
    if "k_q" in cache:  # int8 cache (attention_options): attend in float32
        for name, row in (("k", k[:, :, 0, :]), ("v", v[:, :, 0, :])):
            rows, scales = _quant_rows(row)
            put(f"{name}_q", rows)
            put(f"{name}_s", scales)
        kc = cache["k_q"].float() * cache["k_s"]
        vc = cache["v_q"].float() * cache["v_s"]
        q = q.float()
    else:
        put("k", k[:, :, 0, :])
        put("v", v[:, :, 0, :])
        kc, vc = cache["k"], cache["v"]
    valid = valid.to(torch.int32)
    if seq is None:
        out = ops.decode_attention(q.contiguous(), kc, vc, valid)
    else:
        out = seq.merge(*ops.decode_attention(q.contiguous(), kc, vc, valid, return_lse=True))
    return _out_proj(p, out.to(x.dtype).view(b, slots, g, 1, hd)), cache
