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
Only the bfloat16 cache; the reference's ``attention_options``
(``causal_skip``, the int8 ``kv_quant`` cache) are not ported yet.
"""

from __future__ import annotations

import torch

from ..kernels import ops
from .config import ArchConfig
from .layers import COMPUTE_DTYPE, apply_rope, dense_init
from .plan import AttentionPlan

__all__ = [
    "init_attention",
    "attention_train",
    "attention_decode",
    "cross_kv",
    "init_kv_cache",
    "attended_length",
]


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
    """out (B, slots, g, S, hd) -> (B, S, D) through the masked ``wo``."""
    b, slots, g, s, hd = out.shape
    out = out * p["head_mask"].to(out.dtype)[None, :, :, None, None]
    flat = out.permute(0, 3, 1, 2, 4).reshape(b, s, slots * g * hd)
    return flat @ p["wo"].to(out.dtype).reshape(slots * g * hd, -1)


def attention_train(p, x: torch.Tensor, cfg: ArchConfig, *, causal: bool = True,
                    positions: torch.Tensor | None = None,
                    kv_override: tuple[torch.Tensor, torch.Tensor] | None = None,
                    return_kv: bool = False):
    """Full-sequence attention (training / prefill). x: (B, S, D).

    With ``return_kv`` also returns the (B, slots, S, hd) K (after RoPE)
    and V that a decode cache keeps."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q, k, v = _project_qkv(p, x, positions, cfg.rope_theta)
    if kv_override is not None:  # cross-attention (enc-dec)
        k, v = kv_override
    _, slots, g, _, hd = q.shape
    out = ops.flash_attention(q.reshape(b, slots * g, s, hd).contiguous(),
                              k.contiguous(), v.contiguous(), causal)
    y = _out_proj(p, out.view(b, slots, g, s, hd))
    return (y, k, v) if return_kv else y


def cross_kv(p, enc: torch.Tensor):
    """Cross-attention K/V from encoder output (no RoPE)."""
    b, s, d = enc.shape
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
    shape = (batch, plan.slots, max_len, plan.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attended_length(lengths: torch.Tensor) -> torch.Tensor:
    """Valid cache positions once the row at ``lengths`` is written: the
    reference attends to positions ``<= lengths``, the kernel to
    positions ``< length``."""
    return lengths + 1


def attention_decode(p, x: torch.Tensor, cache: dict[str, torch.Tensor],
                     lengths: torch.Tensor, cfg: ArchConfig):
    """Single-step decode: write the new K/V row at each sequence's
    length (in place), attend to the valid prefix.

    x: (B, 1, D); cache {"k","v"}: (B, slots, Smax, hd); lengths: (B,)
    int32 tokens already in the cache. Returns (y (B, 1, D), cache)."""
    b = x.shape[0]
    # RoPE at each sequence's own position, which broadcasts differently
    # against q (B,slots,g,1,hd) and k (B,slots,1,hd): applied here.
    q, k, v = _project_qkv(p, x, lengths, theta=0.0)
    if cfg.rope_theta > 0:
        q = apply_rope(q, lengths[:, None, None, None], cfg.rope_theta)
        k = apply_rope(k, lengths[:, None, None], cfg.rope_theta)
    bidx = torch.arange(b, device=x.device)
    lidx = lengths.long()
    cache["k"][bidx, :, lidx, :] = k[:, :, 0, :].to(cache["k"].dtype)
    cache["v"][bidx, :, lidx, :] = v[:, :, 0, :].to(cache["v"].dtype)
    _, slots, g, _, hd = q.shape
    out = ops.decode_attention(q.reshape(b, slots * g, hd).contiguous(),
                               cache["k"], cache["v"],
                               attended_length(lengths).to(torch.int32))
    return _out_proj(p, out.view(b, slots, g, 1, hd)), cache
