"""Public kernel entry points: dispatch on the tensor's device.

* a CUDA tensor goes to the hand-written kernel (which launches or
  raises; nothing falls back),
* a CPU tensor goes to the plain PyTorch version in :mod:`.ref`.

The WSI pipeline's ``gpu`` function variants
(:mod:`repro_torch.app.pipeline`) call the image kernels, and the
language models (:mod:`repro_torch.models`) call the attention and
scan kernels, as the JAX package's ``tpu`` variants call its Pallas
wrappers.

``flash_attention`` and ``mamba2_chunk_scan`` are differentiable: when
autograd records (an input requires grad), they run as
``torch.autograd.Function``s whose backward dispatches the same way,
to the backward kernel for a CUDA tensor and to the plain backward in
:mod:`.ref` for a CPU tensor. Everything the backward needs goes
through ``ctx.save_for_backward`` (so ``torch.utils.checkpoint`` can
drop and recompute it). Without autograd (serving) they call the
forward kernels as before.
"""

from __future__ import annotations

import torch

from . import color_deconv as _cd
from . import decode_attention as _da
from . import feature_fused as _ff
from . import flash_attention as _fa
from . import mamba2_scan as _ms
from . import morph_recon as _mr
from . import ref
from . import sobel_stats as _ss

__all__ = [
    "color_deconv",
    "morph_recon",
    "sobel_stats",
    "feature_fused",
    "flash_attention",
    "decode_attention",
    "mamba2_chunk_scan",
    "FlashAttention",
    "Mamba2ChunkScan",
    "launch_counts",
    "reset_launch_counts",
]

#: Launch counter of each kernel: (wrapper module, counter name).
_COUNTERS = {
    "color_deconv": (_cd, "launches"),
    "morph_recon": (_mr, "launches"),
    "feature_fused": (_ff, "launches"),
    "sobel_stats": (_ss, "launches"),
    "flash_attention": (_fa, "launches"),
    "decode_attention": (_da, "launches"),
    "mamba2_chunk_scan": (_ms, "launches"),
    "flash_attention_bwd": (_fa, "bwd_launches"),
    "mamba2_chunk_scan_bwd": (_ms, "bwd_launches"),
}


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def color_deconv(r, g, b):
    """``(hema, eosin, resid)`` float32 planes of (H,W) R, G, B planes."""
    if _on_card(r):
        return _cd.color_deconv_cuda(r, g, b)
    return ref.color_deconv_ref(r, g, b)


def morph_recon(marker, mask):
    """Grayscale reconstruction of ``marker`` under ``mask`` (float32)."""
    if _on_card(mask):
        return _mr.morph_recon_cuda(marker, mask)
    return ref.morph_recon_ref(marker, mask)


def sobel_stats(gray):
    """``(mag, [sum, sumsq, max])`` of an (H,W) float32 plane."""
    if _on_card(gray):
        return _ss.sobel_stats_cuda(gray)
    return ref.sobel_stats_ref(gray)


def feature_fused(r, g, b):
    """``(hema, eosin, mag, stats)`` of (H,W) R, G, B planes."""
    if _on_card(r):
        return _ff.feature_fused_cuda(r, g, b)
    return ref.feature_fused_ref(r, g, b)


def _records(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward: saves q, k, v, the output and
    the float32 row log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        if _on_card(q):
            out, lse = _fa.flash_attention_cuda(q, k, v, causal, return_lse=True)
        else:
            out, lse = ref.flash_attention_fwd_ref(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if _on_card(q):
            dq, dk, dv = _fa.flash_attention_bwd_cuda(q, k, v, out, lse, dout, ctx.causal)
        else:
            dq, dk, dv = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = True):
    """(B, H, S, D) attention over k/v (B, Hkv, S, D), GQA by ``h // group``."""
    if _records(q, k, v):
        return FlashAttention.apply(q, k, v, causal)
    if _on_card(q):
        return _fa.flash_attention_cuda(q, k, v, causal)
    return ref.flash_attention_ref(q, k, v, causal)


def decode_attention(q, k, v, lengths):
    """One query (B, Hq, D) over a (B, Hkv, S, D) cache; positions
    ``< lengths`` attend."""
    if _on_card(q):
        return _da.decode_attention_cuda(q, k, v, lengths)
    return ref.decode_attention_ref(q, k, v, lengths)


class Mamba2ChunkScan(torch.autograd.Function):
    """The chunk-state scan with its backward: saves decay and the
    states entering each chunk (the forward's output, not recomputed)."""

    @staticmethod
    def forward(ctx, decay, inc):
        if _on_card(inc):
            states, final = _ms.mamba2_chunk_scan_cuda(decay, inc)
        else:
            states, final = ref.mamba2_chunk_scan_ref(decay, inc)
        ctx.save_for_backward(decay, states)
        return states, final

    @staticmethod
    def backward(ctx, g_states, g_final):
        decay, states = ctx.saved_tensors
        if _on_card(states):
            return _ms.mamba2_chunk_scan_bwd_cuda(decay, states, g_states, g_final)
        return ref.mamba2_chunk_scan_bwd_ref(decay, states, g_states, g_final)


def mamba2_chunk_scan(decay, inc):
    """States entering each chunk (C, H, F) and the final state (H, F)."""
    if _records(decay, inc):
        return Mamba2ChunkScan.apply(decay, inc)
    if _on_card(inc):
        return _ms.mamba2_chunk_scan_cuda(decay, inc)
    return ref.mamba2_chunk_scan_ref(decay, inc)


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last reset (the backward
    kernels under ``<name>_bwd``; a flash_attention backward call
    launches three)."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)
