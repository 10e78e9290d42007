"""Public kernel entry points: dispatch on the tensor's device.

* a CUDA tensor goes to the hand-written kernel (which launches or
  raises; nothing falls back),
* a CPU tensor goes to the plain PyTorch version in :mod:`.ref`.

The WSI pipeline's ``gpu`` function variants
(:mod:`repro_torch.app.pipeline`) call the image kernels, and the
language models (:mod:`repro_torch.models`) call the attention and
scan kernels, as the JAX package's ``tpu`` variants call its Pallas
wrappers.
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
    "launch_counts",
    "reset_launch_counts",
]

_MODULES = {
    "color_deconv": _cd,
    "morph_recon": _mr,
    "feature_fused": _ff,
    "sobel_stats": _ss,
    "flash_attention": _fa,
    "decode_attention": _da,
    "mamba2_chunk_scan": _ms,
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


def flash_attention(q, k, v, causal: bool = True):
    """(B, H, S, D) attention over k/v (B, Hkv, S, D), GQA by ``h // group``."""
    if _on_card(q):
        return _fa.flash_attention_cuda(q, k, v, causal)
    return ref.flash_attention_ref(q, k, v, causal)


def decode_attention(q, k, v, lengths):
    """One query (B, Hq, D) over a (B, Hkv, S, D) cache; positions
    ``< lengths`` attend."""
    if _on_card(q):
        return _da.decode_attention_cuda(q, k, v, lengths)
    return ref.decode_attention_ref(q, k, v, lengths)


def mamba2_chunk_scan(decay, inc):
    """States entering each chunk (C, H, F) and the final state (H, F)."""
    if _on_card(inc):
        return _ms.mamba2_chunk_scan_cuda(decay, inc)
    return ref.mamba2_chunk_scan_ref(decay, inc)


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: mod.launches for name, mod in _MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.launches = 0
