"""Public kernel entry points: dispatch on the tensor's device.

* a CUDA tensor goes to the hand-written kernel (which launches or
  raises; nothing falls back),
* a CPU tensor goes to the plain PyTorch version in :mod:`.ref`.

These are what the ``gpu`` function variants of the WSI pipeline call
(:mod:`repro_torch.app.pipeline`), as the JAX package's ``tpu``
variants call its Pallas wrappers.
"""

from __future__ import annotations

import torch

from . import color_deconv as _cd
from . import feature_fused as _ff
from . import morph_recon as _mr
from . import ref

__all__ = [
    "color_deconv",
    "morph_recon",
    "feature_fused",
    "launch_counts",
    "reset_launch_counts",
]

_MODULES = {"color_deconv": _cd, "morph_recon": _mr, "feature_fused": _ff}


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


def feature_fused(r, g, b):
    """``(hema, eosin, mag, stats)`` of (H,W) R, G, B planes."""
    if _on_card(r):
        return _ff.feature_fused_cuda(r, g, b)
    return ref.feature_fused_ref(r, g, b)


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last reset."""
    return {name: mod.launches for name, mod in _MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.launches = 0
