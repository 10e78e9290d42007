"""Plain PyTorch versions of the main-path kernels.

Each function is the ground truth its CUDA kernel is held against, on
the card (``chip_smoke.py``, the ``gpu``-marked tests), and the
function the kernel wrapper runs for a tensor that lies on the CPU.
They repeat the arithmetic of the JAX package's oracles
(``repro/kernels/ref.py``) operation by operation, in float32, so that
the CPU tests can hold them against that package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "color_deconv_ref",
    "morph_recon_ref",
    "sobel_stats_ref",
    "feature_fused_ref",
    "DECONV_MATRIX",
    "GRAY_WEIGHTS",
]

#: ITU-R BT.601 luminance weights (matches app.segmentation.to_gray).
GRAY_WEIGHTS = (0.299, 0.587, 0.114)

# Ruifrok & Johnston H&E(+residual); rows = stain OD vectors.
_STAINS = np.array(
    [
        [0.650, 0.704, 0.286],
        [0.072, 0.990, 0.105],
        [0.268, 0.570, 0.776],
    ],
    dtype=np.float32,
)
DECONV_MATRIX = np.linalg.inv(_STAINS.T).astype(np.float32)

# The matrix as Python floats: a float32 tensor times a Python scalar
# computes in float32, exactly as the float32 numpy scalar does in jnp.
_M = tuple(tuple(float(x) for x in row) for row in DECONV_MATRIX)


def _od(x: torch.Tensor) -> torch.Tensor:
    return -torch.log10((x.float() + 1.0) / 256.0)


def color_deconv_ref(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor):
    """(H,W)x3 uint8/float planes -> 3 stain-density planes."""
    odr, odg, odb = _od(r), _od(g), _od(b)
    m = _M
    hema = m[0][0] * odr + m[0][1] * odg + m[0][2] * odb
    eosin = m[1][0] * odr + m[1][1] * odg + m[1][2] * odb
    resid = m[2][0] * odr + m[2][1] * odg + m[2][2] * odb
    return hema, eosin, resid


def dilate8(a: torch.Tensor) -> torch.Tensor:
    """3x3 max of a float plane, -inf beyond the edges (reduce_window's
    init in the oracle)."""
    return F.max_pool2d(a[None, None], 3, stride=1, padding=1)[0, 0]


def morph_recon_ref(marker: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Grayscale morphological reconstruction (8-conn geodesic fixpoint),
    one Jacobi sweep at a time; each sweep reads one flag on the host."""
    mask = mask.float()
    r = torch.minimum(marker.float(), mask)
    while True:
        nxt = torch.minimum(dilate8(r), mask)
        if torch.equal(nxt, r):
            return r
        r = nxt


def sobel_stats_ref(gray: torch.Tensor):
    """Sobel |grad| (edge-replicated) + moment sums (sum, sumsq, max)."""
    g = gray.float()
    h, w = g.shape
    p = F.pad(g[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    sl = lambda dy, dx: p[dy : dy + h, dx : dx + w]  # noqa: E731
    gx = (
        -1 * sl(0, 0) + 1 * sl(0, 2)
        - 2 * sl(1, 0) + 2 * sl(1, 2)
        - 1 * sl(2, 0) + 1 * sl(2, 2)
    )
    gy = (
        -1 * sl(0, 0) - 2 * sl(0, 1) - 1 * sl(0, 2)
        + 1 * sl(2, 0) + 2 * sl(2, 1) + 1 * sl(2, 2)
    )
    mag = torch.sqrt(gx * gx + gy * gy)
    stats = torch.stack([mag.sum(), (mag * mag).sum(), mag.max()])
    return mag, stats


def gray_ref(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    wr, wg, wb = GRAY_WEIGHTS
    return wr * r.float() + wg * g.float() + wb * b.float()


def feature_fused_ref(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor):
    """Composed version of the fused feature kernel: ``(hema, eosin,
    mag, stats)`` with ``stats = [h_sum, h_sumsq, h_max, g_sum,
    g_sumsq, g_max]``."""
    hema, eosin, _ = color_deconv_ref(r, g, b)
    mag, gstats = sobel_stats_ref(gray_ref(r, g, b))
    hstats = torch.stack([hema.sum(), (hema * hema).sum(), hema.max()])
    return hema, eosin, mag, torch.cat([hstats, gstats])
