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
    "flash_attention_ref",
    "decode_attention_ref",
    "mamba2_chunk_scan_ref",
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


def _kv_heads(x: torch.Tensor, group: int, dim: int) -> torch.Tensor:
    """KV heads repeated so that q head ``h`` meets kv head ``h // group``."""
    return x if group == 1 else x.repeat_interleave(group, dim=dim)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """(B, H, S, D) attention with optional causal mask; float32 softmax.
    k/v may carry fewer heads (B, Hkv, S, D): q head ``h`` reads kv head
    ``h // (H // Hkv)``. Output in q's dtype."""
    group = q.shape[1] // k.shape[1]
    s, d = q.shape[2], q.shape[3]
    kf = _kv_heads(k, group, 1).float()
    vf = _kv_heads(v, group, 1).float()
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * (1.0 / np.sqrt(d))
    if causal:
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """Single-token attention against a KV cache.

    q: (B, Hq, D); k/v: (B, Hkv, S, D); lengths: (B,) valid cache length
    (positions ``< lengths`` attend). GQA: query head i reads kv head
    ``i // (Hq // Hkv)``. Output in q's dtype.
    """
    group = q.shape[1] // k.shape[1]
    s, d = k.shape[2], q.shape[2]
    kf = _kv_heads(k, group, 1).float()
    vf = _kv_heads(v, group, 1).float()
    logits = torch.einsum("bhd,bhsd->bhs", q.float(), kf) * (1.0 / np.sqrt(d))
    pos = torch.arange(s, device=q.device)
    valid = pos[None, None, :] < lengths.to(q.device)[:, None, None]
    logits = logits.masked_fill(~valid, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhs,bhsd->bhd", p, vf).to(q.dtype)


def mamba2_chunk_scan_ref(decay: torch.Tensor, inc: torch.Tensor):
    """Inter-chunk SSD state recurrence.

    decay: (C, H) float32 per-chunk state decay; inc: (C, H, F) per-chunk
    state increment (F = P*N flattened). Returns the states *entering*
    each chunk (C, H, F) and the final state (H, F), in inc's dtype:

        s_0 = 0;  s_{c+1} = decay_c * s_c + inc_c   (float32 carry)
    """
    c, h, f = inc.shape
    s = torch.zeros((h, f), dtype=torch.float32, device=inc.device)
    states = torch.empty_like(inc)
    for i in range(c):
        states[i] = s.to(inc.dtype)
        s = decay[i].float()[:, None] * s + inc[i].float()
    return states, s.to(inc.dtype)
