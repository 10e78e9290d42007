"""Feature-computation-stage operations (paper §II, Table I).

``color_deconv`` separates hematoxylin/eosin stains; the five feature
ops are mutually independent given the deconvolved channels and the
object label map — the concurrency PATS exploits. Every op has a CPU
(NumPy, copied from the JAX package) and an accelerator (PyTorch on an
explicit device) variant with the same outputs.

Per-object features are fixed-shape segment reductions over
``objects`` in ``1..MAX_OBJECTS`` (``index_add_`` in float32). The
``feat_*`` outputs are small (at most ``MAX_OBJECTS`` x 3 floats) and
leave the device as numpy arrays at the end of the op that makes them.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops as K
from ._device import host_sync, resolve_device, to_device, to_host
from .segmentation import MAX_OBJECTS

__all__ = [
    "STAIN_MATRIX",
    "color_deconv_cpu", "color_deconv_accel",
    "pixel_stats_cpu", "pixel_stats_accel",
    "gradient_stats_cpu", "gradient_stats_accel",
    "haralick_cpu", "haralick_accel",
    "canny_edge_cpu", "canny_edge_accel",
    "morphometry_cpu", "morphometry_accel",
]

# Ruifrok & Johnston H&E(+residual) stain vectors, rows normalized.
STAIN_MATRIX = np.array(
    [
        [0.650, 0.704, 0.286],   # hematoxylin
        [0.072, 0.990, 0.105],   # eosin
        [0.268, 0.570, 0.776],   # residual
    ],
    dtype=np.float32,
)
_DECONV = np.linalg.inv(STAIN_MATRIX.T).astype(np.float32)

_SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
_SOBEL_Y = _SOBEL_X.T.copy()


# --------------------------------------------------------------------------
# color deconvolution
# --------------------------------------------------------------------------


def _od(rgb_f):
    return -np.log10((rgb_f + 1.0) / 256.0)


def color_deconv_cpu(state: dict) -> dict:
    rgb = np.asarray(state["rgb"], np.float32)
    od = _od(rgb)
    stains = od.reshape(-1, 3) @ _DECONV.T
    stains = stains.reshape(od.shape).astype(np.float32)
    return {**state, "hema": stains[..., 0], "eosin": stains[..., 1]}


def color_deconv_accel(state: dict, device="cuda") -> dict:
    """The ``color_deconv`` kernel on the channel views of the resident
    (H, W, 3) tile — no de-interleaving copy."""
    dev = resolve_device(device)
    rgb = to_device(state["rgb"], dev)
    hema, eosin, _ = K.color_deconv(rgb[..., 0], rgb[..., 1], rgb[..., 2])
    return {**state, "hema": hema, "eosin": eosin}


# --------------------------------------------------------------------------
# per-object reductions
# --------------------------------------------------------------------------


def _seg_sums_np(values: np.ndarray, objects: np.ndarray):
    flat_v, flat_o = values.reshape(-1), objects.reshape(-1).astype(np.int64)
    n = MAX_OBJECTS + 1
    s = np.bincount(flat_o, weights=flat_v, minlength=n)[:n]
    s2 = np.bincount(flat_o, weights=flat_v * flat_v, minlength=n)[:n]
    cnt = np.bincount(flat_o, minlength=n)[:n]
    return s[1:], s2[1:], cnt[1:]  # drop background


def _obj_stats_np(values: np.ndarray, objects: np.ndarray) -> np.ndarray:
    s, s2, cnt = _seg_sums_np(values, objects)
    safe = np.maximum(cnt, 1)
    mean = s / safe
    var = np.maximum(s2 / safe - mean * mean, 0.0)
    return np.stack([mean, np.sqrt(var), cnt.astype(np.float64)], axis=-1).astype(
        np.float32
    )


def _segment_sum_t(values: torch.Tensor, objects: torch.Tensor) -> torch.Tensor:
    """float32 per-object sums over ids 0..MAX_OBJECTS (0 = background)."""
    out = torch.zeros(MAX_OBJECTS + 1, dtype=torch.float32, device=values.device)
    return out.index_add_(0, objects.reshape(-1).long(), values.reshape(-1).float())


def _obj_stats_t(values: torch.Tensor, objects: torch.Tensor) -> torch.Tensor:
    v = values.float()
    s = _segment_sum_t(v, objects)[1:]
    s2 = _segment_sum_t(v * v, objects)[1:]
    cnt = _segment_sum_t(torch.ones_like(v), objects)[1:]
    safe = torch.clamp_min(cnt, 1.0)
    mean = s / safe
    var = torch.clamp_min(s2 / safe - mean * mean, 0.0)
    return torch.stack([mean, torch.sqrt(var), cnt], dim=-1)


# --------------------------------------------------------------------------
# pixel statistics
# --------------------------------------------------------------------------


def pixel_stats_cpu(state: dict) -> dict:
    feats = _obj_stats_np(np.asarray(state["hema"], np.float64),
                          np.asarray(state["objects"]))
    return {**state, "feat_pixel": feats}


def pixel_stats_accel(state: dict, device="cuda") -> dict:
    dev = resolve_device(device)
    feats = _obj_stats_t(
        to_device(state["hema"], dev), to_device(state["objects"], dev)
    )
    return {**state, "feat_pixel": to_host(feats)}


# --------------------------------------------------------------------------
# gradient statistics
# --------------------------------------------------------------------------


def _conv3_np(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    out = np.zeros_like(img, dtype=np.float32)
    pad = np.pad(img.astype(np.float32), 1, mode="edge")
    for dy in range(3):
        for dx in range(3):
            out += k[dy, dx] * pad[dy : dy + img.shape[0], dx : dx + img.shape[1]]
    return out


def _grad_mag_np(gray: np.ndarray) -> np.ndarray:
    gx = _conv3_np(gray, _SOBEL_X)
    gy = _conv3_np(gray, _SOBEL_Y)
    return np.sqrt(gx * gx + gy * gy)


def gradient_stats_cpu(state: dict) -> dict:
    mag = _grad_mag_np(np.asarray(state["gray"], np.float32))
    feats = _obj_stats_np(mag.astype(np.float64), np.asarray(state["objects"]))
    return {**state, "feat_gradient": feats}


def _conv3_t(img: torch.Tensor, k: np.ndarray) -> torch.Tensor:
    h, w = img.shape
    pad = F.pad(img.float()[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    out = torch.zeros((h, w), dtype=torch.float32, device=img.device)
    for dy in range(3):
        for dx in range(3):
            out = out + float(k[dy, dx]) * pad[dy : dy + h, dx : dx + w]
    return out


def _grad_mag_t(gray: torch.Tensor) -> torch.Tensor:
    gx = _conv3_t(gray, _SOBEL_X)
    gy = _conv3_t(gray, _SOBEL_Y)
    return torch.sqrt(gx * gx + gy * gy)


def gradient_stats_accel(state: dict, device="cuda") -> dict:
    dev = resolve_device(device)
    mag = _grad_mag_t(to_device(state["gray"], dev))
    feats = _obj_stats_t(mag, to_device(state["objects"], dev))
    return {**state, "feat_gradient": to_host(feats)}


# --------------------------------------------------------------------------
# Haralick (GLCM) texture features — tile level, 8 gray levels
# --------------------------------------------------------------------------

_GLCM_LEVELS = 8


def _quantize_np(gray: np.ndarray) -> np.ndarray:
    lo, hi = gray.min(), gray.max()
    q = (gray - lo) / max(hi - lo, 1e-6) * (_GLCM_LEVELS - 1)
    return q.astype(np.int32)


def _glcm_features(glcm: np.ndarray) -> np.ndarray:
    glcm = glcm / max(glcm.sum(), 1e-9)
    i, j = np.mgrid[0:_GLCM_LEVELS, 0:_GLCM_LEVELS]
    contrast = float((glcm * (i - j) ** 2).sum())
    energy = float((glcm**2).sum())
    homogeneity = float((glcm / (1.0 + np.abs(i - j))).sum())
    entropy = float(-(glcm * np.log(glcm + 1e-12)).sum())
    return np.array([contrast, energy, homogeneity, entropy], np.float32)


def haralick_cpu(state: dict) -> dict:
    q = _quantize_np(np.asarray(state["gray"], np.float32))
    fg = np.asarray(state["mask"])
    glcm = np.zeros((_GLCM_LEVELS, _GLCM_LEVELS), np.float64)
    for dy, dx in ((0, 1), (1, 0)):
        a = q[: q.shape[0] - dy, : q.shape[1] - dx]
        b = q[dy:, dx:]
        m = fg[: q.shape[0] - dy, : q.shape[1] - dx] & fg[dy:, dx:]
        np.add.at(glcm, (a[m], b[m]), 1.0)
        np.add.at(glcm, (b[m], a[m]), 1.0)  # symmetric
    return {**state, "feat_haralick": _glcm_features(glcm)}


def _haralick_t(gray: torch.Tensor, fg: torch.Tensor) -> torch.Tensor:
    L = _GLCM_LEVELS
    gray = gray.float()
    lo, hi = gray.min(), gray.max()
    q = ((gray - lo) / torch.clamp_min(hi - lo, 1e-6) * (L - 1)).to(torch.int32)
    h, w = q.shape
    # Integer co-occurrence counts (exact, deterministic); pairs outside
    # the mask land in an overflow bin that is dropped.
    counts = torch.zeros(L * L, dtype=torch.int64, device=q.device)
    for dy, dx in ((0, 1), (1, 0)):
        a = q[: h - dy, : w - dx].reshape(-1).long()
        b = q[dy:, dx:].reshape(-1).long()
        m = (fg[: h - dy, : w - dx] & fg[dy:, dx:]).reshape(-1)
        pair = torch.where(m, a * L + b, L * L)
        counts += host_sync("bincount", torch.bincount, pair, minlength=L * L + 1)[: L * L]
    c = counts.reshape(L, L)
    glcm = (c + c.T).float()  # symmetric
    glcm = glcm / torch.clamp_min(glcm.sum(), 1e-9)
    i, j = torch.meshgrid(
        torch.arange(L, device=q.device), torch.arange(L, device=q.device),
        indexing="ij",
    )
    contrast = (glcm * (i - j) ** 2).sum()
    energy = (glcm**2).sum()
    homogeneity = (glcm / (1.0 + (i - j).abs())).sum()
    entropy = -(glcm * torch.log(glcm + 1e-12)).sum()
    return torch.stack([contrast, energy, homogeneity, entropy])


def haralick_accel(state: dict, device="cuda") -> dict:
    dev = resolve_device(device)
    feats = _haralick_t(to_device(state["gray"], dev), to_device(state["mask"], dev))
    return {**state, "feat_haralick": to_host(feats)}


# --------------------------------------------------------------------------
# Canny-style edges
# --------------------------------------------------------------------------


def canny_edge_cpu(state: dict, lo: float = 20.0, hi: float = 50.0) -> dict:
    mag = _grad_mag_np(np.asarray(state["gray"], np.float32))
    strong, weak = mag >= hi, mag >= lo
    # Hysteresis: reconstruct strong edges within the weak mask.
    from .segmentation import morph_reconstruct_np

    edges = (
        morph_reconstruct_np(
            strong.astype(np.float32) * 255.0, weak.astype(np.float32) * 255.0
        )
        > 0
    )
    s, _, cnt = _seg_sums_np(edges.astype(np.float64), np.asarray(state["objects"]))
    density = (s / np.maximum(cnt, 1)).astype(np.float32)
    return {**state, "feat_canny": density}


def canny_edge_accel(state: dict, device="cuda", lo: float = 20.0,
                     hi: float = 50.0) -> dict:
    """Hysteresis as a reconstruction of strong edges within the weak
    mask, through the ``morph_recon`` kernel."""
    dev = resolve_device(device)
    objects = to_device(state["objects"], dev)
    mag = _grad_mag_t(to_device(state["gray"], dev))
    strong = (mag >= hi).float() * 255.0
    weak = (mag >= lo).float() * 255.0
    edges = (K.morph_recon(strong, weak) > 0).float()
    s = _segment_sum_t(edges, objects)[1:]
    cnt = _segment_sum_t(torch.ones_like(edges), objects)[1:]
    return {**state, "feat_canny": to_host(s / torch.clamp_min(cnt, 1.0))}


# --------------------------------------------------------------------------
# morphometry
# --------------------------------------------------------------------------


def morphometry_cpu(state: dict) -> dict:
    objects = np.asarray(state["objects"])
    fg = objects > 0
    # Perimeter pixels: fg with at least one 4-neighbor background.
    pad = np.pad(fg, 1)
    interior = (
        pad[:-2, 1:-1] & pad[2:, 1:-1] & pad[1:-1, :-2] & pad[1:-1, 2:]
    )
    perim = fg & ~interior
    area, _, _ = _seg_sums_np(fg.astype(np.float64), objects)
    per, _, _ = _seg_sums_np(perim.astype(np.float64), objects)
    circ = 4.0 * np.pi * area / np.maximum(per * per, 1.0)
    feats = np.stack([area, per, np.minimum(circ, 4.0)], -1).astype(np.float32)
    return {**state, "feat_morph": feats}


def morphometry_accel(state: dict, device="cuda") -> dict:
    dev = resolve_device(device)
    objects = to_device(state["objects"], dev)
    fg = objects > 0
    pad = F.pad(fg.to(torch.uint8), (1, 1, 1, 1)).bool()
    interior = (
        pad[:-2, 1:-1] & pad[2:, 1:-1] & pad[1:-1, :-2] & pad[1:-1, 2:]
    )
    perim = fg & ~interior
    area = _segment_sum_t(fg.float(), objects)[1:]
    per = _segment_sum_t(perim.float(), objects)[1:]
    circ = 4.0 * math.pi * area / torch.clamp_min(per * per, 1.0)
    feats = torch.stack([area, per, torch.clamp_max(circ, 4.0)], dim=-1)
    return {**state, "feat_morph": to_host(feats)}
