"""Synthetic whole-slide-image tiles.

Generates H&E-like RGB tiles containing elliptical "nuclei" (dark
basophilic blobs), occasional red-blood-cell discs, pink stroma
background, and sensor noise — enough structure for every pipeline
operation to do real work, deterministic per ``(tile_id, seed)``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["synth_tile", "TileTruth"]


class TileTruth:
    """Ground truth bundled with a synthetic tile (for tests)."""

    def __init__(self, nuclei_mask: np.ndarray, n_nuclei: int, rbc_mask: np.ndarray):
        self.nuclei_mask = nuclei_mask
        self.n_nuclei = n_nuclei
        self.rbc_mask = rbc_mask


def _disk(h: int, w: int, cy: float, cx: float, ry: float, rx: float,
          theta: float) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    y, x = yy - cy, xx - cx
    ct, st = np.cos(theta), np.sin(theta)
    u = (ct * x + st * y) / rx
    v = (-st * x + ct * y) / ry
    return u * u + v * v <= 1.0


def synth_tile(
    tile_id: int,
    size: int = 256,
    n_nuclei: int | None = None,
    seed: int = 0,
    with_truth: bool = False,
):
    """Return an ``(size, size, 3) uint8`` H&E-like tile."""
    rng = np.random.default_rng(np.uint32(seed * 100003 + tile_id))
    h = w = size
    if n_nuclei is None:
        n_nuclei = int(rng.integers(6, 14)) * max(size // 128, 1)

    # Pink stroma background with low-frequency texture.
    base = np.array([231, 180, 202], dtype=np.float32)
    tex = rng.normal(0, 1, (h // 16 + 1, w // 16 + 1)).astype(np.float32)
    tex = np.kron(tex, np.ones((16, 16), np.float32))[:h, :w]
    img = base[None, None, :] + tex[..., None] * np.array([6, 9, 6], np.float32)

    nuclei = np.zeros((h, w), bool)
    placed = 0
    for _ in range(n_nuclei * 3):
        if placed >= n_nuclei:
            break
        r = rng.uniform(size * 0.02, size * 0.05)
        cy, cx = rng.uniform(r, h - r), rng.uniform(r, w - r)
        m = _disk(h, w, cy, cx, r * rng.uniform(0.7, 1.0), r, rng.uniform(0, np.pi))
        if (m & nuclei).sum() > 0.25 * m.sum():
            continue  # too much overlap
        nuclei |= m
        placed += 1
        # Dark purple (hematoxylin) with internal chromatin texture.
        depth = rng.uniform(0.55, 0.8)
        chroma = rng.normal(0, 6, (h, w)).astype(np.float32)
        tint = np.array([94, 60, 132], np.float32)
        img[m] = img[m] * (1 - depth) + (tint + chroma[..., None][m]) * depth

    rbc = np.zeros((h, w), bool)
    for _ in range(int(rng.integers(0, 4))):
        r = rng.uniform(size * 0.015, size * 0.03)
        cy, cx = rng.uniform(r, h - r), rng.uniform(r, w - r)
        m = _disk(h, w, cy, cx, r, r, 0.0) & ~nuclei
        rbc |= m
        img[m] = np.array([198, 60, 54], np.float32)  # eosinophilic red

    img += rng.normal(0, 2.5, img.shape).astype(np.float32)
    tile = np.clip(img, 0, 255).astype(np.uint8)
    if with_truth:
        return tile, TileTruth(nuclei, placed, rbc)
    return tile
