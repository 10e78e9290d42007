"""The traffic generator: H&E-like whole-slide-image tiles from a seed.

A cell's traffic file (``bench/traffic/<name>.json``) gives the
parameters; :func:`make_traffic` turns them and ``--seed`` into a pool
of distinct 4096x4096 mosaics that the bag of tasks cycles through.

The pool of ``grid x grid`` tiles of ``pool_size`` is drawn from the
traffic file's ``pool_seed``: its nuclei counts are a fixed ladder over
the traffic's range, their places and shapes are drawn. ``--seed``
arranges it: each mosaic holds every pool tile once, in a seeded order
with seeded flips and rotations. Every seed thus sends the same tissue
in other tiles and arrangements, so that the work of a run does not
change with the seed (on pools drawn from the seed itself, two seeds'
runs differed by 5% in tiles a window, two runs of one seed by none).

A pool tile is drawn as the port's ``app/tiles.synth_tile`` draws one
(pink stroma with a low-frequency texture, elliptical hematoxylin
nuclei with chromatin noise, a few red blood cells, sensor noise), with
the counts and sizes of nuclei and red cells from the traffic file, and
each nucleus and cell drawn inside its own bounding box, not as a mask
of the whole frame: a 1024x1024 tile takes tens of milliseconds
instead of seconds.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["Traffic", "make_traffic", "nuclei_ladder", "pool_tile", "rng_for"]

_BASE = np.array([231, 180, 202], np.float32)
_TEX = np.array([6, 9, 6], np.float32)
_TINT = np.array([94, 60, 132], np.float32)
_RBC = np.array([198, 60, 54], np.float32)


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator of its own for ``(seed, *stream)``; any whole seed,
    negative or beyond 64 bits, maps to one entropy value."""
    return np.random.default_rng([int(seed) % 2**64, *stream])


def nuclei_ladder(lo: int, hi: int, n: int) -> list[int]:
    """``n`` nucleus counts spread evenly over ``lo..hi`` (inclusive)."""
    return [lo + (hi - lo + 1) * i // n for i in range(n)]


def _ellipse(h: int, w: int, cy: float, cx: float, ry: float, rx: float,
             theta: float):
    """Mask of the ellipse inside its bounding box, and the box's origin."""
    y0, y1 = max(int(np.floor(cy - rx)), 0), min(int(np.ceil(cy + rx)) + 1, h)
    x0, x1 = max(int(np.floor(cx - rx)), 0), min(int(np.ceil(cx + rx)) + 1, w)
    yy, xx = np.mgrid[y0:y1, x0:x1]
    y, x = yy - cy, xx - cx
    ct, st = np.cos(theta), np.sin(theta)
    u = (ct * x + st * y) / rx
    v = (-st * x + ct * y) / ry
    return u * u + v * v <= 1.0, (slice(y0, y1), slice(x0, x1))


def pool_tile(rng: np.random.Generator, size: int, n_nuclei: int,
              radius: tuple[float, float], rbc: tuple[int, int],
              rbc_radius: tuple[float, float]) -> tuple[np.ndarray, int]:
    """One ``(size, size, 3) uint8`` tile and the nuclei placed in it.
    ``radius`` and ``rbc_radius`` are the radii of a nucleus and of a red
    blood cell as shares of ``size``; ``rbc`` the range (``lo <= n <
    hi``) of red blood cells."""
    h = w = size
    tex = rng.standard_normal((h // 16 + 1, w // 16 + 1), dtype=np.float32)
    tex = np.repeat(np.repeat(tex, 16, axis=0), 16, axis=1)[:h, :w]
    img = _BASE[None, None, :] + tex[..., None] * _TEX

    nuclei = np.zeros((h, w), bool)
    placed = 0
    for _ in range(n_nuclei * 3):
        if placed >= n_nuclei:
            break
        r = rng.uniform(size * radius[0], size * radius[1])
        cy, cx = rng.uniform(r, h - r), rng.uniform(r, w - r)
        m, box = _ellipse(h, w, cy, cx, r * rng.uniform(0.7, 1.0), r, rng.uniform(0, np.pi))
        if (m & nuclei[box]).sum() > 0.25 * m.sum():
            continue  # too much overlap
        nuclei[box] |= m
        placed += 1
        depth = rng.uniform(0.55, 0.8)
        chroma = rng.standard_normal(m.shape, dtype=np.float32) * np.float32(6)
        sub = img[box]
        sub[m] = sub[m] * (1 - depth) + (_TINT + chroma[m][:, None]) * depth

    for _ in range(int(rng.integers(rbc[0], rbc[1]))):
        r = rng.uniform(size * rbc_radius[0], size * rbc_radius[1])
        cy, cx = rng.uniform(r, h - r), rng.uniform(r, w - r)
        m, box = _ellipse(h, w, cy, cx, r, r, 0.0)
        m &= ~nuclei[box]
        img[box][m] = _RBC

    img += rng.standard_normal(img.shape, dtype=np.float32) * np.float32(2.5)
    np.clip(img, 0, 255, out=img)
    return img.astype(np.uint8), placed


@dataclass
class Traffic:
    """What a run sends: ``mosaics`` (distinct tiles, host uint8
    ``(H, W, 3)``), the bag's length, and the pool's nuclei."""

    mosaics: list[np.ndarray]
    bag_tiles: int
    nuclei: list[int]

    def tile(self, i: int) -> np.ndarray:
        """Tile ``i`` of the bag: the mosaics in turn."""
        return self.mosaics[i % len(self.mosaics)]


def make_traffic(spec: dict, seed: int, size: int) -> Traffic:
    """The traffic of ``spec`` (a traffic file) for ``seed``, in tiles
    of ``size x size`` (``size`` a whole multiple of the pool tile)."""
    pool_size = int(spec["pool_size"])
    if size % pool_size:
        raise ValueError(f"tile {size} is not a multiple of the pool tile {pool_size}")
    grid = size // pool_size
    n_pool = grid * grid
    counts = nuclei_ladder(*spec["nuclei"], n_pool)
    pool_seed = int(spec["pool_seed"])
    pool, placed = [], []
    for i in range(n_pool):
        t, k = pool_tile(rng_for(pool_seed, 1, i), pool_size, counts[i],
                         tuple(spec["radius"]), tuple(spec["rbc"]), tuple(spec["rbc_radius"]))
        pool.append(t)
        placed.append(k)
    arrange = rng_for(seed, 2)
    mosaics = []
    for _ in range(int(spec["mosaics"])):
        perm = arrange.permutation(n_pool)
        mosaic = np.empty((size, size, 3), np.uint8)
        for k in range(n_pool):
            p = np.rot90(pool[perm[k]], int(arrange.integers(4)))
            if arrange.integers(2):
                p = p[:, ::-1]
            y, x = (k // grid) * pool_size, (k % grid) * pool_size
            mosaic[y:y + pool_size, x:x + pool_size] = p
        mosaics.append(mosaic)
    return Traffic(mosaics=mosaics, bag_tiles=int(spec["bag_tiles"]), nuclei=placed)
