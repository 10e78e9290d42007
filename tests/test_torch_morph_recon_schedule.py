"""The schedule of ``csrc/morph_recon.cu`` on the CPU.

The CUDA kernel runs a whole reconstruction in one persistent launch:
rounds separated by grid barriers, round 0 over every tile, later
rounds only over the tiles marked dirty, one working plane updated in
place (see the source's header). :func:`schedule_model` is a plain
numpy model of those rounds at a tiny tile size, with the tiles of a
round visited in a seeded random order, each visit reading its halo
from the plane as it stands. The tests hold the model, the port's plain
version, the port's numpy ``morph_reconstruct_np`` and the JAX package's
``morph_recon_pallas`` (interpret mode) to exact equality, on inputs
that cross many tile borders and corners; and show that a model that
leaves out the diagonal marks gets a wrong answer where a path crosses
a tile corner.
"""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.app.segmentation import morph_reconstruct_np
from repro_torch.kernels import ref

_N, _S, _W, _E = 1, 2, 4, 8
_NW, _NE, _SW, _SE = 16, 32, 64, 128
# (bit, tile offset dy, dx) of each neighbour whose halo holds a pixel.
_NEIGHBOURS = ((_N, -1, 0), (_S, 1, 0), (_W, 0, -1), (_E, 0, 1),
               (_NW, -1, -1), (_NE, -1, 1), (_SW, 1, -1), (_SE, 1, 1))
_DIAGONAL = _NW | _NE | _SW | _SE


def _edge_bits(rose: np.ndarray) -> int:
    """Marks of a visit from the pixels of the tile that rose."""
    bits = 0
    for bit, hit in ((_N, rose[0].any()), (_S, rose[-1].any()),
                     (_W, rose[:, 0].any()), (_E, rose[:, -1].any()),
                     (_NW, rose[0, 0]), (_NE, rose[0, -1]),
                     (_SW, rose[-1, 0]), (_SE, rose[-1, -1])):
        bits |= bit if hit else 0
    return bits


def schedule_model(marker, mask, tile=(4, 8), max_sweeps=64, seed=0, diagonal=True):
    """Numpy model of the kernel's rounds: ``(plane, rounds, visits)``.

    The image is padded to whole tiles and a one-pixel ring with -inf in
    marker and mask, so padded pixels never rise, never mark and read
    as "beyond the edge". A visit loads its tile and halo (round 0: from
    ``min(marker, mask)``; later: from the working plane), runs Jacobi
    sweeps (one order of many; the fixpoint is the same) until one
    changes nothing or ``max_sweeps`` have run, writes the tile back,
    and marks the neighbours whose halo holds a border pixel that rose,
    and itself if it stopped at the cap while still changing."""
    th, tw = tile
    h, w = mask.shape
    ty, tx = -(-h // th), -(-w // tw)
    neg = np.float32(-np.inf)
    pm = np.full((ty * th + 2, tx * tw + 2), neg, np.float32)
    pm[1:h + 1, 1:w + 1] = mask
    base = np.full_like(pm, neg)
    base[1:h + 1, 1:w + 1] = np.minimum(marker, mask)
    plane = np.full_like(pm, np.nan)  # the kernel's output is uninitialised
    plane[0, :] = plane[-1, :] = plane[:, 0] = plane[:, -1] = neg
    rng = np.random.default_rng(seed)
    dirty = np.ones((ty, tx), bool)
    rounds = visits = 0
    while True:
        src = base if rounds == 0 else plane
        marks = np.zeros((ty, tx), bool)
        for t in rng.permutation(ty * tx):
            y, x = divmod(int(t), tx)
            if not dirty[y, x]:
                continue
            visits += 1
            ys, xs = slice(y * th, y * th + th + 2), slice(x * tw, x * tw + tw + 2)
            ext = src[ys, xs].copy()
            m = pm[ys, xs][1:-1, 1:-1]
            v0 = ext[1:-1, 1:-1].copy()
            capped = True
            for _ in range(max_sweeps):
                d = np.max([ext[dy:dy + th, dx:dx + tw] for dy in range(3)
                            for dx in range(3)], axis=0)
                nv = np.minimum(d, m)
                still = bool((nv > ext[1:-1, 1:-1]).any())
                ext[1:-1, 1:-1] = nv
                if not still:
                    capped = False
                    break
            plane[y * th + 1:y * th + th + 1, x * tw + 1:x * tw + tw + 1] = ext[1:-1, 1:-1]
            bits = _edge_bits(ext[1:-1, 1:-1] > v0)
            if not diagonal:
                bits &= ~_DIAGONAL
            for bit, dy, dx in _NEIGHBOURS:
                if bits & bit and 0 <= y + dy < ty and 0 <= x + dx < tx:
                    marks[y + dy, x + dx] = True
            if capped:
                marks[y, x] = True
        rounds += 1
        if not marks.any():
            return plane[1:h + 1, 1:w + 1], rounds, visits
        dirty = marks


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def _random(h, w, seed=42):
    """The random marker/mask of the kernel tests."""
    rng = np.random.default_rng(seed)
    mask = rng.uniform(0, 255, (h, w)).astype(np.float32)
    marker = np.maximum(mask - 55.0, 0.0) * (rng.uniform(0, 1, (h, w)) > 0.6)
    return marker.astype(np.float32), mask


def _snake(h=29, w=40):
    """A one-pixel serpentine path through every row pair: the value at
    its start has to travel its whole length, crossing tiles many times."""
    mask = np.zeros((h, w), np.float32)
    for r in range(0, h, 2):
        mask[r, :] = 200.0
        if r + 1 < h:
            mask[r + 1, w - 1 if (r // 2) % 2 == 0 else 0] = 200.0
    marker = np.zeros_like(mask)
    marker[0, 0] = 255.0
    return marker, mask


def _staircase(h=24):
    """A one-pixel 8-connected staircase (i, 2i), (i, 2i + 1): every 4
    rows it steps diagonally from the bottom-right corner pixel of a
    4x8 tile to the top-left corner pixel of the next tile down and
    right."""
    w = 2 * h
    mask = np.zeros((h, w), np.float32)
    for i in range(h):
        mask[i, 2 * i] = mask[i, 2 * i + 1] = 150.0
    marker = np.zeros_like(mask)
    marker[0, 0] = 150.0
    return marker, mask


def _fill_holes(h=36, w=56, seed=5):
    """``fill_holes``'s input: the background (255 off the objects) is
    flooded from a 255 frame; square rings of objects enclose holes."""
    rng = np.random.default_rng(seed)
    obj = np.zeros((h, w), bool)
    for _ in range(6):
        y, x = int(rng.integers(0, h - 8)), int(rng.integers(0, w - 8))
        s = int(rng.integers(4, 9))
        obj[y:y + s, x:x + s] = True
        obj[y + 1:y + s - 1, x + 1:x + s - 1] = False
    inv = (~obj).astype(np.float32) * 255.0
    border = np.zeros((h, w), np.float32)
    border[0, :] = border[-1, :] = border[:, 0] = border[:, -1] = 255.0
    return np.minimum(border, inv), inv


def _constant(h=20, w=40):
    return np.full((h, w), 7.0, np.float32), np.full((h, w), 7.0, np.float32)


INPUTS = {
    "random": lambda: _random(40, 72),
    "snake": _snake,
    "staircase": _staircase,
    "fill_holes": _fill_holes,
    "constant": _constant,
    "row_1xN": lambda: _random(1, 77, seed=1),
    "column_Nx1": lambda: _random(37, 1, seed=2),
    "ragged": lambda: _random(37, 53, seed=3),
}


def _stripe(h: int) -> int:
    """The largest divisor of ``h`` up to 16: morph_recon_pallas wants
    stripes that divide the height."""
    return max(d for d in range(1, min(h, 16) + 1) if h % d == 0)


@lru_cache(maxsize=None)
def _oracles(name):
    """Inputs and the three other computations of the reconstruction."""
    marker, mask = INPUTS[name]()
    plain = ref.morph_recon_ref(torch.as_tensor(marker), torch.as_tensor(mask)).numpy()
    numpy_np = morph_reconstruct_np(marker, mask)
    pallas = np.asarray(jops.morph_recon(jnp.asarray(marker), jnp.asarray(mask),
                                         stripe=_stripe(mask.shape[0]), inner_iters=4,
                                         interpret=True))
    return marker, mask, plain, numpy_np, pallas


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(INPUTS))
@pytest.mark.parametrize("seed,max_sweeps", [(0, 64), (1, 2)])
def test_schedule_model_matches_every_reference(name, seed, max_sweeps):
    """Exact agreement of the model (any tile order, a generous or a
    tight sweep cap) with the plain version, numpy and the Pallas kernel."""
    marker, mask, plain, numpy_np, pallas = _oracles(name)
    got, rounds, visits = schedule_model(marker, mask, max_sweeps=max_sweeps, seed=seed)
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(numpy_np, plain)
    np.testing.assert_array_equal(pallas, plain)
    n_tiles = -(-mask.shape[0] // 4) * -(-mask.shape[1] // 8)
    assert rounds >= 1 and n_tiles <= visits <= rounds * n_tiles


def test_schedule_model_at_the_kernel_tile_size():
    """The source's 32x64 tiles and sweep cap on a ragged random plane."""
    marker, mask = _random(100, 150, seed=4)
    got, _, _ = schedule_model(marker, mask, tile=(32, 64), max_sweeps=128)
    want = ref.morph_recon_ref(torch.as_tensor(marker), torch.as_tensor(mask)).numpy()
    np.testing.assert_array_equal(got, want)


def test_schedule_visits_only_dirty_tiles():
    """A constant plane changes nowhere: one round over every tile. The
    snake's later rounds visit only the few tiles its front is in."""
    marker, mask = _constant()
    _, rounds, visits = schedule_model(marker, mask)
    assert (rounds, visits) == (1, 5 * 5)
    marker, mask = _snake()
    _, rounds, visits = schedule_model(marker, mask)
    n_tiles = 8 * 5
    assert rounds > 3
    assert visits < n_tiles + 2 * (rounds - 1) * 9  # a small front per round


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_schedule_without_diagonal_marks_is_wrong_at_tile_corners(seed):
    """Leaving out the diagonal marks loses the staircase's value where
    the path crosses from one tile's corner pixel to the next tile's;
    with them the model is exact."""
    marker, mask, plain, _, _ = _oracles("staircase")
    got, _, _ = schedule_model(marker, mask, seed=seed)
    np.testing.assert_array_equal(got, plain)
    bad, _, _ = schedule_model(marker, mask, seed=seed, diagonal=False)
    assert not np.array_equal(bad, plain)
    assert (bad < plain).any() and not (bad > plain).any()  # still a lower bound
