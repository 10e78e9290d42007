"""The traffic generator: the same seed gives the same tiles, another
seed others; every seed and mosaic holds the same nuclei ladder; the
density and sizes follow the traffic file's sources."""

import numpy as np
import pytest

from benchkit.spec import load_cell
from kinds.wsi_tiles import make_traffic, nuclei_ladder, pool_tile, rng_for


def _spec(name, **kw):
    spec = dict(load_cell(name).traffic, pool_size=128, mosaics=3)
    spec.update(kw)
    return spec


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40 + 3, -5])
def test_same_seed_same_tiles(seed):
    spec = _spec("wsi4k-fine.cerebrum", nuclei=[3, 6])
    a, b = make_traffic(spec, seed, 256), make_traffic(spec, seed, 256)
    assert a.nuclei == b.nuclei
    for x, y in zip(a.mosaics, b.mosaics):
        assert x.dtype == np.uint8 and x.shape == (256, 256, 3)
        assert np.array_equal(x, y)


def test_other_seed_other_tiles_same_work():
    spec = _spec("wsi4k-fine.cerebrum", nuclei=[3, 6])
    a, b = make_traffic(spec, 1, 256), make_traffic(spec, 2, 256)
    assert not np.array_equal(a.mosaics[0], b.mosaics[0])
    # Each mosaic holds every pool tile once: the same ladder of nuclei.
    assert sorted(a.nuclei) == sorted(b.nuclei)


def test_mosaics_are_arrangements_of_one_pool():
    spec = _spec("wsi4k-fine.cerebrum", nuclei=[3, 6])
    t = make_traffic(spec, 9, 256)
    blocks = lambda m: sorted(m[y:y + 128, x:x + 128].astype(np.int64).sum()  # noqa: E731
                              for y in (0, 128) for x in (0, 128))
    assert blocks(t.mosaics[0]) == blocks(t.mosaics[1]) == blocks(t.mosaics[2])
    assert t.tile(0) is t.mosaics[0] and t.tile(4) is t.mosaics[1]


def test_ladder_and_density():
    assert nuclei_ladder(48, 104, 16) == [48 + 57 * i // 16 for i in range(16)]
    tr = load_cell("wsi4k-fine.cerebrum").traffic
    # The file's sources: 62,500 cells a mm3 seen in a 5 um section, nuclei
    # 7 um across (0.012 mm), at 0.5 um a pixel: 750 nuclei a mm2.
    pool_mm = tr["pool_size"] * tr["um_per_px"] / 1000
    want = 62_500 * 0.012 * pool_mm**2
    ladder = nuclei_ladder(*tr["nuclei"], 16)
    assert sum(ladder) / 16 == pytest.approx(want, rel=0.02)
    assert ladder[0] == pytest.approx(0.75 * want, rel=0.02) and ladder[-1] <= 1.25 * want
    # Nuclei 5-10 um and red cells 7-8 um across, in pixels of the pool tile.
    px = lambda r: 2 * r * tr["pool_size"] * tr["um_per_px"]  # noqa: E731
    assert [round(px(r), 1) for r in tr["radius"]] == [5.0, 10.0]
    assert [round(px(r), 1) for r in tr["rbc_radius"]] == [7.0, 8.0]


def test_pool_tile_places_what_it_can():
    rng = rng_for(3, 1, 0)
    tile, placed = pool_tile(rng, 256, 12, (0.02, 0.05), (0, 4), (0.015, 0.03))
    assert 0 < placed <= 12
    # Nuclei are dark: the tile's darkest pixels are far below the stroma.
    gray = tile.astype(np.float32) @ np.array([0.299, 0.587, 0.114], np.float32)
    assert gray.min() < 150 < np.median(gray)


# The serving traffic: prompts drawn as the port's serve_requests draws them.

def test_serving_prompts_from_the_seed():
    from kinds.serve import make_prompts

    spec = {"requests": 6, "prompt_len": 40}
    for seed in (0, 7, 2**31 + 11, 2**62 + 3):
        a, b = make_prompts(spec, seed, 512), make_prompts(spec, seed, 512)
        assert a.dtype == np.int32 and a.shape == (6, 40) and np.array_equal(a, b)
        assert 0 <= a.min() and a.max() < 512
    assert not np.array_equal(make_prompts(spec, 1, 512), make_prompts(spec, 2, 512))
    # One request after another from one generator, as serve_requests draws.
    rs = np.random.default_rng(9)
    want = [rs.integers(0, 512, 40).astype(np.int32) for _ in range(6)]
    assert np.array_equal(make_prompts(spec, 9, 512), np.stack(want))
