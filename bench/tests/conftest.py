"""Shared set-up of the benchmark's CPU tests: the harness and the port
on the path, and the cells of ``BENCHMARK.json`` cut to a size the CPU
runs in seconds (tiles of 256x256 from pool tiles of 128x128, nuclei
of the traffic files' sizes in pixels)."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

from benchkit.spec import load_cell  # noqa: E402

TINY_TILE, TINY_POOL = 256, 128


def tiny(name: str):
    """Cell ``name`` at ``TINY_TILE``: nuclei and red cells as many pixels
    across as in the traffic file, four times its nuclei per area (so
    that a small tile holds some), the bag cut to what a short window
    needs."""
    cell = load_cell(name)
    cell.config = dict(cell.config, tile=TINY_TILE)
    tr = cell.traffic
    scale = TINY_POOL / tr["pool_size"]
    lo, hi = (n * scale * scale * 4 for n in tr["nuclei"])
    cell.traffic = dict(tr, pool_size=TINY_POOL, mosaics=3, bag_tiles=60,
                        nuclei=[max(int(lo), 2), max(int(hi), 3)],
                        radius=[r / scale for r in tr["radius"]],
                        rbc_radius=[r / scale for r in tr["rbc_radius"]])
    cell.limits = dict(cell.limits, check_tiles=2)
    return cell


@pytest.fixture
def tiny_cell():
    return tiny
