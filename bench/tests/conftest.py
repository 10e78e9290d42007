"""Shared set-up of the benchmark's CPU tests: the harness and the port
on the path, and the cells of ``BENCHMARK.json`` cut to a size the CPU
runs in seconds: a WSI cell in tiles of 256x256 from pool tiles of
128x128, nuclei of the traffic files' sizes in pixels; a serving cell
at the port's smoke configuration of its model, prompts of 32 tokens
and answers of 8, batches of 4."""

import dataclasses
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

from benchkit.spec import load_cell  # noqa: E402

TINY_TILE, TINY_POOL = 256, 128


def tiny(name: str):
    """Cell ``name`` at a size the CPU runs in seconds."""
    cell = load_cell(name)
    return (tiny_wsi if cell.config["driver"] == "wsi_manager" else tiny_serve)(cell)


def tiny_serve(cell):
    """A serving cell at the port's smoke configuration of its model
    (every number of the configuration file that the smoke one has),
    prompts of 32 tokens, answers of 8, batches of 4, two requests of a
    window compared at four steps."""
    from repro_torch.configs import get_smoke_config

    smoke = dataclasses.asdict(get_smoke_config(cell.config["arch"]))
    cell.config = dict(cell.config, smoke=True, serve=dict(cell.config["serve"], batch_size=4),
                       **{k: v for k, v in smoke.items() if k in cell.config and k != "name"})
    cell.traffic = dict(cell.traffic, prompt_len=32, max_new=8, max_len=64, requests=512)
    cell.limits = dict(cell.limits, check_requests=2, check_steps=[0, 2, 4, 7])
    return cell


def tiny_wsi(cell):
    """A WSI cell at ``TINY_TILE``: nuclei and red cells as many pixels
    across as in the traffic file, four times its nuclei per area (so
    that a small tile holds some), the bag cut to what a short window
    needs."""
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
