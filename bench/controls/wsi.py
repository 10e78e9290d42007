"""The control of the WSI cells: the plain reference put in the
program's place and computed in the precision below the
configuration's (bfloat16 for its float32 planes and sums), judged by
the cells' comparison against the reference in its own precision, on
the first ``check_tiles`` mosaics of a seed's traffic at the cell's
tile size."""

from __future__ import annotations

from benchkit.compare import worst
from benchkit.spec import load_module
from kinds.wsi_tiles import make_traffic

__all__ = ["control_readings", "readings"]


def control_readings(cell, seed: int, tiles: int, device: str) -> dict[str, float]:
    """The worst number of each kind over ``tiles`` mosaics of ``seed``:
    the reference in bfloat16 against the reference as configured."""
    import torch

    reference = load_module("reference", cell.config["reference"], cell.bench)
    comparison = load_module("compare", cell.config["compare"], cell.bench)
    traffic = make_traffic(cell.traffic, seed, int(cell.config["tile"]))
    per_tile = []
    for i in range(tiles):
        tile = traffic.tile(i)
        want = reference.run_tile(tile, device)
        got = reference.run_tile(tile, device, dt=torch.bfloat16, acc=torch.bfloat16)
        per_tile.append(comparison.compare(got, want))
    return worst(per_tile)


def readings(cell, seed: int, device: str, controls: bool = True) -> dict[str, dict[str, float]]:
    """The control's numbers on ``seed`` (none without ``controls``: the
    sound program's readings come from the benchmark's runs)."""
    if not controls:
        return {}
    return {"bfloat16": control_readings(cell, seed, int(cell.limits["check_tiles"]), device)}
