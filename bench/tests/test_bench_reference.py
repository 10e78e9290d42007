"""The plain reference against the port's numpy (``cpu``) path and its
``gpu`` variants on the CPU, on small tiles of both traffic mixes."""

import numpy as np
import pytest
import torch

from benchkit.compare import compare
from benchkit.spec import load_module
from benchkit.tiles import make_traffic
from conftest import TINY_TILE, tiny

from repro_torch.app.pipeline import run_tile

#: The numpy path sums in float64 as the reference does; the ``gpu``
#: variants sum in float32 (the std column cancels: ~6e-5 measured).
CPU_BAR, ACCEL_BAR = 1e-6, 1e-3


@pytest.fixture(scope="module")
def reference():
    return load_module("reference", "wsi")


@pytest.mark.parametrize("name", ["wsi4k-fine.cerebrum", "wsi4k-fused.cerebrum"])
def test_reference_matches_the_port(reference, name):
    cell = tiny(name)
    tile = make_traffic(cell.traffic, 20261018, TINY_TILE).tile(0)
    want = reference.run_tile(tile, "cpu")
    assert 0 < want["n_objects"] <= reference.MAX_OBJECTS
    numpy_path = compare(run_tile(tile, "cpu"), want)
    accel = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
             for k, v in run_tile(tile, "gpu", device="cpu").items()}
    accel_path = compare(accel, want)
    for numbers, bar in ((numpy_path, CPU_BAR), (accel_path, ACCEL_BAR)):
        assert numbers["n_objects"] == 0 and numbers["labels"] == 0, numbers
        feats = {k: v for k, v in numbers.items() if k.startswith("feat_")}
        assert len(feats) == 5 and max(feats.values()) < bar, numbers


def test_reference_outputs(reference):
    cell = tiny("wsi4k-fine.cerebrum")
    tile = make_traffic(cell.traffic, 3, TINY_TILE).tile(1)
    out = reference.run_tile(tile, "cpu")
    n = out["n_objects"]
    assert out["objects"].dtype == np.int32 and out["objects"].max() == n
    assert out["feat_pixel"].shape == (reference.MAX_OBJECTS, 3)
    assert out["feat_haralick"].shape == (4,)
    # Every kept object has an area; the rows past n_objects are empty.
    assert (out["feat_morph"][:n, 0] > 0).all() and not out["feat_morph"][n:].any()
