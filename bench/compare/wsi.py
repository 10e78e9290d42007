"""The comparison of the WSI cells: the program's outputs of a tile
against the plain reference's, one number per output.

* ``n_objects``: the largest difference in the object count of a tile.
* ``labels``: the largest share of a tile's pixels whose object label
  differs.
* ``feat_*``: the largest error of a feature, as a share of the largest
  magnitude the reference gives that feature over the tile's objects
  (a column of a per-object table); a tile-level vector (Haralick's
  four numbers) is held element by element. A value that is not finite
  reads as infinity.

The harness takes the worst of each over the tiles compared.
"""

from __future__ import annotations

import numpy as np

__all__ = ["compare"]

#: A 1-D output this short is a tile-level vector, held element by element.
TILE_LEVEL = 16


def feature_error(got: np.ndarray, want: np.ndarray) -> float:
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    if g.shape != w.shape:
        return float("inf")
    if not np.isfinite(g).all():
        return float("inf")
    if g.ndim == 1:
        g, w = (g[None, :], w[None, :]) if g.size <= TILE_LEVEL else (g[:, None], w[:, None])
    scale = np.maximum(np.abs(w).max(axis=0), np.finfo(np.float64).tiny)
    return float((np.abs(g - w) / scale).max()) if g.size else 0.0


def compare(got: dict, want: dict) -> dict[str, float]:
    """The numbers of one tile."""
    out = {"n_objects": float(abs(int(got["n_objects"]) - int(want["n_objects"])))}
    g, w = np.asarray(got["objects"]), np.asarray(want["objects"])
    out["labels"] = float((g != w).mean()) if g.shape == w.shape else 1.0
    for key in sorted(k for k in want if k.startswith("feat_")):
        out[key] = feature_error(got[key], want[key]) if key in got else float("inf")
    return out
