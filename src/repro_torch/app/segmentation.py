"""Segmentation-stage operations (paper Fig 1, Table I).

Every operation exists as a *function variant* pair:

* ``*_cpu``  — straightforward NumPy (the OpenCV/Vincent role), copied
  from the JAX package,
* ``*_accel`` — PyTorch on an explicit device (``device="cuda"`` by
  default). Every geodesic reconstruction goes through
  :func:`repro_torch.kernels.ops.morph_recon`: the hand-written kernel
  for a CUDA tensor, its plain version on the CPU.

State flows through the pipeline as a dict:

    rgb -> gray, fg (foreground mask) -> recon -> mask -> dist
        -> markers -> labels (watershed) -> objects (bwlabel)

The accelerated variants run the JAX package's ``jax.jit`` programs
eagerly: its ``lax.while_loop`` fixpoints (connected-component labels,
the watershed flood) become Python loops that read one change flag on
the host per sweep (through ``_device.host_sync``); :data:`SWEEPS`
counts those sweeps. Label maps stay in int32 throughout (ids reach
h*w).
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops as K
from ._device import host_sync, resolve_device, to_device

__all__ = [
    "MAX_OBJECTS",
    "SWEEPS",
    "to_gray",
    "rbc_detection_cpu", "rbc_detection_accel",
    "morph_open_cpu", "morph_open_accel",
    "recon_to_nuclei_cpu", "recon_to_nuclei_accel",
    "area_threshold_cpu", "area_threshold_accel",
    "fill_holes_cpu", "fill_holes_accel",
    "pre_watershed_cpu", "pre_watershed_accel",
    "watershed_cpu", "watershed_accel",
    "bwlabel_cpu", "bwlabel_accel",
    "label_image_np", "morph_reconstruct_np",
]

MAX_OBJECTS = 256  # per-tile cap used by fixed-shape accel kernels

#: Host-synchronised fixpoint loops of the accel ops: ``label_calls`` /
#: ``label_sweeps`` (connected components), ``watershed_levels`` /
#: ``watershed_sweeps`` (the level flood). Reset by assigning 0 or
#: ``SWEEPS.clear()``.
SWEEPS: Counter = Counter()


# --------------------------------------------------------------------------
# NumPy building blocks (CPU variants)
# --------------------------------------------------------------------------


def _shift(a: np.ndarray, dy: int, dx: int, fill) -> np.ndarray:
    out = np.full_like(a, fill)
    h, w = a.shape
    ys = slice(max(dy, 0), h + min(dy, 0))
    xs = slice(max(dx, 0), w + min(dx, 0))
    yd = slice(max(-dy, 0), h + min(-dy, 0))
    xd = slice(max(-dx, 0), w + min(-dx, 0))
    out[yd, xd] = a[ys, xs]
    return out


_N8 = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]


def _dilate_np(a: np.ndarray) -> np.ndarray:
    out = a.copy()
    for dy, dx in _N8:
        np.maximum(out, _shift(a, dy, dx, a.dtype.type(0) if a.dtype != bool else False), out)
    return out


def _erode_np(a: np.ndarray) -> np.ndarray:
    fill = a.dtype.type(255) if a.dtype == np.uint8 else (
        True if a.dtype == bool else a.dtype.type(np.iinfo(a.dtype).max if np.issubdtype(a.dtype, np.integer) else np.inf)
    )
    out = a.copy()
    for dy, dx in _N8:
        np.minimum(out, _shift(a, dy, dx, fill), out)
    return out


def morph_reconstruct_np(marker: np.ndarray, mask: np.ndarray,
                         max_iters: int = 4096) -> np.ndarray:
    """Vincent's grayscale reconstruction by iterated geodesic dilation."""
    r = np.minimum(marker, mask)
    for _ in range(max_iters):
        nxt = np.minimum(_dilate_np(r), mask)
        if np.array_equal(nxt, r):
            break
        r = nxt
    return r


def label_image_np(fg: np.ndarray, max_iters: int = 65536) -> np.ndarray:
    """Connected components (8-conn) by iterative min-label propagation."""
    h, w = fg.shape
    lab = np.where(fg, np.arange(1, h * w + 1, dtype=np.int32).reshape(h, w), 0)
    big = np.int32(h * w + 2)
    for _ in range(max_iters):
        cand = np.where(fg, lab, big)
        nxt = cand.copy()
        for dy, dx in _N8:
            np.minimum(nxt, _shift(cand, dy, dx, big), nxt)
        nxt = np.where(fg, np.minimum(nxt, cand), 0)
        if np.array_equal(nxt, lab):
            break
        lab = nxt
    return lab


def to_gray(rgb: np.ndarray) -> np.ndarray:
    rgb = np.asarray(rgb, np.float32)
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


# --------------------------------------------------------------------------
# torch building blocks (accelerator variants)
# --------------------------------------------------------------------------


def window3(a: torch.Tensor, op, fill) -> torch.Tensor:
    """3x3 "SAME" window reduction (``op`` = torch.maximum/minimum) of a
    2-D tensor of any dtype, ``fill`` beyond the edges — the
    ``lax.reduce_window`` of the JAX package, as shifted slices."""
    h, w = a.shape
    p = F.pad(a, (1, 1, 1, 1), value=fill)
    out = p[1 : 1 + h, 1 : 1 + w]
    for dy in range(3):
        for dx in range(3):
            if (dy, dx) != (1, 1):
                out = op(out, p[dy : dy + h, dx : dx + w])
    return out


def _erode_t(a: torch.Tensor) -> torch.Tensor:
    fill = float("inf") if a.is_floating_point() else torch.iinfo(a.dtype).max
    return window3(a, torch.minimum, fill)


def _dilate_t(a: torch.Tensor) -> torch.Tensor:
    fill = float("-inf") if a.is_floating_point() else torch.iinfo(a.dtype).min
    return window3(a, torch.maximum, fill)


def _label_t(fg: torch.Tensor) -> torch.Tensor:
    """8-connected components: min linear id (1-based) per component,
    int32, 0 on background."""
    h, w = fg.shape
    big = h * w + 2
    idx = torch.arange(1, h * w + 1, dtype=torch.int32, device=fg.device)
    lab = torch.where(fg, idx.reshape(h, w), big)
    SWEEPS["label_calls"] += 1
    while True:
        SWEEPS["label_sweeps"] += 1
        nxt = window3(lab, torch.minimum, big)
        nxt = torch.where(fg, torch.minimum(nxt, lab), big)
        if host_sync("label_sweep", torch.equal, nxt, lab):
            break
        lab = nxt
    return torch.where(fg, lab, 0)


def _gray_t(rgb: torch.Tensor) -> torch.Tensor:
    rgb = rgb.float()
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


# --------------------------------------------------------------------------
# Pipeline operations — CPU variants
# --------------------------------------------------------------------------


def rbc_detection_cpu(rgb: np.ndarray) -> dict:
    rgb_f = np.asarray(rgb, np.float32)
    ratio = rgb_f[..., 0] / (rgb_f[..., 1] + rgb_f[..., 2] + 1.0)
    rbc = ratio > 1.0
    gray = to_gray(rgb)
    # Candidate foreground: dark (basophilic) pixels, minus RBCs.
    fg = (gray < np.float32(gray.mean()) - 0.35 * gray.std()) & ~rbc
    return {"rgb": np.asarray(rgb), "gray": gray, "fg": fg, "rbc": rbc}


def morph_open_cpu(state: dict) -> dict:
    fg = state["fg"].astype(np.uint8)
    opened = fg
    for _ in range(2):  # erosion radius 2 (disk-approx via 3x3 iterated)
        opened = _erode_np(opened)
    for _ in range(2):
        opened = _dilate_np(opened)
    return {**state, "fg_open": opened.astype(bool)}


def recon_to_nuclei_cpu(state: dict, erosions: int = 8, thresh: float = 25.0) -> dict:
    """Opening-by-reconstruction top-hat: erode past nucleus scale,
    reconstruct the background plateau, threshold the residual domes."""
    gray, fg = state["gray"], state["fg_open"]
    inv = 255.0 - gray  # nuclei bright in inverted image
    marker = inv
    for _ in range(erosions):
        marker = _erode_np(marker)
    recon = morph_reconstruct_np(marker, inv)
    nuclei = ((inv - recon) > thresh) & fg
    return {**state, "recon": recon, "nuclei": nuclei}


def area_threshold_cpu(state: dict, min_area: int = 24, max_area: int = 8192) -> dict:
    lab = label_image_np(state["nuclei"])
    ids, counts = np.unique(lab[lab > 0], return_counts=True)
    keep = ids[(counts >= min_area) & (counts <= max_area)]
    mask = np.isin(lab, keep)
    return {**state, "mask_at": mask}


def fill_holes_cpu(state: dict) -> dict:
    mask = state["mask_at"]
    inv = (~mask).astype(np.uint8) * 255
    border = np.zeros_like(inv)
    border[0, :], border[-1, :], border[:, 0], border[:, -1] = 255, 255, 255, 255
    recon = morph_reconstruct_np(np.minimum(border, inv), inv)
    filled = mask | (recon == 0)
    return {**state, "mask": filled}


def pre_watershed_cpu(state: dict) -> dict:
    mask = state["mask"]
    # Chamfer-ish distance: number of erosions until a pixel disappears.
    dist = np.zeros(mask.shape, np.float32)
    cur = mask.copy()
    for _ in range(64):
        if not cur.any():
            break
        dist += cur
        cur = _erode_np(cur)
    # Markers: regional maxima of smoothed distance.
    d = morph_reconstruct_np(dist - 1.0, dist)
    markers = (dist - d >= 1.0 - 1e-3) & mask
    return {**state, "dist": dist, "markers": markers}


def watershed_cpu(state: dict) -> dict:
    mask, markers, dist = state["mask"], state["markers"], state["dist"]
    lab = label_image_np(markers)
    # Flood outward from markers in decreasing-distance order.
    maxd = int(dist.max()) if mask.any() else 0
    for level in range(maxd, -1, -1):
        grow = mask & (dist >= level)
        for _ in range(256):
            cand = lab.copy()
            frontier = grow & (lab == 0)
            if not frontier.any():
                break
            changed = False
            neigh = np.zeros_like(lab)
            for dy, dx in _N8:
                np.maximum(neigh, _shift(lab, dy, dx, np.int32(0)), neigh)
            adopt = frontier & (neigh > 0)
            if adopt.any():
                cand[adopt] = neigh[adopt]
                changed = True
            lab = cand
            if not changed:
                break
    return {**state, "labels": np.where(mask, lab, 0)}


def bwlabel_cpu(state: dict) -> dict:
    lab = label_image_np(state["labels"] > 0)
    # Compact to 1..n (n capped at MAX_OBJECTS for fixed-shape features).
    ids = np.unique(lab[lab > 0])[:MAX_OBJECTS]
    remap = np.zeros(int(lab.max()) + 1, np.int32)
    remap[ids] = np.arange(1, len(ids) + 1, dtype=np.int32)
    objects = remap[lab]
    return {**state, "objects": objects, "n_objects": int(len(ids))}


# --------------------------------------------------------------------------
# Pipeline operations — accelerator variants (torch on ``device``)
# --------------------------------------------------------------------------


def rbc_detection_accel(rgb, device="cuda") -> dict:
    """The first op: uploads the tile, which stays on the device as
    ``state["rgb"]`` for the feature ops."""
    dev = resolve_device(device)
    rgb = to_device(rgb, dev)
    rgb_f = rgb.float()
    ratio = rgb_f[..., 0] / (rgb_f[..., 1] + rgb_f[..., 2] + 1.0)
    rbc = ratio > 1.0
    gray = _gray_t(rgb)
    # Population std, as jnp/np .std() (torch defaults to correction=1).
    fg = (gray < gray.mean() - 0.35 * gray.std(correction=0)) & ~rbc
    return {"rgb": rgb, "gray": gray, "fg": fg, "rbc": rbc}


def morph_open_accel(state: dict, device="cuda") -> dict:
    dev = resolve_device(device)
    x = to_device(state["fg"], dev).to(torch.uint8)
    for _ in range(2):
        x = _erode_t(x)
    for _ in range(2):
        x = _dilate_t(x)
    return {**state, "fg_open": x.bool()}


def recon_to_nuclei_accel(state: dict, device="cuda") -> dict:
    dev = resolve_device(device)
    gray = to_device(state["gray"], dev).float()
    fg = to_device(state["fg_open"], dev)
    inv = 255.0 - gray
    marker = inv
    for _ in range(8):
        marker = _erode_t(marker)
    recon = K.morph_recon(marker, inv)
    nuclei = ((inv - recon) > 25.0) & fg
    return {**state, "recon": recon, "nuclei": nuclei}


def area_threshold_accel(state: dict, device="cuda", min_area: int = 24,
                         max_area: int = 8192) -> dict:
    dev = resolve_device(device)
    lab = _label_t(to_device(state["nuclei"], dev))
    flat = lab.reshape(-1).long()
    # Histogram of label sizes (integer bincount over the dense id range).
    counts = host_sync("bincount", torch.bincount, flat, minlength=flat.numel() + 2)
    sz = counts[flat]
    keep = (sz >= min_area) & (sz <= max_area) & (flat > 0)
    return {**state, "mask_at": keep.reshape(lab.shape)}


def fill_holes_accel(state: dict, device="cuda") -> dict:
    dev = resolve_device(device)
    mask = to_device(state["mask_at"], dev)
    inv = (~mask).float() * 255.0
    border = torch.zeros(mask.shape, dtype=torch.float32, device=dev)
    border[0, :] = 255.0
    border[-1, :] = 255.0
    border[:, 0] = 255.0
    border[:, -1] = 255.0
    recon = K.morph_recon(torch.minimum(border, inv), inv)
    return {**state, "mask": mask | (recon == 0)}


def pre_watershed_accel(state: dict, device="cuda") -> dict:
    dev = resolve_device(device)
    mask = to_device(state["mask"], dev)
    dist = torch.zeros(mask.shape, dtype=torch.float32, device=dev)
    cur = mask
    for _ in range(64):
        dist = dist + cur.float()
        cur = _erode_t(cur.to(torch.uint8)).bool()
    d = K.morph_recon(dist - 1.0, dist)
    markers = (dist - d >= 1.0 - 1e-3) & mask
    return {**state, "dist": dist, "markers": markers}


def watershed_accel(state: dict, device="cuda") -> dict:
    dev = resolve_device(device)
    mask = to_device(state["mask"], dev)
    markers = to_device(state["markers"], dev)
    dist = to_device(state["dist"], dev).float()
    lab = _label_t(markers)
    maxd = torch.where(mask, dist, 0.0).max()
    for k in range(65):
        level = maxd - float(k)
        grow = mask & (dist >= level)
        SWEEPS["watershed_levels"] += 1
        while True:
            SWEEPS["watershed_sweeps"] += 1
            neigh = window3(lab, torch.maximum, 0)
            adopt = grow & (lab == 0) & (neigh > 0)
            lab = torch.where(adopt, neigh, lab)
            if not host_sync("watershed_sweep", bool, adopt.any()):
                break
    return {**state, "labels": torch.where(mask, lab, 0)}


def bwlabel_accel(state: dict, device="cuda") -> dict:
    """Dense 1..n renumbering (cap MAX_OBJECTS); ``n_objects`` leaves the
    device as a Python int."""
    dev = resolve_device(device)
    lab = _label_t(to_device(state["labels"], dev) > 0)
    flat = lab.reshape(-1).long()
    present = torch.zeros(flat.numel() + 2, dtype=torch.int32, device=dev)
    # In-place fills: an indexed assignment of a Python number uploads it
    # from pageable memory and blocks the host.
    present.index_fill_(0, flat, 1)
    present[0].fill_(0)
    rank = torch.cumsum(present, 0, dtype=torch.int32)  # dense renumbering 1..n
    objects = torch.where(lab > 0, rank[flat].reshape(lab.shape), 0)
    n = host_sync("n_objects", int, rank[-1])
    objects = torch.where(objects <= MAX_OBJECTS, objects, 0)
    return {
        **state,
        "objects": objects.to(torch.int32),
        "n_objects": min(n, MAX_OBJECTS),
    }
