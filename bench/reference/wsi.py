"""Plain reference of the WSI workflow: segmentation then features of
one RGB tile, in plain PyTorch operations on any device.

It states the semantics of the paper's pipeline as the port's workflow
defines them (``rbc_detection`` ... ``bwlabel``, then the stain
deconvolution and the five feature ops), with no kernel, no runtime
and no batching: every geodesic reconstruction is a Jacobi sweep of
``min(dilate(r), mask)`` to its fixpoint, every connected-component
labelling a sweep of 8-neighbour minima over linear ids. The fused and
the fine-grained workflows compute the same outputs, so one reference
serves both.

``dt`` is the precision of the image planes (float32, as the
configuration states) and ``acc`` that of the per-object and co-
occurrence sums (float64 here, as the numpy path sums them); the
control computes both in bfloat16.

It imports only torch and numpy, and takes nothing that the program
made: the tile is the harness's.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["MAX_OBJECTS", "run_sample", "run_tile"]

MAX_OBJECTS = 256          # objects per tile that features are kept for
MIN_AREA, MAX_AREA = 24, 8192
GLCM_LEVELS = 8
CANNY_LO, CANNY_HI = 20.0, 50.0

_STAINS = np.array([[0.650, 0.704, 0.286],     # hematoxylin
                    [0.072, 0.990, 0.105],     # eosin
                    [0.268, 0.570, 0.776]],    # residual
                   dtype=np.float32)
_DECONV = [[float(x) for x in row] for row in np.linalg.inv(_STAINS.T).astype(np.float32)]
_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
_SOBEL_Y = tuple(zip(*_SOBEL_X))


def _window3(a: torch.Tensor, op, fill) -> torch.Tensor:
    """3x3 window reduction, ``fill`` beyond the edges."""
    h, w = a.shape
    p = F.pad(a, (1, 1, 1, 1), value=fill)
    out = p[1:1 + h, 1:1 + w]
    for dy in range(3):
        for dx in range(3):
            if (dy, dx) != (1, 1):
                out = op(out, p[dy:dy + h, dx:dx + w])
    return out


def _erode(a: torch.Tensor) -> torch.Tensor:
    fill = float("inf") if a.is_floating_point() else torch.iinfo(a.dtype).max
    return _window3(a, torch.minimum, fill)


def _dilate(a: torch.Tensor) -> torch.Tensor:
    fill = float("-inf") if a.is_floating_point() else torch.iinfo(a.dtype).min
    return _window3(a, torch.maximum, fill)


def _reconstruct(marker: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Grayscale reconstruction of ``marker`` under ``mask`` (8-conn)."""
    r = torch.minimum(marker, mask)
    while True:
        nxt = torch.minimum(F.max_pool2d(r[None, None], 3, stride=1, padding=1)[0, 0], mask)
        if torch.equal(nxt, r):
            return r
        r = nxt


def _label(fg: torch.Tensor) -> torch.Tensor:
    """8-connected components: each pixel the least linear id (1-based)
    of its component, int32, 0 on background."""
    h, w = fg.shape
    big = h * w + 2
    ids = torch.arange(1, h * w + 1, dtype=torch.int32, device=fg.device).reshape(h, w)
    lab = torch.where(fg, ids, big)
    while True:
        nxt = torch.where(fg, torch.minimum(_window3(lab, torch.minimum, big), lab), big)
        if torch.equal(nxt, lab):
            return torch.where(fg, lab, 0)
        lab = nxt


def _sobel_mag(gray: torch.Tensor) -> torch.Tensor:
    h, w = gray.shape
    pad = F.pad(gray[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]

    def conv(k):
        out = torch.zeros_like(gray)
        for dy in range(3):
            for dx in range(3):
                out = out + k[dy][dx] * pad[dy:dy + h, dx:dx + w]
        return out

    gx, gy = conv(_SOBEL_X), conv(_SOBEL_Y)
    return torch.sqrt(gx * gx + gy * gy)


def segment(rgb: torch.Tensor, dt: torch.dtype) -> dict:
    """The segmentation stage: the filled mask, the object labels
    (``1..n``, at most ``MAX_OBJECTS``) and their count."""
    f = rgb.to(dt)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    gray = 0.299 * r + 0.587 * g + 0.114 * b
    rbc = r / (g + b + 1.0) > 1.0
    fg = (gray < gray.mean() - 0.35 * gray.std(correction=0)) & ~rbc

    x = fg.to(torch.uint8)
    for _ in range(2):
        x = _erode(x)
    for _ in range(2):
        x = _dilate(x)
    fg_open = x.bool()

    inv = 255.0 - gray
    marker = inv
    for _ in range(8):
        marker = _erode(marker)
    nuclei = ((inv - _reconstruct(marker, inv)) > 25.0) & fg_open

    lab = _label(nuclei)
    flat = lab.reshape(-1).long()
    size = torch.bincount(flat, minlength=flat.numel() + 2)[flat]
    kept = ((size >= MIN_AREA) & (size <= MAX_AREA) & (flat > 0)).reshape(lab.shape)

    holes_inv = (~kept).to(dt) * 255.0
    border = torch.zeros_like(holes_inv)
    border[0, :] = border[-1, :] = border[:, 0] = border[:, -1] = 255.0
    mask = kept | (_reconstruct(torch.minimum(border, holes_inv), holes_inv) == 0)

    dist = torch.zeros(mask.shape, dtype=dt, device=mask.device)
    cur = mask
    for _ in range(64):
        dist = dist + cur.to(dt)
        cur = _erode(cur.to(torch.uint8)).bool()
    markers = (dist - _reconstruct(dist - 1.0, dist) >= 1.0 - 1e-3) & mask

    lab = _label(markers)
    top = torch.where(mask, dist, 0.0).max()
    for k in range(65):
        grow = mask & (dist >= top - float(k))
        while True:
            neigh = _window3(lab, torch.maximum, 0)
            adopt = grow & (lab == 0) & (neigh > 0)
            lab = torch.where(adopt, neigh, lab)
            if not bool(adopt.any()):
                break
    labels = torch.where(mask, lab, 0)

    lab = _label(labels > 0)
    flat = lab.reshape(-1).long()
    present = torch.zeros(flat.numel() + 2, dtype=torch.int32, device=lab.device)
    present[flat] = 1
    present[0] = 0
    rank = torch.cumsum(present, 0, dtype=torch.int32)
    objects = torch.where(lab > 0, rank[flat].reshape(lab.shape), 0)
    objects = torch.where(objects <= MAX_OBJECTS, objects, 0).to(torch.int32)
    return {"gray": gray, "mask": mask, "objects": objects,
            "n_objects": min(int(rank[-1]), MAX_OBJECTS)}


def _seg_sum(values: torch.Tensor, objects: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    out = torch.zeros(MAX_OBJECTS + 1, dtype=acc, device=values.device)
    return out.index_add_(0, objects.reshape(-1).long(), values.reshape(-1).to(acc))[1:]


def _obj_stats(values: torch.Tensor, objects: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    v = values.to(acc)
    s, s2 = _seg_sum(v, objects, acc), _seg_sum(v * v, objects, acc)
    cnt = _seg_sum(torch.ones_like(v), objects, acc)
    safe = torch.clamp_min(cnt, 1.0)
    mean = s / safe
    return torch.stack([mean, torch.sqrt(torch.clamp_min(s2 / safe - mean * mean, 0.0)), cnt], -1)


def features(rgb: torch.Tensor, seg: dict, dt: torch.dtype, acc: torch.dtype) -> dict:
    """The features stage: ``feat_pixel``, ``feat_gradient``,
    ``feat_haralick``, ``feat_canny``, ``feat_morph``."""
    objects, gray, mask = seg["objects"], seg["gray"], seg["mask"]
    od = [-torch.log10((rgb[..., c].to(dt) + 1.0) / 256.0) for c in range(3)]
    m = _DECONV[0]
    hema = m[0] * od[0] + m[1] * od[1] + m[2] * od[2]
    mag = _sobel_mag(gray)

    lo, hi = gray.min(), gray.max()
    q = ((gray - lo) / torch.clamp_min(hi - lo, 1e-6) * (GLCM_LEVELS - 1)).to(torch.int32)
    h, w = q.shape
    pairs = torch.zeros(GLCM_LEVELS * GLCM_LEVELS, dtype=torch.int64, device=q.device)
    for dy, dx in ((0, 1), (1, 0)):
        a = q[:h - dy, :w - dx].reshape(-1).long()
        b = q[dy:, dx:].reshape(-1).long()
        both = (mask[:h - dy, :w - dx] & mask[dy:, dx:]).reshape(-1)
        pairs += torch.bincount(torch.where(both, a * GLCM_LEVELS + b, GLCM_LEVELS ** 2),
                                minlength=GLCM_LEVELS ** 2 + 1)[:GLCM_LEVELS ** 2]
    c = pairs.reshape(GLCM_LEVELS, GLCM_LEVELS)
    glcm = (c + c.T).to(acc)
    glcm = glcm / torch.clamp_min(glcm.sum(), 1e-9)
    i, j = torch.meshgrid(torch.arange(GLCM_LEVELS, device=q.device),
                          torch.arange(GLCM_LEVELS, device=q.device), indexing="ij")
    haralick = torch.stack([(glcm * (i - j) ** 2).sum(), (glcm ** 2).sum(),
                            (glcm / (1.0 + (i - j).abs())).sum(),
                            -(glcm * torch.log(glcm + 1e-12)).sum()])

    strong = (mag >= CANNY_HI).to(dt) * 255.0
    weak = (mag >= CANNY_LO).to(dt) * 255.0
    edges = (_reconstruct(strong, weak) > 0).to(acc)
    ones = torch.ones_like(edges)
    canny = _seg_sum(edges, objects, acc) / torch.clamp_min(_seg_sum(ones, objects, acc), 1.0)

    fg = objects > 0
    pad = F.pad(fg.to(torch.uint8), (1, 1, 1, 1)).bool()
    interior = pad[:-2, 1:-1] & pad[2:, 1:-1] & pad[1:-1, :-2] & pad[1:-1, 2:]
    area = _seg_sum(fg.to(acc), objects, acc)
    per = _seg_sum((fg & ~interior).to(acc), objects, acc)
    circ = 4.0 * math.pi * area / torch.clamp_min(per * per, 1.0)
    morph = torch.stack([area, per, torch.clamp_max(circ, 4.0)], -1)

    return {"feat_pixel": _obj_stats(hema, objects, acc),
            "feat_gradient": _obj_stats(mag, objects, acc),
            "feat_haralick": haralick, "feat_canny": canny, "feat_morph": morph}


def run_tile(tile: np.ndarray, device, dt: torch.dtype = torch.float32,
             acc: torch.dtype = torch.float64) -> dict:
    """Both stages on one ``(H, W, 3) uint8`` tile; outputs on the
    host: ``objects`` (int32), ``n_objects`` and each ``feat_*``."""
    rgb = torch.as_tensor(np.ascontiguousarray(tile), device=device)
    seg = segment(rgb, dt)
    out = {k: v.double().cpu().numpy() for k, v in features(rgb, seg, dt, acc).items()}
    out["objects"] = seg["objects"].cpu().numpy()
    out["n_objects"] = seg["n_objects"]
    return out


def run_sample(tile: np.ndarray, device) -> dict:
    """The reference's outputs of one compared tile, as configured."""
    return run_tile(tile, device)
