"""The schedule of ``csrc/feature_fused.cu`` and ``csrc/sobel_stats.cu`` on the CPU.

Both kernels walk the image as ``csrc/strip_stencil.cuh`` describes. The
host plans strips ``TW`` pixels wide cut into runs of ``rows`` rows
(:func:`FF.plan`, called here as the wrappers call it). A block converts
its input rows (image rows y0 - 1 .. y0 + rows, clamped) ``RPS`` at a
time into a ring of ``RING`` rows of the stencil's plane (luminance, or
the plane itself), computing feature_fused's stain planes on its own
rows as it goes, then emits output rows j from ring rows j, j+1, j+2.
Each thread keeps its moments in float32 in its own order; the block
reduces them by warp shuffles, then the warps in order; the last block
merges the blocks' rows in block order, in double.

:func:`walk` is a plain numpy model of that schedule and arithmetic. The
tests hold it to the port's plain versions and to the JAX package's
Pallas kernels (interpret mode) at the tolerances of
``tests/test_torch_kernels.py`` (planes rtol 3e-5, atol 1e-4; Sobel
magnitudes rtol 1e-5, atol 1e-4, and within one ulp of the plain
version, whose CPU sqrt is not always correctly rounded; moments rtol
1e-4), over ragged shapes. They check that every pixel is written
exactly once and every ring row a stencil reads holds the row it
should; that the header's constants are the wrappers'; how the fast
paths' 16-byte copies place a row segment in shared memory; and which
views take the fast paths.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import _build, ref
from repro_torch.kernels import feature_fused as FF
from repro_torch.kernels import sobel_stats as SS

F32 = np.float32
SMS = 132  # H100 SXM's SM count; the plan's only input besides the shape
_HEADER = (_build.CSRC / "strip_stencil.cuh").read_text()
_C = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", _HEADER)}
TW, THREADS, PX, RING = _C["TW"], _C["THREADS"], _C["PX"], _C["RING"]
TPR = TW // PX          # threads per row
RPS = THREADS // TPR    # rows per step
WARPS = THREADS // 32
ROWB = 3 * TW + 32      # feature_fused.cu: bytes of an interleaved row segment
ROWF = TW + 8           # sobel_stats.cu: floats of a row segment

SHAPES = [(1, 1), (1, 300), (300, 1), (130, 257), (1000, 1500), (37, 700)]


def _stripe(h: int) -> int:
    """The largest Pallas stripe <= 128 that divides h."""
    return max(d for d in range(1, min(h, 128) + 1) if h % d == 0)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


def _dot3(a, b, c, x, y, z):
    return (F32(a) * x + F32(b) * y) + F32(c) * z  # rounded per operation


def _od(x):
    return -np.log10((x.astype(F32) + F32(1.0)) / F32(256.0))


def _sobel(a00, a01, a02, a10, a12, a20, a21, a22):
    """``sobel_mag`` of the header, in float32, in its order."""
    tx = ((((-a00 + a02) - F32(2) * a10) + F32(2) * a12) - a20) + a22
    ty = ((((-a00 - F32(2) * a01) - a02) + a20) + F32(2) * a21) + a22
    return np.sqrt(tx * tx + ty * ty)


def _fma(a, b, c):
    """``s += x * x`` as the compiler contracts it: one rounding (the
    product is exact in double)."""
    return (a.astype(np.float64) * b + c).astype(F32)


def _op(maxima, a, b):
    with np.errstate(invalid="ignore"):
        return np.where(maxima, np.maximum(a, b), a + b)


def _warps_then_in_order(v, maxima):
    """``merge_moments``' reduction of (THREADS, K) values: a shuffle-down
    tree in each warp (lane 0's result), then the warps in order."""
    w = v.reshape(WARPS, 32, -1)
    for off in (16, 8, 4, 2, 1):
        w = _op(maxima, w[:, :off], w[:, off:2 * off])
    out = w[0, 0]
    for wi in range(1, WARPS):
        out = _op(maxima, out, w[wi, 0])
    return out


def _merge(partials, maxima):
    """The last block: thread t folds rows t, t + THREADS, ... in double,
    then the tree and the warps in order; stats in float32."""
    d = np.where(maxima, -np.inf, 0.0) * np.ones((THREADS, 1))
    for i0 in range(0, len(partials), THREADS):
        chunk = partials[i0:i0 + THREADS].astype(np.float64)
        d[:len(chunk)] = _op(maxima, d[:len(chunk)], chunk)
    return _warps_then_in_order(d, maxima).astype(F32)


class _Moments:
    """Per-thread (sum, sumsq, max) of one quantity, columns ``c0..c0+2``
    of a (THREADS, K) block."""

    def __init__(self, acc, c0):
        self.acc, self.c0 = acc, c0

    def add(self, rr, vals, inside):
        """Thread rr * TPR + cx folds its PX values of ``vals`` (TW,) in
        order, those inside the image only."""
        v, ok = vals.reshape(TPR, PX), inside.reshape(TPR, PX)
        a = self.acc[rr * TPR:(rr + 1) * TPR]
        for k in range(PX):
            sel = ok[:, k]
            x = v[sel, k]
            a[sel, self.c0] = a[sel, self.c0] + x
            a[sel, self.c0 + 1] = _fma(x, x, a[sel, self.c0 + 1])
            a[sel, self.c0 + 2] = np.maximum(a[sel, self.c0 + 2], x)


def walk(plane, stains=None):
    """One launch over ``plane`` (the stencil's (h, w) float32 input) as
    the kernels schedule it; ``stains`` (feature_fused only) are the
    (hema, eosin) planes each pixel's conversion computes. Returns the
    planes written (each checked to be written exactly once), the
    blocks' partial moments in block order and the merged stats."""
    h, w = plane.shape
    p = FF.plan(h, w, SMS)
    k = 6 if stains is not None else 3
    maxima = np.array([c % 3 == 2 for c in range(k)])
    mag = np.full((h, w), np.nan, F32)
    out = [np.full((h, w), np.nan, F32) for _ in range(2)] if stains is not None else []
    writes = np.zeros((len(out) + 1, h, w), np.int32)
    partials = np.empty((p.blocks, k), F32)
    for by in range(p.segments):
        for bx in range(p.strips):
            x0, y0 = TW * bx, p.rows * by
            rows_here = min(p.rows, h - y0)
            cols = np.clip(np.arange(x0 - 1, x0 + TW + 1), 0, w - 1)  # ring columns
            xs = x0 + np.arange(TW)
            inside = xs < w
            acc = np.where(maxima, -np.inf, 0.0).astype(F32) * np.ones((THREADS, 1), F32)
            hm, gm = _Moments(acc, 0), _Moments(acc, k - 3)
            ring = np.full((RING, TW + 2), np.nan, F32)
            tag = np.full(RING, -1)
            for s in range((rows_here + 1) // RPS + 1):
                for rr in range(RPS):  # convert input rows RPS*s ..
                    i = RPS * s + rr
                    if i > rows_here + 1:
                        continue
                    ring[i % RING], tag[i % RING] = plane[np.clip(y0 - 1 + i, 0, h - 1), cols], i
                    if stains is not None and 1 <= i <= rows_here:
                        y = y0 - 1 + i
                        for o, src in zip(out, stains):
                            o[y, xs[inside]] = src[y, xs[inside]]
                        writes[:2, y, xs[inside]] += 1
                        hm.add(rr, np.where(inside, stains[0][y, np.minimum(xs, w - 1)], 0), inside)
                for rr in range(RPS):  # emit output rows RPS*s - 2 ..
                    j = RPS * s - 2 + rr
                    if not 0 <= j < rows_here:
                        continue
                    assert [tag[(j + d) % RING] for d in range(3)] == [j, j + 1, j + 2]
                    a, b, c = (ring[(j + d) % RING] for d in range(3))
                    m = _sobel(a[:-2], a[1:-1], a[2:], b[:-2], b[2:], c[:-2], c[1:-1], c[2:])
                    mag[y0 + j, xs[inside]] = m[inside]
                    writes[-1, y0 + j, xs[inside]] += 1
                    gm.add(rr, m, inside)
            partials[by * p.strips + bx] = _warps_then_in_order(acc, maxima)
    assert (writes == 1).all(), "a pixel written other than once"
    return (*out, mag), partials, _merge(partials, maxima)


def _feature_inputs(h, w, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return tuple(rng.integers(0, 256, (h, w)).astype(np.uint8) for _ in range(3))
    return tuple(rng.uniform(0, 255, (h, w)).astype(F32) for _ in range(3))


def feature_model(r, g, b):
    """feature_fused as the kernel computes it: per pixel the luminance
    and, from the optical densities (a 256-entry table for uint8), the
    stain planes; then :func:`walk`."""
    m = ref.DECONV_MATRIX
    if r.dtype == np.uint8:
        table = _od(np.arange(256))
        odr, odg, odb = table[r], table[g], table[b]
    else:
        odr, odg, odb = _od(r), _od(g), _od(b)
    hema = _dot3(*m[0], odr, odg, odb)
    eosin = _dot3(*m[1], odr, odg, odb)
    lum = _dot3(0.299, 0.587, 0.114, r.astype(F32), g.astype(F32), b.astype(F32))
    return walk(lum, (hema, eosin))


# --------------------------------------------------------------------------
# the model against the plain versions and the Pallas kernels
# --------------------------------------------------------------------------


@pytest.mark.parametrize("hw", SHAPES)
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_feature_model_matches_plain_and_pallas(hw, dtype):
    r, g, b = _feature_inputs(*hw, dtype, seed=hw[0] * 7 + hw[1])
    planes, _, stats = feature_model(r, g, b)
    got = (*planes, stats)
    jr, jg, jb = jnp.asarray(r), jnp.asarray(g), jnp.asarray(b)
    for want in (ref.feature_fused_ref(torch.as_tensor(r), torch.as_tensor(g), torch.as_tensor(b)),
                 jops.feature_fused(jr, jg, jb, stripe=_stripe(hw[0]), interpret=True)):
        for name, gp, wp in zip(("hema", "eosin", "mag", "stats"), got, want):
            rtol = 1e-4 if name == "stats" else 3e-5
            np.testing.assert_allclose(gp, np.asarray(wp), rtol=rtol, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("hw", SHAPES)
def test_sobel_model_matches_plain_and_pallas(hw):
    gray = np.random.default_rng(hw[0] + 3 * hw[1]).uniform(0, 255, hw).astype(F32)
    (mag,), _, stats = walk(gray)
    want_mag, want_stats = ref.sobel_stats_ref(torch.as_tensor(gray))
    # The plain version's arithmetic, but PyTorch's CPU sqrt is not
    # correctly rounded everywhere (the card's is, and there the kernel
    # is held bit for bit): within one ulp of it.
    np.testing.assert_allclose(mag, want_mag.numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_max_ulp(mag, want_mag.numpy(), maxulp=1)
    np.testing.assert_allclose(stats, want_stats.numpy(), rtol=1e-4)
    jm, js = jops.sobel_stats(jnp.asarray(gray), stripe=_stripe(hw[0]), interpret=True)
    np.testing.assert_allclose(mag, np.asarray(jm), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(stats, np.asarray(js), rtol=1e-4)


def test_merge_is_in_block_order():
    """The stats come from the partial rows alone, merged in a fixed
    order: the same rows merge to the same bits, and the merge agrees
    with a float64 sum of the pixels."""
    gray = np.random.default_rng(9).uniform(0, 255, (1000, 1500)).astype(F32)
    (mag,), partials, stats = walk(gray)
    maxima = np.array([False, False, True])
    assert len(partials) == FF.plan(1000, 1500, SMS).blocks
    np.testing.assert_array_equal(_merge(partials.copy(), maxima), stats)
    m64 = mag.astype(np.float64)
    np.testing.assert_allclose(stats, [m64.sum(), (m64 * m64).sum(), m64.max()], rtol=1e-6)


# --------------------------------------------------------------------------
# the plan, the header and the fast paths
# --------------------------------------------------------------------------


def test_header_constants_are_the_wrappers():
    assert (FF.STRIP_W, FF.ROWS_PER_STEP) == (TW, RPS)
    assert _C["MIN_BLOCKS"] == FF.BLOCKS_PER_SM  # the plan fills the resident slots once
    assert RPS == 4 and RING >= 2 * RPS, "emit reads rows RPS*s - 2 .. RPS*s + 3"
    assert "feature_fused" in _build.KERNELS and "sobel_stats" in _build.KERNELS
    for name in ("feature_fused", "sobel_stats"):
        assert [p.name for p in _build._sources(name)] == [f"{name}.cu", "strip_stencil.cuh"]


@pytest.mark.parametrize("hw", SHAPES + [(4096, 4096), (100_000, 3), (3, 100_000)])
def test_plan_covers_the_image(hw):
    """The grid the C side launches (``grid_of``: ceil(w / TW) strips,
    ceil(h / rows) segments) is the plan's; rows are whole steps, at
    least ``MIN_ROWS``; blocks fill each SM's ``BLOCKS_PER_SM`` slots
    at most once where the image allows, and the grid fits CUDA's
    limit."""
    h, w = hw
    p = FF.plan(h, w, SMS)
    assert p.strips == -(-w // TW) and p.segments == -(-h // p.rows)
    assert p.rows % RPS == 0 and p.rows >= FF.MIN_ROWS
    assert (p.segments - 1) * p.rows < h <= p.segments * p.rows
    assert p.segments <= 65535
    if p.rows > FF.MIN_ROWS and p.strips <= FF.BLOCKS_PER_SM * SMS:
        assert p.blocks <= FF.BLOCKS_PER_SM * SMS
    if hw == (4096, 4096):
        assert (p.strips, p.segments, p.rows) == (16, 32, 128)


def _fetch_interleaved(row: np.ndarray, x0: int, w: int) -> np.ndarray:
    """The ROWB bytes a block's copies place in shared memory for one
    image row (``row``: the row's 3w bytes): chunk k holds bytes
    3*x0 - 16 + 16k .., the first min(16, 3w - off) of them, zeros after;
    chunks before the row or past its end are not copied."""
    raw = np.zeros(ROWB, np.uint8)
    for k in range(ROWB // 16):
        off = 3 * x0 - 16 + 16 * k
        n = min(16, 3 * w - off)
        if off >= 0 and n > 0:
            assert off % 16 == 0 and off + n <= 3 * w
            raw[16 * k:16 * k + n] = row[off:off + n]
    return raw


@pytest.mark.parametrize("w", [16, 272, 1504, 4096, 200])
def test_interleaved_copies_place_every_pixel(w):
    """The fast path's de-interleave: for every thread, the word loads
    (whole groups of PX pixels) or the clamped byte loads (a ragged
    group, the halo columns) read the pixel's own R, G, B bytes."""
    rng = np.random.default_rng(w)
    row = rng.integers(0, 256, 3 * w).astype(np.uint8)
    for x0 in range(0, w, TW):
        raw = _fetch_interleaved(row, x0, w)
        words = raw.view("<u4")
        for cx in range(TPR):
            base = x0 + PX * cx
            nx = min(PX, w - base)
            if nx == PX:
                w0, w1, w2 = (int(v) for v in words[(16 + 3 * PX * cx) // 4:][:3])
                got = [(w0 & 255, (w0 >> 8) & 255, (w0 >> 16) & 255),
                       (w0 >> 24, w1 & 255, (w1 >> 8) & 255),
                       ((w1 >> 16) & 255, w1 >> 24, w2 & 255),
                       ((w2 >> 8) & 255, (w2 >> 16) & 255, w2 >> 24)]
            else:
                got = [tuple(raw[16 + 3 * (min(base + k, w - 1) - x0):][:3]) for k in range(PX)]
            for k, px in enumerate(got):
                x = min(base + k, w - 1)
                assert tuple(px) == tuple(row[3 * x:3 * x + 3]), (x0, cx, k)
        for gx in (max(x0 - 1, 0), min(x0 + TW, w - 1)):  # the halo columns
            off = 16 + 3 * (gx - x0)
            assert tuple(raw[off:off + 3]) == tuple(row[3 * gx:3 * gx + 3])


@pytest.mark.parametrize("w", [4, 1500, 4096, 258])
def test_aligned_row_copies_place_every_pixel(w):
    """sobel_stats' fast path: chunk k of a row segment holds floats
    x0 - 4 + 4k .., the first min(4, w - off) of them; each column the
    block reads (its strip, clamped, and the halo) is where it looks."""
    row = np.random.default_rng(w).uniform(0, 255, w).astype(F32)
    for x0 in range(0, w, TW):
        raw = np.zeros(ROWF, F32)
        for k in range(ROWF // 4):
            off = x0 - 4 + 4 * k
            n = min(4, w - off)
            if off >= 0 and n > 0:
                raw[4 * k:4 * k + n] = row[off:off + n]
        for gx in range(max(x0 - 1, 0), min(x0 + TW, w - 1) + 1):
            assert raw[4 + gx - x0] == row[gx]


def test_fast_path_predicates():
    """``interleaved`` takes exactly the channel views of one HWC uint8
    buffer with 16-byte aligned rows; ``rows_aligned`` exactly the
    contiguous-row float32 planes with 16-byte aligned rows."""
    rgb = torch.zeros(64, 64, 3, dtype=torch.uint8)
    assert rgb.data_ptr() % 16 == 0
    views = lambda t: (t[..., 0], t[..., 1], t[..., 2])  # noqa: E731
    assert FF.interleaved(*views(rgb))
    assert FF.interleaved(*views(rgb[:, :40]))              # narrower crop, same rows
    assert FF.interleaved(*views(rgb[16:]))                 # rows down: still aligned
    assert not FF.interleaved(*views(rgb[1:, 1:]))          # crop: unaligned start
    assert not FF.interleaved(*views(torch.zeros(8, 1500, 3, dtype=torch.uint8)))  # 4500 B rows
    assert not FF.interleaved(rgb[..., 1], rgb[..., 2], rgb[..., 0])  # channels out of order
    assert not FF.interleaved(*(rgb[..., c].contiguous() for c in range(3)))  # separate planes
    assert not FF.interleaved(*views(torch.zeros(64, 64, 3)))          # float32
    assert not FF.interleaved(*views(torch.zeros(64, 64, 4, dtype=torch.uint8)))  # RGBA
    gray = torch.zeros(64, 1500)
    assert SS.rows_aligned(gray) and SS.rows_aligned(gray[:, :7]) and SS.rows_aligned(gray[4:])
    assert not SS.rows_aligned(gray[:, 1:])                 # unaligned start
    assert not SS.rows_aligned(torch.zeros(8, 1001))        # rows not 16-byte multiples
    assert not SS.rows_aligned(gray.t())                    # columns contiguous
    assert not SS.rows_aligned(gray[:, ::2])                # strided columns
