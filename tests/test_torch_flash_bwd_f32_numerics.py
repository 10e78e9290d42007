"""The rounding design of the float32 flash_attention backward, on the CPU.

``_kernel_model_f32`` repeats, in plain PyTorch, the arithmetic order of
the three-pass TF32 backward in ``src/repro_torch/kernels/csrc/flash_attention.cu``
(``flash_bwd_dq_f32_kernel`` and ``flash_bwd_dkdv_f32_kernel``, which run
only on a card): Dvec = rowsum(dO * O) in float32; every one of the
products split as the forward's are, ``hi = tf32(a)``, ``lo = tf32(a - hi)``,
``tf32`` rounding as ``cvt.rna.tf32.f32`` (add 0x1000 to the bits, clear
the low 13), and summed as lo·hi + hi·lo + hi·hi; S = Q K^T and dP = dO V^T
with hi·hi summed apart from the small terms; P = exp2(S * scale * log2(e)
- lse * log2(e)), 0 where masked; dS = P (dP - Dvec) from the float32 P;
dQ = dS K over keys and dV = P^T dO, dK = dS^T Q over queries in steps of
NC columns (32, or 16 at D=128), each step's product summed from zero and
added to a float32 accumulator (with two warp groups a block, one
accumulator for each group's alternate tiles, summed at the end in group
order); a query group's float32 dK/dV partials
summed in head order; dQ and dK times the scale at the end.

The bar is the card's float32 bar (``chip_smoke.py`` phase 1,
``tests/test_torch_kernels_gpu.py``): each gradient element within 2**-12
of the largest |value| in its row, no row's scale below 2**-8 of the three
gradients' largest. The model is held to it against
- ``jax.vjp`` of the JAX package's oracle ``repro.kernels.ref.flash_attention_ref``
  in float32 (the model given the plain float32 forward's out and lse);
- the port's plain backward ``ref.flash_attention_bwd_ref`` on the same
  out and lse,
over S in {1, 63, 1000, 1024}, groups 1 and 4, D in {32, 64, 128}, causal
and not, and peaked scores (q times 8). One pass of TF32 (hi·hi alone) is
off by about 2**-11 of each operand, which dP - Dvec does not cancel in
rows of small values: it misses the bar by far, so the bar tells the
designs apart.

The B operand of dQ += dS K (and of dV += P^T dO, dK += dS^T Q) is read by
32-bit shared loads from the swizzled tile, with dS's C fragments used as
A fragments under a renumbering of the k index; ``test_mm_nn_fragments``
walks the lanes of that mapping (``BCols``, ``to_afrags``) through
the m16n8k8 layouts of the PTX ISA and checks the product and that the 32
lanes of each load hit 32 banks.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref
from test_torch_flash_f32_numerics import _split

LOG2E = 1.4426950408889634
#: The card's float32 bar: a share of the largest |value| in the element's row.
BAR = 2.0 ** -12


def _mm(a, b, passes: int, apart: bool = False) -> torch.Tensor:
    """a @ b as the tensor cores take it: one TF32 pass, or three (the
    small terms first, or summed apart from hi·hi with ``apart``). a and b
    are float32 tensors or their (hi, lo) splits."""
    ah, al = a if isinstance(a, tuple) else _split(a)
    bh, bl = b if isinstance(b, tuple) else _split(b)
    if passes == 1:
        return ah @ bh
    if apart:
        return ah @ bh + (al @ bh + ah @ bl)
    return al @ bh + ah @ bl + ah @ bh


def _nc(d: int) -> int:
    return 16 if d == 128 else 32


def _tile(d: int) -> int:
    """Rows of a streamed tile (a warp group's share of the ring's)."""
    return {32: 64, 64: 32, 128: 16}[d]


def _kernel_model_f32(q, k, v, out, lse, dout, causal: bool, passes: int = 3,
                      groups: int = 1):
    """(dq, dk, dv) of the float32 backward kernels' arithmetic (``passes``
    3), or of the same kernels with single-pass TF32 products. With
    ``groups`` 2 (two warp groups a block), tiles of ``_tile(D)`` keys (dQ)
    or queries (dK/dV) alternate between two accumulators, summed at the
    end in group order."""
    b, h, s, d = q.shape
    hkv = k.shape[1]
    group = h // hkv
    nc = _nc(d)
    scale = 1.0 / math.sqrt(d)
    kf, vf = k.repeat_interleave(group, 1), v.repeat_interleave(group, 1)
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    lse2 = lse * torch.tensor(LOG2E, dtype=torch.float32)
    dvec = (dout * out).sum(-1)
    rows, cols = torch.arange(s)[:, None], torch.arange(s)[None, :]

    # S and dP of every (row, column) pair, then P and dS: the kernels take
    # them a tile at a time, each element from the same sum over d. Every
    # operand is split once (the split is elementwise).
    sc = _mm(q, kf.transpose(-1, -2), passes, apart=True)
    dp = _mm(dout, vf.transpose(-1, -2), passes, apart=True)
    p = torch.exp2(sc * c - lse2[..., None])
    if causal:
        p = p.masked_fill(cols > rows, 0.0)
    ds = p * (dp - dvec[..., None])
    qs, ks, dos, ps, dss = (_split(t) for t in (q, kf, dout, p, ds))
    cut = lambda pair, sl: tuple(t[sl] for t in pair)  # noqa: E731
    tr = lambda pair: tuple(t.transpose(-1, -2) for t in pair)  # noqa: E731

    part = lambda c0: (c0 // _tile(d)) % groups  # noqa: E731  (the column's warp group)
    acc = [[torch.zeros_like(q) for _ in range(groups)] for _ in range(3)]  # dq, dk, dv
    for k0 in range(0, s, nc):  # a dQ warp walks the keys, NC a step
        keys = (..., slice(k0, k0 + nc), slice(None))
        acc[0][part(k0)] += _mm(cut(dss, (..., slice(k0, k0 + nc))), cut(ks, keys), passes)
    for q0 in range(0, s, nc):  # a dK/dV warp walks the queries, NC a step
        qrows = (..., slice(q0, q0 + nc), slice(None))
        acc[1][part(q0)] += _mm(tr(cut(dss, qrows)), cut(qs, qrows), passes)
        acc[2][part(q0)] += _mm(tr(cut(ps, qrows)), cut(dos, qrows), passes)
    dq, dkp, dvp = acc[0][0], acc[1][0], acc[2][0]
    for gi in range(1, groups):  # the warp groups' accumulators in group order
        dq, dkp, dvp = dq + acc[0][gi], dkp + acc[1][gi], dvp + acc[2][gi]
    dkp, dvp = dkp.view(b, hkv, group, s, d), dvp.view(b, hkv, group, s, d)
    dk, dv = dkp[:, :, 0].clone(), dvp[:, :, 0].clone()
    for g in range(1, group):  # the group's partials in head order
        dk += dkp[:, :, g]
        dv += dvp[:, :, g]
    return dq * scale, dk * scale, dv


def _worst_share(got, want) -> float:
    """Largest |got - want| as a share of the bar: BAR of the largest
    |want| in its row (each row's scale at least 2**-8 of the three
    gradients' largest)."""
    peak = max(float(w.abs().max()) for w in want)
    worst = 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        assert bool(g.isfinite().all()) and bool(w.isfinite().all())
        scale = w.abs().amax(-1, keepdim=True).clamp_min(2.0 ** -8 * peak)
        worst = max(worst, float(((g - w).abs() / (BAR * scale)).max()))
    return worst


def _inputs(s, group, d, seed, q_mult=1.0):
    """float32 q, k, v, dout (B=1, Hkv=1, H=group) from a numpy seed."""
    rng = np.random.default_rng(seed)
    mk = lambda *sh: torch.as_tensor(rng.normal(0, 1, sh).astype(np.float32))  # noqa: E731
    q = mk(1, group, s, d) * np.float32(q_mult)
    return q, mk(1, 1, s, d), mk(1, 1, s, d), mk(1, group, s, d)


def _jax_grads(q, k, v, dout, causal):
    group = q.shape[1] // k.shape[1]
    as_j = lambda t: jnp.asarray(t.numpy())  # noqa: E731

    def fn(q, k, v):
        return jref.flash_attention_ref(q, jnp.repeat(k, group, 1), jnp.repeat(v, group, 1),
                                        causal)

    _, vjp = jax.vjp(fn, as_j(q), as_j(k), as_j(v))
    return [torch.as_tensor(np.array(g)) for g in vjp(as_j(dout))]


def _check_case(s, group, d, causal, q_mult):
    q, k, v, dout = _inputs(s, group, d, seed=s + d + group, q_mult=q_mult)
    out, lse = ref.flash_attention_fwd_ref(q, k, v, causal)
    got = _kernel_model_f32(q, k, v, out, lse, dout, causal)
    assert [t.dtype for t in got] == [torch.float32] * 3
    assert _worst_share(got, ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal)) <= 1
    assert _worst_share(got, _jax_grads(q, k, v, dout, causal)) <= 1


@pytest.mark.parametrize("s", [1, 63, 1000, 1024])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_model_f32_within_bar(s, group, d, causal):
    """Against the plain backward on the same out and lse, and against
    jax.vjp of the float32 oracle."""
    _check_case(s, group, d, causal, 1.0)


@pytest.mark.parametrize("s,group,d,causal", [
    (1000, 1, 64, True), (1024, 4, 32, False), (256, 1, 64, True), (256, 1, 128, True),
    (1000, 4, 128, True), (63, 4, 64, False)])
def test_kernel_model_f32_peaked_scores_within_bar(s, group, d, causal):
    """q times 8: most of P near 0 or 1, the rows of small values where
    dP - Dvec cancels."""
    _check_case(s, group, d, causal, 8.0)


@pytest.mark.parametrize("s,group,d,causal,q_mult", [
    (256, 1, 64, True, 1.0), (256, 1, 128, True, 8.0), (1000, 4, 32, False, 1.0),
    (1024, 4, 128, True, 1.0)])
def test_kernel_model_f32_two_warp_groups_within_bar(s, group, d, causal, q_mult):
    """Two warp groups a block (small grids): alternate tiles in two
    accumulators, summed at the end, within the bar of the plain backward
    and of one group's order."""
    q, k, v, dout = _inputs(s, group, d, seed=s + d + group, q_mult=q_mult)
    out, lse = ref.flash_attention_fwd_ref(q, k, v, causal)
    two = _kernel_model_f32(q, k, v, out, lse, dout, causal, groups=2)
    assert _worst_share(two, ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal)) <= 1
    assert _worst_share(two, _kernel_model_f32(q, k, v, out, lse, dout, causal)) <= 1


@pytest.mark.parametrize("s,group,d,q_mult", [(256, 1, 64, 1.0), (256, 1, 128, 8.0),
                                              (1000, 4, 64, 1.0)])
def test_single_pass_tf32_misses_the_bar(s, group, d, q_mult):
    """The same kernels with one TF32 product a tile pair are more than ten
    times the bar away from the plain backward, where three passes are
    within it: the bar bites."""
    q, k, v, dout = _inputs(s, group, d, seed=s + d + group, q_mult=q_mult)
    out, lse = ref.flash_attention_fwd_ref(q, k, v, True)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, True)
    assert _worst_share(_kernel_model_f32(q, k, v, out, lse, dout, True), want) <= 1
    assert _worst_share(_kernel_model_f32(q, k, v, out, lse, dout, True, passes=1), want) > 10


def _swizzled(tile: np.ndarray) -> np.ndarray:
    """A (rows, D) float tile as the kernels store it: 16-byte chunk ch of
    row r at chunk ch ^ (r mod 8), flattened."""
    rows, d = tile.shape
    flat = np.zeros(rows * d, dtype=tile.dtype)
    for r in range(rows):
        for ch in range(d // 4):
            at = r * d + ((ch ^ (r & 7)) << 2)
            flat[at:at + 4] = tile[r, 4 * ch:4 * ch + 4]
    return flat


def _bcols(lane: int, d: int) -> tuple[list[int], list[int]]:
    """``BCols<D>`` of flash_attention.cu: the lane's offsets of rows 2t
    and 2t + 1 in column tiles 0-3."""
    g, t = lane >> 2, lane & 3
    x = 2 * t * d + ((((g >> 2) ^ (2 * t)) << 2) | (g & 3))
    return [x ^ (8 * m) for m in range(4)], [d + (x ^ 4 ^ (8 * m)) for m in range(4)]


@pytest.mark.parametrize("d", [32, 64, 128])
def test_mm_nn_fragments(d):
    """``mm_nn`` with ``to_afrags``, lane by lane in the m16n8k8 layouts
    (A: a0 (row g, k t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
    B: b0 (k t, col g), b1 (k t + 4, col g); C: c0, c1 (row g, cols 2t,
    2t + 1), c2, c3 (row g + 8)): the C fragments of a 16 x NC tile as A
    fragments with k index t standing for column 2t and t + 4 for 2t + 1,
    times the B elements at ``rows + 8j D + 32 (n / 4) + x0[n % 4]`` (and
    ``x1``) of the swizzled tile, give the tile times the tile's rows; each
    load's 32 lanes hit 32 distinct banks."""
    nc = _nc(d)
    rng = np.random.default_rng(d)
    c_tile = rng.normal(0, 1, (16, nc))
    b_tile = rng.normal(0, 1, (nc, d))
    flat = _swizzled(b_tile)
    got = np.zeros((16, d))
    for n in range(d // 8):
        for j in range(nc // 8):
            a, b = np.zeros((16, 8)), np.zeros((8, 8))
            banks = [set(), set()]
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                c = (c_tile[g, 8 * j + 2 * t], c_tile[g, 8 * j + 2 * t + 1],
                     c_tile[g + 8, 8 * j + 2 * t], c_tile[g + 8, 8 * j + 2 * t + 1])
                a0, a1, a2, a3 = c[0], c[2], c[1], c[3]  # to_afrags
                a[g, t], a[g + 8, t], a[g, t + 4], a[g + 8, t + 4] = a0, a1, a2, a3
                x0, x1 = _bcols(lane, d)
                at0 = 8 * j * d + 32 * (n // 4) + x0[n % 4]
                at1 = 8 * j * d + 32 * (n // 4) + x1[n % 4]
                b[t, g], b[t + 4, g] = flat[at0], flat[at1]
                banks[0].add(at0 % 32)
                banks[1].add(at1 % 32)
            assert [len(x) for x in banks] == [32, 32]
            got[:, 8 * n:8 * n + 8] += a @ b
    np.testing.assert_allclose(got, c_tile @ b_tile, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_chunk_pair_is_the_xor(d):
    """``chunk_pair(offset, kk)`` of flash_attention.cu, the XOR of kk mod 4
    plus an immediate, equals ``offset ^ (kk << 5)`` for every ldsm_offset
    a warp's lanes take (rows under 16, 4 warps of 16 rows) and every chunk
    pair of a row of D floats."""
    for row in range(64):
        for c in range(2):
            off = row * d * 4 + ((c ^ (row & 7)) << 4)
            for kk in range(d // 8):
                assert (off ^ ((kk & 3) << 5)) + ((kk >> 2) << 7) == off ^ (kk << 5)
