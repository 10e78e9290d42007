"""The rounding design of the float32 flash_attention kernel, on the CPU.

``_kernel_model_f32`` repeats, in plain PyTorch, the arithmetic of the
three-pass TF32 kernel in ``src/repro_torch/kernels/csrc/flash_attention.cu``
(which runs only on a card). Each operand of a product, q and k for the
scores, P and v for the output, is split into ``hi = tf32(a)`` and
``lo = tf32(a - hi)``, ``tf32`` rounding as ``cvt.rna.tf32.f32`` does
(add 0x1000 to the bit pattern, clear the low 13 bits), and the product
is ``(lo·hi + hi·lo) + hi·hi`` with float32 sums, the small terms summed
apart as the kernel sums them. Around the products, the kernel's order:
keys in tiles of 64 (32 at D=128), the row max taken on the unscaled
scores, ``exp2(s * scale * log2(e) - m)`` with the scale folded into one
multiply-add, the online softmax (running max, denominator of the
unsplit float32 P, accumulator, all float32) with each tile's P V summed
on its own and added as ``acc * alpha + tile``, ``acc / max(l, 1e-30)``
and ``lse = (m + log2 l) ln 2``.

It is held at 2e-5, the float32 bar of ``tests/test_kernels.py`` and of
the card (``chip_smoke.py`` phase 1, ``tests/test_torch_kernels_gpu.py``),
against
- the JAX package's Pallas kernel ``flash_attention_pallas`` in
  interpret mode, in float32 (it keeps P in float32);
- the port's plain version ``flash_attention_fwd_ref`` (float32 softmax),
  out and lse,
with peaked scores (q times 8), GQA, D=128, ragged S and non-causal
cases. One pass of TF32 (``hi·hi`` alone) is off by about 2^-11 of each
operand and fails that bar: the bar tells the two designs apart.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ref

NEG = -1.0e30
TOL = dict(rtol=2e-5, atol=2e-5)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as ``cvt.rna.tf32.f32``: to nearest, ties away
    from zero, kept as float32."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b as the tensor cores take it: three passes, or one of TF32."""
    ah, al = _split(a)
    bh, bl = _split(b)
    if passes == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def _kernel_model_f32(q, k, v, causal: bool, passes: int = 3):
    """(out, lse) of the float32 kernel's arithmetic (``passes`` 3), or of
    the same kernel with single-pass TF32 products (``passes`` 1)."""
    b, h, s, d = q.shape
    group = h // k.shape[1]
    bk = 32 if d == 128 else 64
    kf = k.repeat_interleave(group, 1)
    vf = v.repeat_interleave(group, 1)
    c = torch.tensor((1.0 / math.sqrt(d)) * math.log2(math.e), dtype=torch.float32)
    rows = torch.arange(s)[:, None]
    m = torch.full((b, h, s), NEG)
    l = torch.zeros((b, h, s))
    acc = torch.zeros((b, h, s, d))
    for k0 in range(0, s, bk):
        sc = _mm(q, kf[:, :, k0:k0 + bk].transpose(-1, -2), passes)
        cols = torch.arange(k0, min(k0 + bk, s))[None, :]
        if causal:
            sc = sc.masked_fill(cols > rows, NEG)
        m_new = torch.maximum(m, sc.amax(-1) * c)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(sc * c - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + _mm(p, vf[:, :, k0:k0 + bk], passes)
        m = m_new
    den = l.clamp_min(1e-30)
    return acc / den[..., None], (m + torch.log2(den)) * math.log(2.0)


def _inputs(shape_q, hkv, seed, q_scale=1.0):
    rng = np.random.default_rng(seed)
    b, h, s, d = shape_q
    q, k, v = (rng.normal(0, 1, sh).astype(np.float32)
               for sh in (shape_q, (b, hkv, s, d), (b, hkv, s, d)))
    return np.float32(q_scale) * q, k, v


# (B, H, Hkv, S, D, q scale): a 256-token prefill, a ragged S no tile
# divides, GQA at D=128 with one key past a tile, D=32, and peaked scores
# (q times 8: the running max moves by many units between tiles).
SHAPES = [(1, 4, 4, 256, 64, 1.0), (1, 4, 4, 77, 64, 1.0), (1, 4, 2, 129, 128, 1.0),
          (1, 2, 2, 100, 32, 1.0), (1, 4, 2, 200, 128, 8.0), (1, 2, 2, 128, 64, 8.0)]


@pytest.mark.parametrize("b,h,hkv,s,d,q_scale", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_model_f32_vs_pallas(b, h, hkv, s, d, q_scale, causal):
    q, k, v = _inputs((b, h, s, d), hkv, seed=s + d, q_scale=q_scale)
    got, _ = _kernel_model_f32(*(torch.as_tensor(a) for a in (q, k, v)), causal)
    group = h // hkv
    block = 128 if s % 128 == 0 else s  # the Pallas kernel needs S divisible by its blocks
    want = jops.flash_attention(
        *(jnp.asarray(a) for a in (q, np.repeat(k, group, 1), np.repeat(v, group, 1))),
        causal=causal, block_q=block, block_k=block, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("b,h,hkv,s,d,q_scale", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_model_f32_vs_plain_version_at_card_bar(b, h, hkv, s, d, q_scale, causal):
    q, k, v = (torch.as_tensor(a) for a in _inputs((b, h, s, d), hkv, seed=s + d,
                                                   q_scale=q_scale))
    out, lse = _kernel_model_f32(q, k, v, causal)
    want_out, want_lse = ref.flash_attention_fwd_ref(q, k, v, causal)
    torch.testing.assert_close(out, want_out, **TOL)
    torch.testing.assert_close(lse, want_lse, **TOL)


@pytest.mark.parametrize("b,h,hkv,s,d,q_scale", [SHAPES[0], SHAPES[2], SHAPES[4]])
def test_single_pass_tf32_misses_the_bar(b, h, hkv, s, d, q_scale):
    """The same kernel with one TF32 product a tile pair is more than ten
    times the bar away from the plain version, where three passes are
    within it: the bar bites."""
    q, k, v = (torch.as_tensor(a) for a in _inputs((b, h, s, d), hkv, seed=s + d,
                                                   q_scale=q_scale))
    want, _ = ref.flash_attention_fwd_ref(q, k, v, True)
    three, _ = _kernel_model_f32(q, k, v, True, passes=3)
    one, _ = _kernel_model_f32(q, k, v, True, passes=1)
    bar = TOL["atol"] + TOL["rtol"] * want.abs()
    assert bool(((three - want).abs() <= bar).all())
    assert float(((one - want).abs() / bar).max()) > 10.0


def test_tf32_rounds_to_nearest_ties_away_from_zero():
    """tf32() keeps 10 stored mantissa bits; a tie (the dropped bits
    exactly half a TF32 ulp) rounds away from zero, as ``.rna``; hi + lo
    is within 2^-22 of x."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 2 - 2.0 ** -23,
                      1.0 + 1.5 * ulp, 3.0], dtype=torch.float32)
    want = torch.tensor([1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + 2 * ulp, 3.0])
    assert torch.equal(_tf32(x), want)
    r = torch.as_tensor(np.random.default_rng(0).normal(0, 1, 10000).astype(np.float32))
    hi, lo = _split(r)
    assert torch.equal(_tf32(hi), hi) and torch.equal(_tf32(lo), lo)
    assert float(((hi.double() + lo.double() - r.double()).abs() / r.double().abs()).max()) \
        <= 2.0 ** -22
