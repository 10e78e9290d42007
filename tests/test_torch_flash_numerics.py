"""The rounding design of the bfloat16 flash_attention kernel, on the CPU.

``_kernel_model`` repeats, in plain PyTorch, the arithmetic order of the
tensor-core kernel in ``src/repro_torch/kernels/csrc/flash_attention.cu``
(which runs only on a card): keys in blocks of 64, S = Q K^T summed in
float32 from bfloat16 inputs, the row max taken on the unscaled scores,
``exp2(s * scale * log2(e) - m)`` with the scale folded into one
multiply-add, the online softmax (running max, denominator and
accumulator in float32), P rounded to bfloat16 before the P V product
(the denominator sums the same rounded P: the kernel takes the row sums
as P times a column of ones on the tensor cores), and
``acc / max(l, 1e-30)`` rounded to bfloat16.

It is held against
- the JAX package's Pallas kernel ``flash_attention_pallas`` in interpret
  mode, in bfloat16, at 2e-2: the bar of ``tests/test_kernels.py`` for
  bfloat16 flash attention (the Pallas kernel keeps P in float32 and
  both round the output to bfloat16, so one or two bfloat16 ulps apart);
- the port's plain version ``flash_attention_ref`` (float32 softmax, one
  rounding of the output) at 1e-2, the bar the card holds the kernel to:
  rounding P to bfloat16 moves each weight by at most 2**-9 of itself,
  well under one bfloat16 ulp of the output.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ref

BK = 64
NEG = -1.0e30


def _kernel_model(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
    b, h, s, d = q.shape
    group = h // k.shape[1]
    qf = q.float()
    kf = k.float().repeat_interleave(group, 1)
    vf = v.float().repeat_interleave(group, 1)
    c = torch.tensor((1.0 / math.sqrt(d)) * math.log2(math.e), dtype=torch.float32)
    rows = torch.arange(s)[:, None]
    m = torch.full((b, h, s), NEG)
    l = torch.zeros((b, h, s))
    acc = torch.zeros((b, h, s, d))
    for k0 in range(0, s, BK):
        sc = qf @ kf[:, :, k0:k0 + BK].transpose(-1, -2)  # float32 sums of bf16 products
        cols = torch.arange(k0, min(k0 + BK, s))[None, :]
        if causal:
            sc = sc.masked_fill(cols > rows, NEG)
        m_new = torch.maximum(m, sc.amax(-1) * c)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(sc * c - m_new[..., None]).bfloat16().float()
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p @ vf[:, :, k0:k0 + BK]
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def _inputs(shape_q, hkv, seed):
    rng = np.random.default_rng(seed)
    b, h, s, d = shape_q
    return [rng.normal(0, 1, sh).astype(np.float32)
            for sh in (shape_q, (b, hkv, s, d), (b, hkv, s, d))]


# (B, H, Hkv, S, D): one 256-token prefill, a ragged S no block divides,
# and GQA at D=128 with one key past a block.
SHAPES = [(1, 4, 4, 256, 64), (1, 4, 4, 77, 64), (1, 4, 2, 129, 128)]


@pytest.mark.parametrize("b,h,hkv,s,d", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_model_vs_pallas_bf16(b, h, hkv, s, d, causal):
    q, k, v = _inputs((b, h, s, d), hkv, seed=s + d)
    got = _kernel_model(*(torch.as_tensor(a).bfloat16() for a in (q, k, v)), causal)
    group = h // hkv
    block = 128 if s % 128 == 0 else s  # the Pallas kernel needs S divisible by its blocks
    want = jops.flash_attention(
        *(jnp.asarray(a).astype(jnp.bfloat16)
          for a in (q, np.repeat(k, group, 1), np.repeat(v, group, 1))),
        causal=causal, block_q=block, block_k=block, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("b,h,hkv,s,d", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_model_vs_plain_version_at_card_bar(b, h, hkv, s, d, causal):
    q, k, v = (torch.as_tensor(a).bfloat16() for a in _inputs((b, h, s, d), hkv, seed=s + d))
    got = _kernel_model(q, k, v, causal)
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v, causal),
                               rtol=1e-2, atol=1e-2)


def test_kernel_model_peaked_scores_at_card_bar():
    """q scaled by 8: the running max moves by many units between key
    blocks, and most of P rounds to 0 or to a few bfloat16 values."""
    q, k, v = _inputs((1, 4, 300, 64), 2, seed=8)
    q, k, v = (torch.as_tensor(a).bfloat16() for a in (8 * q, k, v))
    for causal in (True, False):
        torch.testing.assert_close(_kernel_model(q, k, v, causal),
                                   ref.flash_attention_ref(q, k, v, causal),
                                   rtol=1e-2, atol=1e-2)
