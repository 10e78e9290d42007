"""The rounding design of the bfloat16 flash_attention backward, on the CPU.

``_kernel_model`` repeats, in plain PyTorch, the arithmetic order of the
tensor-core backward in ``src/repro_torch/kernels/csrc/flash_attention.cu``
(``flash_bwd_dq_tc_kernel`` and ``flash_bwd_dkdv_tc_kernel``, which run
only on a card): Dvec = rowsum(dO * O) in float32; keys (dQ) and queries
(dK/dV) in tiles of 64; S = Q K^T and dP = dO V^T summed in float32 from
bfloat16 inputs; P = exp2(S * scale * log2(e) - lse * log2(e)), 0 where
masked; dS = P (dP - Dvec) from the float32 P; P and dS rounded to
bfloat16 before the dV = P^T dO, dK = dS^T Q and dQ = dS K products,
which accumulate in float32 tile by tile; a query group's float32 dK/dV
partials summed in head order; dQ and dK times the scale, then one
rounding to the output type.

The bar the card holds the bf16 kernel to. The kernel and the plain
backward (``ref.flash_attention_bwd_ref``: float32 from the formulas,
one rounding) are each rounded once to bfloat16. Two roundings of floats
a and b differ by at most |a - b| plus one ulp, and a bfloat16 ulp is at
most 2**-7 of the row's largest element. The float part |a - b| comes
from rounding P and dS: each product term moves by at most 2**-9 of
itself, independently, so an element moves by about
2**-9 * sqrt(sum of its squared terms / 3). The row's largest element
grows the same way with S (a sum of terms of random sign: dS sums to 0
over a row), so the share does not grow with S; the model measures it
over the grid below, peaked scores included, and it stays under 2**-7
(``test_kernel_model_float_error_within_one_ulp``). Hence 2**-7 +
2**-7 = 2**-6 of the row's largest element: the bar that
``chip_smoke.py`` and ``tests/test_torch_kernels_gpu.py`` already held
the CUDA-core backward (float32 products) to, kept. Rows near 0 (causal dQ's row
0) are held to 2**-8 of the largest element of the three gradients.

It is held against
- ``jax.vjp`` of the JAX package's oracle ``repro.kernels.ref.flash_attention_ref``
  in float32 on the same bfloat16-valued inputs, given the float32
  forward's out and lse, at the bar (the oracle is not rounded: half an
  ulp less);
- the port's plain backward on the bfloat16 out and float32 lse of the
  plain forward, as the card kernel is, at the bar.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref

TILE = 64
LOG2E = 1.4426950408889634
#: The bar: a share of the largest |value| in the element's row.
BAR = 2.0 ** -6
#: The float error that rounding P and dS may add (the derivation's premise).
FLOAT_BAR = 2.0 ** -7


def _kernel_model(q, k, v, out, lse, dout, causal: bool, out_dtype=None,
                  operand_dtype=torch.bfloat16):
    """(dq, dk, dv) in the kernel's arithmetic order, rounded to
    ``out_dtype`` (q's type by default; float32 keeps the float sums).
    P and dS are rounded to ``operand_dtype`` before their products."""
    b, h, s, d = q.shape
    hkv = k.shape[1]
    group = h // hkv
    out_dtype = out_dtype or q.dtype
    scale = 1.0 / math.sqrt(d)
    qf, dof = q.float(), dout.float()
    kf = k.float().repeat_interleave(group, 1)
    vf = v.float().repeat_interleave(group, 1)
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    lse2 = lse.float() * torch.tensor(LOG2E, dtype=torch.float32)
    dvec = (dof * out.float()).sum(-1)
    rows, cols = torch.arange(s)[:, None], torch.arange(s)[None, :]
    rnd = lambda t: t.to(operand_dtype).float()  # noqa: E731

    def p_ds(r0, r1, c0, c1):
        sc = qf[:, :, r0:r1] @ kf[:, :, c0:c1].transpose(-1, -2)
        dp = dof[:, :, r0:r1] @ vf[:, :, c0:c1].transpose(-1, -2)
        p = torch.exp2(sc * c - lse2[:, :, r0:r1, None])
        if causal:
            p = p.masked_fill(cols[:, c0:c1] > rows[r0:r1], 0.0)
        return p, p * (dp - dvec[:, :, r0:r1, None])

    dq = torch.zeros_like(qf)
    for k0 in range(0, s, TILE):  # a dQ block walks the key tiles
        _, ds = p_ds(0, s, k0, k0 + TILE)
        dq += rnd(ds) @ kf[:, :, k0:k0 + TILE]
    dkp, dvp = torch.zeros_like(qf), torch.zeros_like(qf)
    for q0 in range(0, s, TILE):  # a dK/dV block walks the query tiles
        p, ds = p_ds(q0, q0 + TILE, 0, s)
        dvp += rnd(p).transpose(-1, -2) @ dof[:, :, q0:q0 + TILE]
        dkp += rnd(ds).transpose(-1, -2) @ qf[:, :, q0:q0 + TILE]
    dkp, dvp = dkp.view(b, hkv, group, s, d), dvp.view(b, hkv, group, s, d)
    dk, dv = dkp[:, :, 0].clone(), dvp[:, :, 0].clone()
    for g in range(1, group):  # the group's partials in head order
        dk += dkp[:, :, g]
        dv += dvp[:, :, g]
    return (dq * scale).to(out_dtype), (dk * scale).to(out_dtype), dv.to(out_dtype)


def _worst_share(got, want) -> float:
    """Largest |got - want| as a share of the largest |want| in its row
    (each row's scale at least 2**-8 of the three gradients' largest)."""
    peak = max(float(w.float().abs().max()) for w in want)
    worst = 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        assert bool(g.isfinite().all()) and bool(w.isfinite().all())
        scale = w.abs().amax(-1, keepdim=True).clamp_min(2.0 ** -8 * peak)
        worst = max(worst, float(((g - w).abs() / scale).max()))
    return worst


def _inputs(s, group, d, seed, q_mult=1.0):
    """bfloat16 q, k, v, dout (B=1, Hkv=1, H=group) from a numpy seed."""
    rng = np.random.default_rng(seed)
    mk = lambda *sh: torch.as_tensor(rng.normal(0, 1, sh).astype(np.float32))  # noqa: E731
    q = (mk(1, group, s, d) * q_mult).bfloat16()
    k, v = mk(1, 1, s, d).bfloat16(), mk(1, 1, s, d).bfloat16()
    return q, k, v, mk(1, group, s, d).bfloat16()


def _jax_grads(q, k, v, dout, causal):
    group = q.shape[1] // k.shape[1]
    as_j = lambda t: jnp.asarray(t.float().numpy())  # noqa: E731

    def fn(q, k, v):
        return jref.flash_attention_ref(q, jnp.repeat(k, group, 1), jnp.repeat(v, group, 1),
                                        causal)

    _, vjp = jax.vjp(fn, as_j(q), as_j(k), as_j(v))
    return [torch.as_tensor(np.asarray(g)) for g in vjp(as_j(dout))]


@pytest.mark.parametrize("s", [1, 63, 1000, 1024])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_model_within_bar(s, group, d, causal):
    """Against the plain backward on the bf16 forward's out (as the card
    kernel is) and against jax.vjp of the float32 oracle."""
    q, k, v, dout = _inputs(s, group, d, seed=s + d + group)
    out, lse = ref.flash_attention_fwd_ref(q, k, v, causal)
    got = _kernel_model(q, k, v, out, lse, dout, causal)
    assert [t.dtype for t in got] == [torch.bfloat16] * 3
    assert _worst_share(got, ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal)) <= BAR
    f = lambda t: t.float()  # noqa: E731
    out32, lse32 = ref.flash_attention_fwd_ref(f(q), f(k), f(v), causal)
    got32 = _kernel_model(q, k, v, out32, lse32, dout, causal)
    assert _worst_share(got32, _jax_grads(q, k, v, dout, causal)) <= BAR


@pytest.mark.parametrize("s,group,d,causal,q_mult", [
    (1000, 1, 64, True, 1.0), (1024, 4, 64, True, 1.0), (1024, 4, 32, False, 1.0),
    (1024, 1, 128, False, 1.0), (63, 4, 64, False, 1.0),
    (1024, 4, 32, False, 8.0), (1000, 1, 32, True, 8.0), (300, 4, 128, True, 8.0)])
def test_kernel_model_float_error_within_one_ulp(s, group, d, causal, q_mult):
    """The float error of rounding P and dS alone (no final rounding),
    against the plain backward in float32: within 2**-7 of the row's
    largest element. q_mult 8: peaked scores, most of P near 0 or 1."""
    q, k, v, dout = _inputs(s, group, d, seed=s + d + group, q_mult=q_mult)
    out, lse = ref.flash_attention_fwd_ref(q, k, v, causal)
    f = lambda t: t.float()  # noqa: E731
    got = _kernel_model(q, k, v, out, lse, dout, causal, out_dtype=torch.float32)
    want = ref.flash_attention_bwd_ref(f(q), f(k), f(v), out, lse, f(dout), causal)
    assert _worst_share(got, want) <= FLOAT_BAR


@pytest.mark.parametrize("causal", [True, False])
def test_kernel_model_peaked_scores_within_bar(causal):
    """q scaled by 8, GQA: the rounded gradients still within the bar of
    the plain backward."""
    q, k, v, dout = _inputs(300, 4, 64, seed=8, q_mult=8.0)
    out, lse = ref.flash_attention_fwd_ref(q, k, v, causal)
    got = _kernel_model(q, k, v, out, lse, dout, causal)
    assert _worst_share(got, ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal)) <= BAR


def test_kernel_model_rounding_is_what_moves_it():
    """Without the bf16 rounding of P and dS the model is the plain
    backward up to float32 summation order: the rounding is the error the
    bar has to cover."""
    q, k, v, dout = _inputs(256, 4, 64, seed=3)
    out, lse = ref.flash_attention_fwd_ref(q, k, v, True)
    f = lambda t: t.float()  # noqa: E731
    want = ref.flash_attention_bwd_ref(f(q), f(k), f(v), out, lse, f(dout), True)
    rounded = _kernel_model(q, k, v, out, lse, dout, True, out_dtype=torch.float32)
    exact = _kernel_model(q, k, v, out, lse, dout, True, out_dtype=torch.float32,
                          operand_dtype=torch.float32)
    assert _worst_share(exact, want) < 2.0 ** -16
    assert _worst_share(rounded, want) > 2.0 ** -12
