"""The port's plain attention and scan versions against the JAX package.

``repro_torch.kernels.ref.{flash_attention,decode_attention,mamba2_chunk_scan}_ref``
(what the CUDA kernels are held to on the card, and what the kernel
wrappers run for CPU tensors) against the Pallas kernels in interpret
mode, over the shapes and at the tolerances of ``tests/test_kernels.py``
(flash 2e-5 in float32 and 2e-2 in bfloat16, decode 3e-5, scan 1e-5);
then the cases the Pallas kernels reject (ragged lengths, GQA in the
flash layout) against the JAX oracles, and the device dispatch of the
new entry points.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import mamba2_scan as MS
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sobel_stats as SS

RNG = np.random.default_rng(11)


def _t(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a)).to(dtype)


def _j(a: np.ndarray, dtype=jnp.float32):
    return jnp.asarray(a).astype(dtype)


@pytest.mark.parametrize("shape", [(1, 2, 128, 64), (2, 4, 256, 64), (1, 1, 512, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_vs_pallas(shape, causal, dtype):
    q, k, v = (RNG.normal(0, 1, shape).astype(np.float32) for _ in range(3))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jops.flash_attention(_j(q, jd), _j(k, jd), _j(v, jd), causal=causal,
                                block_q=128, block_k=128, interpret=True)
    got = ref.flash_attention_ref(_t(q, td), _t(k, td), _t(v, td), causal=causal)
    assert got.dtype == td
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 4), (16, 8)])
@pytest.mark.parametrize("s,bk", [(256, 128), (512, 256)])
def test_decode_attention_plain_vs_pallas(hq, hkv, s, bk):
    b, d = 3, 64
    q = RNG.normal(0, 1, (b, hq, d)).astype(np.float32)
    k = RNG.normal(0, 1, (b, hkv, s, d)).astype(np.float32)
    v = RNG.normal(0, 1, (b, hkv, s, d)).astype(np.float32)
    lengths = np.array([s, s // 3, 1], np.int32)
    want = jops.decode_attention(_j(q), _j(k), _j(v), jnp.asarray(lengths),
                                 block_k=bk, interpret=True)
    got = ref.decode_attention_ref(_t(q), _t(k), _t(v), torch.as_tensor(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("c,h,f", [(4, 2, 128), (16, 8, 256), (32, 4, 512)])
def test_mamba2_chunk_scan_plain_vs_pallas(c, h, f):
    decay = RNG.uniform(0.3, 1.0, (c, h)).astype(np.float32)
    inc = RNG.normal(0, 1, (c, h, f)).astype(np.float32)
    ws, wf = jops.mamba2_chunk_scan(_j(decay), _j(inc), interpret=True)
    gs, gf = ref.mamba2_chunk_scan_ref(_t(decay), _t(inc))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gf.numpy(), np.asarray(wf), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s", [15, 100, 129])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_ragged_and_gqa_vs_oracle(s, causal):
    """Lengths no Pallas block divides, and q heads reading kv head
    ``h // group`` with no repeat materialised by the caller (the
    model's slot layout): against the JAX oracle on repeated K/V."""
    b, hq, hkv, d = 2, 8, 2, 64
    q = RNG.normal(0, 1, (b, hq, s, d)).astype(np.float32)
    k = RNG.normal(0, 1, (b, hkv, s, d)).astype(np.float32)
    v = RNG.normal(0, 1, (b, hkv, s, d)).astype(np.float32)
    want = jref.flash_attention_ref(_j(q), _j(np.repeat(k, 4, 1)), _j(np.repeat(v, 4, 1)),
                                    causal=causal)
    got = ref.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("s", [1, 200, 1000])
def test_decode_attention_ragged_cache_vs_oracle(s):
    b, hq, hkv, d = 4, 8, 2, 64
    q = RNG.normal(0, 1, (b, hq, d)).astype(np.float32)
    k = RNG.normal(0, 1, (b, hkv, s, d)).astype(np.float32)
    v = RNG.normal(0, 1, (b, hkv, s, d)).astype(np.float32)
    lengths = np.array([s, max(s // 2, 1), max(s - 1, 1), 1], np.int32)
    want = jref.decode_attention_ref(_j(q), _j(k), _j(v), jnp.asarray(lengths))
    got = ref.decode_attention_ref(_t(q), _t(k), _t(v), torch.as_tensor(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5, atol=3e-5)


def test_lm_ops_on_cpu_take_plain_version():
    """CPU tensors go to the plain versions: same values, no launch."""
    ops.reset_launch_counts()
    q, k, v = (_t(RNG.normal(0, 1, (1, 2, 40, 32))) for _ in range(3))
    assert torch.equal(ops.flash_attention(q, k, v, True), ref.flash_attention_ref(q, k, v, True))
    lengths = torch.tensor([7], dtype=torch.int32)
    assert torch.equal(ops.decode_attention(q[:, :, 0], k, v, lengths),
                       ref.decode_attention_ref(q[:, :, 0], k, v, lengths))
    decay, inc = _t(RNG.uniform(0.3, 1, (3, 2))), _t(RNG.normal(0, 1, (3, 2, 8)))
    for got, want in zip(ops.mamba2_chunk_scan(decay, inc), ref.mamba2_chunk_scan_ref(decay, inc)):
        assert torch.equal(got, want)
    gray = _t(RNG.uniform(0, 255, (20, 30)))
    for got, want in zip(ops.sobel_stats(gray), ref.sobel_stats_ref(gray)):
        assert torch.equal(got, want)
    assert set(ops.launch_counts()) == {
        "color_deconv", "morph_recon", "feature_fused", "sobel_stats",
        "flash_attention", "decode_attention", "mamba2_chunk_scan",
        "flash_attention_bwd", "mamba2_chunk_scan_bwd",
    }
    assert sum(ops.launch_counts().values()) == 0


def test_lm_kernel_wrappers_reject_cpu_tensors():
    """The CUDA wrappers launch or raise: a CPU tensor never reaches a
    build, and the counters do not move."""
    ops.reset_launch_counts()
    q = _t(RNG.normal(0, 1, (1, 2, 16, 64)))
    with pytest.raises(ValueError):
        FA.flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError):
        DA.decode_attention_cuda(q[:, :, 0].contiguous(), q, q,
                                 torch.tensor([3], dtype=torch.int32))
    with pytest.raises(ValueError):
        MS.mamba2_chunk_scan_cuda(torch.ones(2, 2), torch.ones(2, 2, 4))
    with pytest.raises(ValueError):
        SS.sobel_stats_cuda(torch.ones(8, 8))
    assert sum(ops.launch_counts().values()) == 0
