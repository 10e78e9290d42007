"""The port's CUDA kernels against their plain PyTorch versions, on a
card. Every test carries the ``gpu`` marker and skips where
``torch.cuda.is_available()`` is False (decided inside the test).

This file imports neither JAX nor the JAX package, so it also runs on
a machine with a card and no JAX; there the repository's
``conftest.py`` (which imports JAX) is skipped:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.gpu


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _planes(h, w, dtype, rng):
    mk = lambda: (  # noqa: E731
        rng.integers(0, 256, (h, w)).astype(dtype)
        if dtype == np.uint8
        else rng.uniform(0, 255, (h, w)).astype(dtype)
    )
    return mk(), mk(), mk()


@pytest.mark.parametrize("hw", [(128, 128), (1000, 1500), (4096, 4096)])
@pytest.mark.parametrize("layout", ["planes_u8", "planes_f32", "interleaved_u8"])
def test_cuda_color_deconv_and_feature_fused(hw, layout):
    dev = _cuda()
    rng = np.random.default_rng(7)
    if layout == "interleaved_u8":
        rgb = torch.as_tensor(rng.integers(0, 256, (*hw, 3)).astype(np.uint8), device=dev)
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    else:
        dtype = np.uint8 if layout == "planes_u8" else np.float32
        r, g, b = (torch.as_tensor(p, device=dev) for p in _planes(*hw, dtype, rng))
    ops.reset_launch_counts()
    for got, want in zip(ops.color_deconv(r, g, b), ref.color_deconv_ref(r, g, b)):
        torch.testing.assert_close(got, want, rtol=3e-5, atol=3e-5)
    got, want = ops.feature_fused(r, g, b), ref.feature_fused_ref(r, g, b)
    for gp, wp in zip(got[:3], want[:3]):
        torch.testing.assert_close(gp, wp, rtol=3e-5, atol=1e-4)
    torch.testing.assert_close(got[3], want[3], rtol=1e-4, atol=0.0)
    assert ops.launch_counts()["color_deconv"] == 1
    assert ops.launch_counts()["feature_fused"] == 1


@pytest.mark.parametrize("hw", [(128, 128), (192, 384), (1000, 1500)])
def test_cuda_morph_recon(hw):
    dev = _cuda()
    rng = np.random.default_rng(3)
    mask = rng.uniform(0, 255, hw).astype(np.float32)
    marker = np.maximum(mask - 55.0, 0.0) * (rng.uniform(0, 1, hw) > 0.6)
    marker = torch.as_tensor(marker.astype(np.float32), device=dev)
    mask = torch.as_tensor(mask, device=dev)
    ops.reset_launch_counts()
    got = ops.morph_recon(marker, mask)
    assert ops.launch_counts()["morph_recon"] >= 1
    torch.testing.assert_close(got, ref.morph_recon_ref(marker, mask), rtol=0.0, atol=1e-5)
