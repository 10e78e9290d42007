"""The port's kernel modules (``repro_torch.kernels``) against the JAX
package: the plain PyTorch versions against ``repro.kernels.ref`` and
against the Pallas kernels in interpret mode, over the shapes, dtypes
and tolerances of ``tests/test_kernels.py``; ragged shapes; device
dispatch and launch counters. The CUDA kernels themselves are held
against their plain versions in ``test_torch_kernels_gpu.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import color_deconv as CD
from repro_torch.kernels import feature_fused as FF
from repro_torch.kernels import morph_recon as MR

RNG = np.random.default_rng(42)


def _planes(h, w, dtype, rng=RNG):
    mk = lambda: (  # noqa: E731
        rng.integers(0, 256, (h, w)).astype(dtype)
        if dtype == np.uint8
        else rng.uniform(0, 255, (h, w)).astype(dtype)
    )
    return mk(), mk(), mk()


def _recon_inputs(h, w, rng=RNG):
    mask = rng.uniform(0, 255, (h, w)).astype(np.float32)
    marker = np.maximum(mask - 55.0, 0.0) * (
        rng.uniform(0, 1, (h, w)) > 0.6
    ).astype(np.float32)
    return marker.astype(np.float32), mask


T = torch.as_tensor


@pytest.mark.parametrize("hw", [(128, 128), (256, 384), (128, 640)])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_color_deconv_plain_vs_jax(hw, dtype):
    r, g, b = _planes(*hw, dtype)
    got = ref.color_deconv_ref(T(r), T(g), T(b))
    want = jref.color_deconv_ref(jnp.asarray(r), jnp.asarray(g), jnp.asarray(b))
    pallas = jops.color_deconv(
        jnp.asarray(r), jnp.asarray(g), jnp.asarray(b), block=(128, 128),
        interpret=True,
    )
    for gp, wp, pp in zip(got, want, pallas):
        np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=3e-5, atol=3e-5)
        np.testing.assert_allclose(gp.numpy(), np.asarray(pp), rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("hw,stripe", [((128, 128), 32), ((256, 256), 64),
                                       ((192, 384), 48)])
@pytest.mark.parametrize("inner", [4, 16])
def test_morph_recon_plain_vs_jax(hw, stripe, inner):
    marker, mask = _recon_inputs(*hw)
    got = ref.morph_recon_ref(T(marker), T(mask)).numpy()
    want = jref.morph_recon_ref(jnp.asarray(marker), jnp.asarray(mask))
    pallas = jops.morph_recon(jnp.asarray(marker), jnp.asarray(mask),
                              stripe=stripe, inner_iters=inner, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-5)


@pytest.mark.parametrize("hw,stripe", [((128, 256), 32), ((256, 128), 64)])
def test_sobel_stats_plain_vs_jax(hw, stripe):
    gray = RNG.uniform(0, 255, hw).astype(np.float32)
    mag, st = ref.sobel_stats_ref(T(gray))
    for wm, ws in (
        jref.sobel_stats_ref(jnp.asarray(gray)),
        jops.sobel_stats(jnp.asarray(gray), stripe=stripe, interpret=True),
    ):
        np.testing.assert_allclose(mag.numpy(), np.asarray(wm), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(st.numpy(), np.asarray(ws), rtol=1e-4)


@pytest.mark.parametrize("hw,stripe", [((128, 128), 32), ((256, 384), 64),
                                       ((128, 640), 128)])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_feature_fused_plain_vs_jax(hw, stripe, dtype):
    r, g, b = _planes(*hw, dtype)
    got = ref.feature_fused_ref(T(r), T(g), T(b))
    jr, jg, jb = jnp.asarray(r), jnp.asarray(g), jnp.asarray(b)
    for want in (
        jref.feature_fused_ref(jr, jg, jb),
        jops.feature_fused(jr, jg, jb, stripe=stripe, interpret=True),
    ):
        for name, gp, wp in zip(("hema", "eosin", "mag", "stats"), got, want):
            rtol = 1e-4 if name == "stats" else 3e-5
            np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=rtol,
                                       atol=1e-4, err_msg=name)


@pytest.mark.parametrize("hw", [(37, 263), (100, 150), (129, 65)])
def test_ragged_shapes_plain_vs_jax_ref(hw):
    """Shapes no Pallas block divides: the port's plain versions (what
    the CUDA kernels are held to, ragged edges masked) still match the
    reference oracles."""
    rng = np.random.default_rng(hw[0] * 1000 + hw[1])
    r, g, b = _planes(*hw, np.uint8, rng)
    jr, jg, jb = jnp.asarray(r), jnp.asarray(g), jnp.asarray(b)
    for gp, wp in zip(ref.color_deconv_ref(T(r), T(g), T(b)),
                      jref.color_deconv_ref(jr, jg, jb)):
        np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=3e-5, atol=3e-5)
    for name, gp, wp in zip(("hema", "eosin", "mag", "stats"),
                            ref.feature_fused_ref(T(r), T(g), T(b)),
                            jref.feature_fused_ref(jr, jg, jb)):
        rtol = 1e-4 if name == "stats" else 3e-5
        np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=rtol,
                                   atol=1e-4, err_msg=name)
    marker, mask = _recon_inputs(*hw, rng)
    np.testing.assert_allclose(
        ref.morph_recon_ref(T(marker), T(mask)).numpy(),
        np.asarray(jref.morph_recon_ref(jnp.asarray(marker), jnp.asarray(mask))),
        atol=1e-5,
    )


def test_constants_match_reference():
    np.testing.assert_array_equal(ref.DECONV_MATRIX, jref.DECONV_MATRIX)
    assert ref.DECONV_MATRIX.dtype == jref.DECONV_MATRIX.dtype
    assert ref.GRAY_WEIGHTS == jref.GRAY_WEIGHTS


def test_ops_on_cpu_tensors_take_plain_version():
    """A CPU tensor goes to the plain version: same values, no launch."""
    ops.reset_launch_counts()
    r, g, b = (T(p) for p in _planes(64, 96, np.uint8))
    for got, want in zip(ops.color_deconv(r, g, b), ref.color_deconv_ref(r, g, b)):
        assert torch.equal(got, want)
    for got, want in zip(ops.feature_fused(r, g, b), ref.feature_fused_ref(r, g, b)):
        assert torch.equal(got, want)
    marker, mask = (T(a) for a in _recon_inputs(64, 96))
    assert torch.equal(ops.morph_recon(marker, mask), ref.morph_recon_ref(marker, mask))
    counts = ops.launch_counts()
    assert {k: counts[k] for k in ("color_deconv", "morph_recon", "feature_fused")} == {
        "color_deconv": 0, "morph_recon": 0, "feature_fused": 0,
    }
    assert sum(counts.values()) == 0


def test_kernel_wrappers_reject_cpu_tensors():
    """The CUDA wrappers launch or raise: a CPU tensor never reaches a
    build, and the counters do not move."""
    ops.reset_launch_counts()
    r, g, b = (T(p) for p in _planes(16, 16, np.uint8))
    marker, mask = (T(a) for a in _recon_inputs(16, 16))
    with pytest.raises(ValueError):
        CD.color_deconv_cuda(r, g, b)
    with pytest.raises(ValueError):
        FF.feature_fused_cuda(r, g, b)
    with pytest.raises(ValueError):
        MR.morph_recon_cuda(marker, mask)
    with pytest.raises(ValueError):
        MR.morph_recon_step(marker, mask)
    assert sum(ops.launch_counts().values()) == 0


def test_ops_reject_other_devices():
    with pytest.raises(ValueError):
        ops.color_deconv(*(torch.zeros(2, 2, device="meta") for _ in range(3)))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A build that cannot run raises; nothing falls back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("color_deconv")


def test_build_target_is_keyed_by_source_hash(monkeypatch, tmp_path):
    """A built library is reused only for the very source it came from."""
    names = {_build._target(n).name for n in _build.KERNELS}
    assert len(names) == len(_build.KERNELS)
    src = (_build.CSRC / "color_deconv.cu").read_text()
    (tmp_path / "color_deconv.cu").write_text(src)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._target("color_deconv")
    (tmp_path / "color_deconv.cu").write_text(src + "\n// edited\n")
    assert _build._target("color_deconv") != before


def test_build_target_follows_included_headers(monkeypatch, tmp_path):
    """A source that includes a ``csrc/`` header is rebuilt when the
    header changes, and only the sources that include it are."""
    for path in _build.CSRC.glob("*.cu*"):
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build._target(n) for n in _build.KERNELS}
    header = tmp_path / "strip_stencil.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build._target(n) for n in _build.KERNELS}
    changed = {n for n in _build.KERNELS if after[n] != before[n]}
    assert changed == {"feature_fused", "sobel_stats"}
