"""The port's WSI application (``repro_torch.app``) against the JAX
package: every accel op on ``device="cpu"`` against its ``*_accel``
counterpart fed the same numpy state, the three kernel ops against the
JAX ``tpu`` (Pallas, interpret) variants, the whole tile at the bars
of ``tests/test_app.py``, and the shared constants."""

from dataclasses import asdict

import numpy as np
import pytest
import torch

import repro.app.features as JF
import repro.app.pipeline as JP
import repro.app.segmentation as JS
import repro.core.calibration as JC
from repro.app import run_tile as jax_run_tile
from repro.app.tiles import synth_tile as jax_synth_tile
from repro.core.variants import VariantRegistry as JaxRegistry
from repro.core.worker import OpContext as JaxOpContext
from repro.core.workflow import DataChunk as JaxChunk
from repro_torch.app import features as TF
from repro_torch.app import pipeline as TP
from repro_torch.app import segmentation as TS
from repro_torch.app import run_tile, synth_tile
from repro_torch.core import calibration as TC
from repro_torch.core import DataChunk, OpContext, VariantRegistry
from repro_torch.kernels import ref as tref

SIZE = 128
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def tile():
    return jax_synth_tile(1, size=SIZE, seed=3)


@pytest.fixture(scope="module")
def states(tile):
    """Input state of every op along the reference numpy path."""
    out, state = {}, tile
    for name in JP._SEG_ORDER + ("color_deconv",):
        out[name] = state
        state = JP.OP_IMPLS[name][0](state)
    for name in JC.PARALLEL_FEATURE_OPS:
        out[name] = state
    out["feature_fused"] = state
    return out


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# (op, key, comparison): "eq" exact, "agree" >0.999 of elements equal,
# else (rtol, atol).
_CHECKS = {
    "rbc_detection": [("gray", (1e-6, 1e-4)), ("fg", "agree"), ("rbc", "eq")],
    "morph_open": [("fg_open", "eq")],
    "recon_to_nuclei": [("recon", (1e-6, 1e-4)), ("nuclei", "agree")],
    "area_threshold": [("mask_at", "eq")],
    "fill_holes": [("mask", "eq")],
    "pre_watershed": [("dist", "eq"), ("markers", "eq")],
    "watershed": [("labels", "eq")],
    "bwlabel": [("objects", "eq"), ("n_objects", "eq")],
    "color_deconv": [("hema", (3e-5, 3e-5)), ("eosin", (3e-5, 3e-5))],
    # index_add_ sums in another order than segment_sum (test_app bars).
    "pixel_stats": [("feat_pixel", (1e-3, 1e-4))],
    "gradient_stats": [("feat_gradient", (1e-3, 1e-4))],
    "haralick": [("feat_haralick", (1e-4, 1e-5))],
    "canny_edge": [("feat_canny", (1e-3, 1e-4))],
    "morphometry": [("feat_morph", (1e-3, 1e-4))],
    "feature_fused": [("hema", (3e-5, 3e-5)), ("eosin", (3e-5, 3e-5)),
                      ("feat_pixel", (1e-3, 1e-4)), ("feat_gradient", (1e-3, 1e-4))],
}


def _compare(got, want, checks):
    for key, how in checks:
        g, w = _np(got[key]), _np(want[key])
        if how == "eq":
            np.testing.assert_array_equal(g, w, err_msg=key)
        elif how == "agree":
            assert g.shape == w.shape and (g == w).mean() > 0.999, key
        else:
            np.testing.assert_allclose(g, w, rtol=how[0], atol=how[1], err_msg=key)


def _jax_accel(name):
    if name == "feature_fused":
        return JP._feature_fused_accel
    return JP.OP_IMPLS[name][1]


def _torch_accel(name):
    if name == "feature_fused":
        return TP._feature_fused_accel
    return TP.OP_IMPLS[name][1]


@pytest.mark.parametrize("name", list(_CHECKS))
def test_accel_op_matches_jax(states, name):
    state = states[name]
    got = _torch_accel(name)(state, device="cpu")
    want = _jax_accel(name)(state)
    _compare(got, want, _CHECKS[name])


@pytest.mark.parametrize("name", ["color_deconv", "recon_to_nuclei", "feature_fused"])
def test_kernel_ops_match_jax_tpu_variants(states, name):
    """The port's gpu variants (kernels through ``ops``, plain versions
    here) against the JAX package's Pallas ``tpu`` variants."""
    jreg = JaxRegistry()
    JP.register_variants(jreg, with_pallas=True)
    treg = TP.register_variants(VariantRegistry(), device="cpu")
    state = states[name]
    dep = {"color_deconv": "bwlabel", "recon_to_nuclei": "morph_open",
           "feature_fused": "bwlabel"}[name]
    want = jreg.get(name).implementation("tpu")(
        JaxOpContext(chunk=JaxChunk(0, payload=None), inputs={dep: state},
                     lane_kind="tpu"))
    got = treg.get(name).implementation("gpu")(
        OpContext(chunk=DataChunk(0, payload=None), inputs={dep: state},
                  lane_kind="gpu"))
    checks = [c for c in _CHECKS[name] if c[0] in want]
    _compare(got, want, checks)


def test_run_tile_matches_jax(tile):
    """The whole slice at the bars of tests/test_app.py:25-39, against
    both JAX paths; the port's numpy path equals the reference's."""
    s_port = run_tile(tile, "accel", device="cpu")
    s_cpu = jax_run_tile(tile, "cpu")
    s_acc = jax_run_tile(tile, "accel")
    for want in (s_cpu, s_acc):
        assert s_port["n_objects"] == want["n_objects"]
        assert (_np(s_port["mask"]) == _np(want["mask"])).mean() > 0.999
        np.testing.assert_allclose(s_port["feat_haralick"], _np(want["feat_haralick"]),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(s_port["feat_pixel"], _np(want["feat_pixel"]),
                                   rtol=1e-3, atol=1e-4)
    s_port_cpu = run_tile(tile, "cpu")
    for key in ("mask", "objects", "feat_pixel", "feat_gradient", "feat_haralick",
                "feat_canny", "feat_morph"):
        np.testing.assert_array_equal(s_port_cpu[key], s_cpu[key], err_msg=key)


def test_accel_outputs_on_device_and_feats_on_host(states):
    s = TP.OP_IMPLS["recon_to_nuclei"][1](states["recon_to_nuclei"], device="cpu")
    assert isinstance(s["recon"], torch.Tensor) and s["recon"].device == CPU
    s = TP.OP_IMPLS["pixel_stats"][1](states["pixel_stats"], device="cpu")
    assert isinstance(s["feat_pixel"], np.ndarray)
    s = TP.OP_IMPLS["bwlabel"][1](states["bwlabel"], device="cpu")
    assert isinstance(s["n_objects"], int)


def test_synth_tile_matches_reference():
    for tid in (0, 5):
        np.testing.assert_array_equal(synth_tile(tid, size=64, seed=2),
                                      jax_synth_tile(tid, size=64, seed=2))


def test_constants_match_reference():
    np.testing.assert_array_equal(tref.DECONV_MATRIX, TF._DECONV)
    np.testing.assert_array_equal(TF.STAIN_MATRIX, JF.STAIN_MATRIX)
    np.testing.assert_array_equal(TF._DECONV, JF._DECONV)
    np.testing.assert_array_equal(TF._SOBEL_X, JF._SOBEL_X)
    np.testing.assert_array_equal(TF._SOBEL_Y, JF._SOBEL_Y)
    assert TF._GLCM_LEVELS == JF._GLCM_LEVELS
    assert TS.MAX_OBJECTS == JS.MAX_OBJECTS == 256
    as_dicts = lambda profiles: {k: asdict(v) for k, v in profiles.items()}  # noqa: E731
    assert as_dicts(TC.OP_PROFILES) == as_dicts(JC.OP_PROFILES)
    assert TC.PARALLEL_FEATURE_OPS == JC.PARALLEL_FEATURE_OPS
    assert TC.FUSED_FEATURE_OPS == JC.FUSED_FEATURE_OPS
    assert TP._SEG_ORDER == JP._SEG_ORDER
    assert set(TP.OP_IMPLS) == set(JP.OP_IMPLS)
