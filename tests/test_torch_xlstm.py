"""The port's xLSTM cells (``repro_torch.models.xlstm``) against the JAX
package's (``repro.models.xlstm``) in float32, with the reference's
weights carried across, and the port's own train-against-decode chain at
the bars of ``tests/test_sequence_mixers.py`` (3e-3 mLSTM, 1e-4 sLSTM).

Cells are compared over one mLSTM chunk (24 steps) and over three (384
steps: the inter-chunk (C, n, m) carry), then one decode step from the
returned state. Float32 bars: outputs and states within 1e-4 (the
stabilised exponentials of float32 gates, summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import xlstm as JX
from repro.models.config import reduced as jax_reduced
from repro_torch.configs import get_config
from repro_torch.models import xlstm as TX
from repro_torch.models.config import reduced

TOL = dict(rtol=1e-4, atol=1e-4)


def _configs(**small):
    return (jax_reduced(jax_config("xlstm_125m"), **small),
            reduced(get_config("xlstm_125m"), **small))


def _params(init, cfg, seed):
    p = init(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    # norm_w and the biases start at 1 and constants: perturbed alike.
    p = {k: (np.array(v) + 0.1 * rng.normal(size=v.shape).astype(np.float32)
             if k in ("norm_w", "b", "b_if") else np.array(v)) for k, v in p.items()}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _x(cfg, length, seed=0, scale=1.0):
    return np.random.default_rng(seed).normal(0, scale, (2, length, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("length", [24, 384])
def test_mlstm_train_and_decode_match_reference(length):
    jcfg, tcfg = _configs()
    jp, tp = _params(JX.init_mlstm, jcfg, 1)
    x, xt = _x(jcfg, length), _x(jcfg, 1, seed=5)
    jy, jst = JX.mlstm_train(jp, jnp.asarray(x), jcfg, return_state=True)
    ty, tst = TX.mlstm_train(tp, torch.from_numpy(x), tcfg, return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for key in ("C", "n", "m"):
        np.testing.assert_allclose(tst[key].numpy(), np.asarray(jst[key]), **TOL, err_msg=key)
    jy, jst = JX.mlstm_decode(jp, jnp.asarray(xt), jst, jcfg)
    ty, tst = TX.mlstm_decode(tp, torch.from_numpy(xt), tst, tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for key in ("C", "n", "m"):
        np.testing.assert_allclose(tst[key].numpy(), np.asarray(jst[key]), **TOL, err_msg=key)


@pytest.mark.parametrize("length", [24, 384])
def test_slstm_train_and_decode_match_reference(length):
    jcfg, tcfg = _configs()
    jp, tp = _params(JX.init_slstm, jcfg, 2)
    x, xt = _x(jcfg, length), _x(jcfg, 1, seed=5)
    jy, jst = JX.slstm_train(jp, jnp.asarray(x), jcfg, return_state=True)
    ty, tst = TX.slstm_train(tp, torch.from_numpy(x), tcfg, return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for key in "cnmh":
        np.testing.assert_allclose(tst[key].numpy(), np.asarray(jst[key]), **TOL, err_msg=key)
    jy, jst = JX.slstm_decode(jp, jnp.asarray(xt), jst, jcfg)
    ty, tst = TX.slstm_decode(tp, torch.from_numpy(xt), tst, tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for key in "cnmh":
        np.testing.assert_allclose(tst[key].numpy(), np.asarray(jst[key]), **TOL, err_msg=key)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_empty_caches_match_reference(kind):
    jcfg, tcfg = _configs()
    jc = getattr(JX, f"init_{kind}_cache")(3, jcfg)
    tc = getattr(TX, f"init_{kind}_cache")(3, tcfg)
    assert set(jc) == set(tc)
    for key in jc:
        assert tc[key].dtype == torch.float32
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]), err_msg=key)


def _small():
    """``tests/test_sequence_mixers.py``'s config: d 64, two heads."""
    return reduced(get_config("xlstm_125m"), d_model=64, n_heads=2, n_kv_heads=2, head_dim=32)


def _chain(decode, p, x, cache, cfg):
    outs = []
    for t in range(x.shape[1]):
        y, cache = decode(p, x[:, t : t + 1], cache, cfg)
        outs.append(y)
    return torch.cat(outs, dim=1), cache


def test_mlstm_train_matches_decode_chain():
    """The reference's ``test_mlstm_train_matches_decode_chain`` on the
    port: output and C within 3e-3."""
    cfg = _small()
    p = TX.init_mlstm(torch.Generator().manual_seed(2), cfg)
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 0.5, (2, 24, 64)).astype(np.float32))
    y_train, st = TX.mlstm_train(p, x, cfg, return_state=True)
    y_dec, cache = _chain(TX.mlstm_decode, p, x, TX.init_mlstm_cache(2, cfg), cfg)
    np.testing.assert_allclose(y_train.numpy(), y_dec.numpy(), rtol=3e-3, atol=3e-3)
    np.testing.assert_allclose(st["C"].numpy(), cache["C"].numpy(), rtol=3e-3, atol=3e-3)


def test_slstm_train_matches_decode_chain():
    """The reference's ``test_slstm_train_matches_decode_chain`` on the
    port: output within 1e-4."""
    cfg = _small()
    p = TX.init_slstm(torch.Generator().manual_seed(3), cfg)
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 0.5, (2, 16, 64)).astype(np.float32))
    y_train, st = TX.slstm_train(p, x, cfg, return_state=True)
    y_dec, cache = _chain(TX.slstm_decode, p, x, TX.init_slstm_cache(2, cfg), cfg)
    np.testing.assert_allclose(y_train.numpy(), y_dec.numpy(), rtol=1e-4, atol=1e-4)
    for key in "cnmh":
        np.testing.assert_allclose(st[key].numpy(), cache[key].numpy(), rtol=1e-4, atol=1e-4)


def test_mlstm_rejects_a_length_the_chunk_does_not_divide():
    cfg = _small()
    p = TX.init_mlstm(torch.Generator().manual_seed(2), cfg)
    with pytest.raises(ValueError, match="chunk"):
        TX.mlstm_train(p, torch.zeros(1, 200, 64), cfg)
