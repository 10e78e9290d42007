"""The port's Mixture-of-Experts (``repro_torch.models.moe``) against the
JAX package's (``repro.models.moe``), on the smoke configs of dbrx (16
experts top-4 cut to 4 top-2) and arctic (128 top-2 cut to 4 top-2, with
its dense residual FFN), with the reference's weights carried across.

Bars: the routing (experts, ranks, kept pairs) and the capacity
exactly; the gates and the balance loss within 1e-5; the outputs per
token row (:func:`assert_rows_close`): float32 within 1e-5 (summation
order of the expert products), bfloat16 within 2e-2 plus two bfloat16
ulps of the row's largest element. The reference draws its expert
weights with ``dense_init``'s fan-in of ``shape[0]``, the number of
experts, so expert outputs reach ~100 here and a token's gate-weighted
sum of experts can cancel to a small value whose error is that of the
large terms. A capacity factor of 0.5 makes the capacity drop pairs,
which the tests assert before comparing.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import mlp as JMLP
from repro.models import moe as JMOE
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TT

ARCHS = ["dbrx-132b", "arctic-480b"]
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _configs(arch, capacity_factor=None):
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
        tcfg = dataclasses.replace(tcfg, capacity_factor=capacity_factor)
    return jcfg, tcfg


def _params(cfg, seed=0):
    """The reference's MoE weights, as JAX arrays and as torch tensors."""
    p = JMOE.init_moe(jax.random.PRNGKey(seed), cfg)
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _x(cfg, shape=(2, 24), seed=1):
    return np.random.default_rng(seed).normal(size=(*shape, cfg.d_model)).astype(np.float32)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_rows_close(got, want, rtol, row_tol):
    """Each element within ``rtol`` of itself plus ``row_tol`` of the
    largest magnitude in its row (one token's output)."""
    tol = rtol * np.abs(want) + row_tol * np.abs(want).max(axis=-1, keepdims=True)
    bad = np.abs(got - want) > tol
    assert not bad.any(), (int(bad.sum()), float(np.abs(got - want).max()))


F32_ROWS = (1e-5, 1e-5)
BF16_ROWS = (2e-2, 2.0 ** -6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n", [1, 2, 7, 48, 1000, 4096])
def test_capacity_matches_reference(arch, n):
    """At smoke size and at the published width (16 and 128 experts)."""
    jcfg, tcfg = _configs(arch)
    assert TMOE.moe_capacity(n, tcfg) == JMOE.moe_capacity(n, jcfg)
    assert TMOE.moe_capacity(n, get_config(arch)) == JMOE.moe_capacity(n, jax_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [None, 0.5])
def test_routing_matches_reference(arch, capacity_factor):
    """Experts, ranks in token order, kept pairs and the balance loss."""
    jcfg, tcfg = _configs(arch, capacity_factor)
    jp, tp = _params(jcfg)
    x = _x(jcfg).reshape(-1, jcfg.d_model)
    gates, ids, ranks, keep, cap, aux = TMOE.route(tp, torch.as_tensor(x), tcfg)
    n, e, k = x.shape[0], jcfg.n_experts, jcfg.top_k
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
    jgates, jids = jax.lax.top_k(probs, k)
    jgates = jgates / jnp.maximum(jgates.sum(-1, keepdims=True), 1e-9)
    flat = np.asarray(jids).reshape(-1)
    onehot = np.eye(e, dtype=np.int64)[flat]
    jranks = (np.cumsum(onehot, 0) - onehot)[np.arange(n * k), flat]
    assert cap == JMOE.moe_capacity(n, jcfg)
    np.testing.assert_array_equal(ids.numpy(), flat)
    np.testing.assert_array_equal(ranks.numpy(), jranks)
    np.testing.assert_array_equal(keep.numpy(), jranks < cap)
    np.testing.assert_allclose(gates.numpy(), np.asarray(jgates), **F32_TOL)
    if capacity_factor is not None:
        assert int((~keep).sum()) > 0, "the capacity drops no pair"


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [None, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_moe_matches_reference(arch, capacity_factor, dtype):
    """Output (B, S, D) in x's type and the float32 aux loss."""
    jcfg, tcfg = _configs(arch, capacity_factor)
    jp, tp = _params(jcfg)
    xj = jnp.asarray(_x(jcfg)).astype(getattr(jnp, dtype))
    xt = torch.from_numpy(_np(xj).copy()).to(getattr(torch, dtype))
    if dtype == "bfloat16":  # stored as a built model stores them
        tp = {k: v.bfloat16() if k != "router" else v for k, v in tp.items()}
    jy, jaux = JMOE.apply_moe(jp, xj, jcfg)
    ty, taux = TMOE.apply_moe(tp, xt, tcfg)
    assert ty.dtype == xt.dtype and ty.shape == xt.shape and taux.dtype == torch.float32
    assert_rows_close(ty.float().numpy(), _np(jy), *(F32_ROWS if dtype == "float32" else BF16_ROWS))
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert float(taux) > 0


def test_dropped_pairs_contribute_nothing():
    """A token whose every pair is past the capacity comes out as 0."""
    jcfg, tcfg = _configs("dbrx-132b", capacity_factor=0.1)
    _, tp = _params(jcfg)
    x = torch.as_tensor(_x(jcfg))
    y, _ = TMOE.apply_moe(tp, x, tcfg)
    _, _, _, keep, _, _ = TMOE.route(tp, x.reshape(-1, tcfg.d_model), tcfg)
    dropped = ~keep.view(-1, tcfg.top_k).any(-1)
    assert int(dropped.sum()) > 0
    assert float(y.reshape(-1, tcfg.d_model)[dropped].abs().max()) == 0.0


def test_apply_moe_is_deterministic():
    """Repeated calls give the same bits (no accumulating scatter)."""
    _, tcfg = _configs("arctic-480b", capacity_factor=0.5)
    _, tp = _params(tcfg)
    x = torch.as_tensor(_x(tcfg))
    y1, a1 = TMOE.apply_moe(tp, x, tcfg)
    y2, a2 = TMOE.apply_moe(tp, x, tcfg)
    assert torch.equal(y1, y2) and torch.equal(a1, a2)


def test_arctic_dense_residual_matches_reference():
    """arctic's FFN: the MoE plus a parallel dense MLP on the same input,
    float32, as the reference's ``_dense_block_train`` adds them."""
    jcfg, tcfg = _configs("arctic-480b")
    assert tcfg.moe_dense_residual
    jp, tp = _params(jcfg)
    jm = JMLP.init_mlp(jax.random.PRNGKey(5), jcfg.d_model, jcfg.d_ff, jcfg.act)
    tm = {k: torch.as_tensor(np.array(v)) for k, v in jm.items()}
    x = jnp.asarray(_x(jcfg, seed=4))
    jy, jaux = JMOE.apply_moe(jp, x, jcfg)
    jy = jy + JMLP.apply_mlp(jm, x, jcfg.act)
    ty, taux = TT._ffn({"moe": tp, "mlp": tm}, torch.from_numpy(np.array(x)), tcfg)
    assert_rows_close(ty.numpy(), np.asarray(jy), *F32_ROWS)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    # Without the residual the FFN is the MoE alone.
    ty0, _ = TT._ffn({"moe": tp}, torch.from_numpy(np.array(x)), tcfg)
    assert float((ty - ty0).abs().max()) > 0


def test_gelu_experts_match_reference():
    """A MoE with GeLU experts (the reference's other activation)."""
    jcfg, tcfg = (dataclasses.replace(c, act="gelu") for c in _configs("dbrx-132b"))
    jp, tp = _params(jcfg)
    x = _x(jcfg)
    jy, _ = JMOE.apply_moe(jp, jnp.asarray(x), jcfg)
    ty, _ = TMOE.apply_moe(tp, torch.as_tensor(x), tcfg)
    assert_rows_close(ty.numpy(), np.asarray(jy), *F32_ROWS)
