"""The port's ``attention_options`` against the reference's
(``repro.models.attention.attention_options``), on the smoke config of
mistral-nemo (GQA) with the reference's weights carried across.

* ``kv_quant``: a decode chain from empty int8 caches (``init_caches``
  under the option; the reference's ``prefill`` returns bfloat16 caches
  whatever the option says, so only such a chain reaches the int8
  path), float32 activations on both sides: the int8 rows equal, their
  scales within 1e-5 relative (float32 noise of the K/V rows) and each
  step's logits within 1e-3, up to the first code that float32 noise
  rounds to the other side of .5 (see the test). The quantiser alone,
  on the same rows: codes equal, scales within 1e-7.
* ``causal_skip``: changes no number. The port's attention under it is
  bit-equal to the port's without it, and within float32 noise (1e-5)
  of the reference's triangular loop at a length that splits into
  several query blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention as TA
from repro_torch.models import build_model
from test_torch_models import _port, _reference, reference_in_float32  # noqa: F401 (fixture)

ARCH = "mistral-nemo-12b"
STEPS, MAX_LEN = 12, 16


def _chain_reference(model, params, toks):
    with JA.attention_options(kv_quant=True):
        caches = model.init_caches(toks.shape[0], MAX_LEN)
        step = jax.jit(model.decode_step)
        out = []
        for i in range(STEPS):
            pos = jnp.full((toks.shape[0],), i, jnp.int32)
            logits, caches = step(params, caches, jnp.asarray(toks[:, i]), pos)
            out.append(np.asarray(logits))
    return out, caches


def _chain_port(model, toks):
    t = torch.as_tensor(toks).long()
    with TA.attention_options(kv_quant=True):
        caches = model.init_caches(t.shape[0], MAX_LEN)
        out = []
        for i in range(STEPS):
            pos = torch.full((t.shape[0],), i, dtype=torch.int32)
            logits, caches = model.decode_step(caches, t[:, i], pos)
            out.append(logits.numpy())
    return out, caches


def test_int8_decode_chain_matches_reference(reference_in_float32, monkeypatch):
    """Both chains write the same int8 codes and give the same logits
    (1e-3) until the first position where a code differs; that first
    difference is one code, at an element whose ``x / scale`` lies within
    float32 noise (1e-4) of a rounding boundary (.5), where the two
    frameworks' float32 K/V rows, equal to about 1e-7, round apart. From
    there the chains part (a one-code change moves later logits by about
    1e-3), so later steps are not compared."""
    rows = []  # the port's float32 rows at each quantisation, in call order
    quant_rows = TA._quant_rows

    def recording(x):
        q, scale = quant_rows(x)
        rows.append((x.float() / scale).numpy())
        return q, scale

    monkeypatch.setattr(TA, "_quant_rows", recording)
    model, params, tree, toks = _reference(ARCH)
    want, jcaches = _chain_reference(model, params, toks)
    got, tcaches = _chain_port(_port(ARCH, tree, float32=True), toks)
    assert set(jcaches["kv"]) == {"k_q", "k_s", "v_q", "v_s"}
    n_layers = len(tcaches["kv"])
    codes = {(layer, key): (tc[key].numpy().astype(np.int64),
                            np.asarray(jcaches["kv"][key][layer]).astype(np.int64))
             for layer, tc in enumerate(tcaches["kv"]) for key in ("k_q", "v_q")}
    for (layer, key), (t, _) in codes.items():
        assert tcaches["kv"][layer][key].dtype == torch.int8
    differs = [pos for pos in range(STEPS)
               if any((t[:, :, pos] != j[:, :, pos]).any() for t, j in codes.values())]
    first = differs[0] if differs else STEPS
    assert first >= STEPS // 2, f"codes differ from position {first}"
    for i in range(first):
        np.testing.assert_allclose(got[i], want[i], rtol=1e-3, atol=1e-3, err_msg=f"step {i}")
    for layer, tc in enumerate(tcaches["kv"]):
        for key in ("k_s", "v_s"):
            np.testing.assert_allclose(tc[key].numpy()[:, :, :first],
                                       np.asarray(jcaches["kv"][key][layer])[:, :, :first],
                                       rtol=1e-5, atol=0, err_msg=f"layer {layer} {key}")
    if differs:  # the first differing position: one code, at a boundary
        for (layer, key), (t, j) in codes.items():
            d = t[:, :, first] - j[:, :, first]
            if not d.any():
                continue
            assert np.abs(d).max() == 1, (layer, key)
            x = rows[2 * (first * n_layers + layer) + (key == "v_q")]
            frac = np.abs(x - np.floor(x)) - 0.5
            assert np.abs(frac[d != 0]).max() < 1e-4, (layer, key, frac[d != 0])
            break


@pytest.mark.parametrize("shape", [(2, 4, 64), (3, 8, 128)])
def test_quant_rows_match_reference(shape):
    x = np.random.default_rng(4).normal(0, 2, shape).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero row: scale 1e-12, codes 0
    jq, js = JA._quant_rows(jnp.asarray(x))
    tq, ts = TA._quant_rows(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == (*shape[:2], 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7, atol=0)


def test_init_kv_cache_under_the_options():
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg, device="cpu")
    plain = model.init_caches(2, 8)["kv"][0]
    assert set(plain) == {"k", "v"} and plain["k"].dtype == torch.bfloat16
    with TA.attention_options(kv_quant=True):
        quant = model.init_caches(2, 8)["kv"][0]
        with TA.attention_options(kv_quant=False):
            assert set(model.init_caches(2, 8)["kv"][0]) == {"k", "v"}
        assert TA._KV_QUANT
    assert not TA._KV_QUANT
    slots, hd = plain["k"].shape[1], plain["k"].shape[3]
    assert quant["k_q"].shape == (2, slots, 8, hd) and quant["k_q"].dtype == torch.int8
    assert quant["k_s"].shape == (2, slots, 8, 1) and quant["k_s"].dtype == torch.float32
    # prefill keeps its float caches under the option, as the reference's.
    with TA.attention_options(kv_quant=True):
        _, caches = model.prefill({"tokens": torch.zeros((2, 4), dtype=torch.long)}, 8)
    assert set(caches["kv"][0]) == {"k", "v"}


@pytest.mark.parametrize("causal", [True, False])
def test_causal_skip_changes_nothing(causal):
    """1040 positions: the reference's triangular loop runs 8 query
    blocks of 130 over 2 key blocks of 520."""
    _, params, tree, _ = _reference(ARCH)
    cfg = get_smoke_config(ARCH)
    port = _port(ARCH, tree, float32=True)
    jp = jax.tree.map(lambda a: a[0], params["blocks"])["attn"]
    tp = port["blocks"][0]["attn"]
    x = np.random.default_rng(6).normal(size=(1, 1040, cfg.d_model)).astype(np.float32)
    base = TA.attention_train(tp, torch.from_numpy(x), cfg, causal=causal)
    with TA.attention_options(causal_skip=True):
        skip = TA.attention_train(tp, torch.from_numpy(x), cfg, causal=causal)
        assert TA._CAUSAL_SKIP
    assert not TA._CAUSAL_SKIP
    assert torch.equal(base, skip)
    with JA.attention_options(causal_skip=True):
        want = JA.attention_train(jp, jnp.asarray(x), cfg, causal=causal)
    np.testing.assert_allclose(skip.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
