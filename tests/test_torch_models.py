"""The port's language models (``repro_torch.models``) against the JAX
package's (``repro.models``), on smoke configs of every family (hybrid,
dense with MHA + bias and with GQA, moe with and without arctic's dense
residual, ssm, audio, vlm), with the weights of one JAX init carried
across by ``params_from_jax``. whisper's encoder reads seeded frame
embeddings, pixtral seeded patch and text embeddings (the reference's
frontend stubs), each family with the inputs ``tests/test_models.py``
gives it.

Two bars, each with its reason:

* **float32, whole model.** Both models run every activation in float32
  (the port through ``model.float()``, the reference through its own
  code with its bfloat16 casts read as float32, patched here only). The
  prefill logits and 4 teacher-forced decode steps must agree at
  rtol/atol 1e-4: float32 noise, far inside the 2e-2 bar of
  ``tests/test_models.py``. This checks the algorithm (layouts, RoPE,
  the chunked SSD and its scan, cache writes, the ``lengths + 1`` of the
  decode kernel) free of bfloat16 rounding. A whole bfloat16 model
  cannot be held to 2e-2 against another framework: a one-ulp rounding
  difference in one layer (a different summation order) spreads through
  the later layers; the reference's own logits move by more than 2e-2
  between two XLA settings (``xla_allow_excess_precision`` on and off).
* **bfloat16, layer by layer.** As built (bfloat16 activations), each
  block is fed the reference block's input (and, for decode, the
  reference's cache) and must agree at rtol/atol 2e-2, as must the
  logits of the reference's last hidden state.

No test here imports ``hypothesis``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as JA
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro.models import mamba2 as JM
from repro.models import mlp as JMLP
from repro.models import moe as JMOE
from repro.models import transformer as JT
from repro.models import xlstm as JX
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.models import attention as TA
from repro_torch.models import build_model, params_from_jax
from repro_torch.models import layers as TL
from repro_torch.models import mamba2 as TM
from repro_torch.models import transformer as TT

ARCHS = ["zamba2-1.2b", "qwen1.5-4b", "mistral-nemo-12b",  # hybrid, MHA + bias, GQA
         "dbrx-132b", "arctic-480b",                        # moe, moe + dense residual
         "xlstm-125m", "whisper-small", "pixtral-12b"]      # ssm, audio, vlm
B, PROMPT, MAX_LEN, STEPS = 2, 16, 32, 4
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# Leaves the reference inits to 0 or 1; perturbed (the same for both
# packages) so that biases, norm weights and the SSM skip are exercised.
_PERTURB = {"w", "b", "bq", "bk", "bv", "conv_b", "dt_bias", "D", "norm_w"}


def _perturb(tree, rng):
    if isinstance(tree, dict):
        return {k: (v + 0.1 * rng.normal(size=v.shape).astype(np.float32)
                    if k in _PERTURB and not isinstance(v, dict) else _perturb(v, rng))
                for k, v in tree.items()}
    if isinstance(tree, list):  # xLSTM's per-layer blocks
        return [_perturb(v, rng) for v in tree]
    return tree


def model_inputs(cfg, toks, n, embeds=None):
    """Numpy inputs of a prompt of ``n`` positions, as
    ``tests/test_models.py`` builds them per family: token ids; for audio
    also the encoder's frame embeddings; for vlm the patch and text
    embeddings instead (``embeds`` (B, >= n, D), cut to ``n``)."""
    if cfg.family == "audio":
        return {"tokens": toks[:, :n], "embeds": embeds}
    if cfg.frontend == "vision_stub":
        return {"embeds": embeds[:, :n]}
    return {"tokens": toks[:, :n]}


@functools.lru_cache(maxsize=None)
def _embeds(arch):
    """Seeded frontend-stub embeddings: whisper's encoder frames, pixtral's
    patches and text (one per prompt and decode position); None for a
    token-only family."""
    cfg = jax_smoke_config(arch)
    rng = np.random.default_rng(11)
    if cfg.family == "audio":
        return rng.normal(size=(B, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "vision_stub":
        return rng.normal(size=(B, PROMPT + STEPS, cfg.d_model)).astype(np.float32)
    return None


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """(JAX model, JAX params, numpy pytree, token ids) for ``arch``."""
    cfg = jax_smoke_config(arch)
    model = jax_build_model(cfg)
    tree = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    tree = _perturb(tree, np.random.default_rng(1))
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, PROMPT + STEPS))
    return model, jax.tree.map(jnp.asarray, tree), tree, toks.astype(np.int32)


def _port(arch, tree, float32: bool, cfg=None):
    cfg = cfg or get_smoke_config(arch)
    model = build_model(cfg, device="cpu", seed=3)
    if float32:
        model = model.float()  # before loading: weights stay unrounded
    model.load_state_dict(params_from_jax(tree, cfg))
    return model


class _Float32Numpy:
    """``jax.numpy`` with ``bfloat16`` read as ``float32``."""

    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def reference_in_float32(monkeypatch):
    """Run ``repro.models`` with float32 activations and caches: its
    casts to bfloat16 live in ``transformer`` (via ``jnp``) and in
    ``init_kv_cache``'s default. Restored after the test."""
    monkeypatch.setattr(JT, "jnp", _Float32Numpy())
    monkeypatch.setattr(JA.init_kv_cache, "__defaults__", (jnp.float32,))


def _run_reference(model, params, toks, embeds=None):
    prefill = jax.jit(lambda p, inputs: model.prefill(p, inputs, max_len=MAX_LEN))
    step = jax.jit(model.decode_step)
    inputs = model_inputs(model.cfg, toks, PROMPT, embeds)
    logits, caches = prefill(params, {k: jnp.asarray(v) for k, v in inputs.items()})
    out = [np.asarray(logits)]
    for i in range(STEPS):
        pos = jnp.full((B,), PROMPT + i, jnp.int32)
        logits, caches = step(params, caches, jnp.asarray(toks[:, PROMPT + i]), pos)
        out.append(np.asarray(logits))
    return out


def _run_port(model, toks, embeds=None):
    t = torch.as_tensor(toks).long()
    inputs = model_inputs(model.cfg, t, PROMPT, None if embeds is None else torch.as_tensor(embeds))
    logits, caches = model.prefill(inputs, MAX_LEN)
    out = [logits.numpy()]
    for i in range(STEPS):
        pos = torch.full((B,), PROMPT + i, dtype=torch.int32)
        logits, caches = model.decode_step(caches, t[:, PROMPT + i], pos)
        out.append(logits.numpy())
    return out


def _np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def assert_rows_close(got, want, name=""):
    """bfloat16 outputs whose elements can cancel (a MoE's gate-weighted
    sum of experts): each element within 2e-2 of itself plus 2**-6 of the
    largest magnitude in its row, two bfloat16 ulps of that element (the
    decode kernel's bar in ``chip_smoke.py``)."""
    tol = 2e-2 * np.abs(want) + 2.0 ** -6 * np.abs(want).max(axis=-1, keepdims=True)
    bad = np.abs(got - want) > tol
    assert not bad.any(), (name, int(bad.sum()), float(np.abs(got - want).max()))


def _torch(x, dtype=torch.bfloat16):
    return torch.as_tensor(_np(x)).to(dtype)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------


def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 5, 64)) * 3).astype(np.float32)
    w = (1 + 0.1 * rng.normal(size=64)).astype(np.float32)
    np.testing.assert_allclose(TL.rmsnorm(torch.as_tensor(x), torch.as_tensor(w)).numpy(),
                               np.asarray(JL.rmsnorm(jnp.asarray(x), jnp.asarray(w))),
                               rtol=1e-6, atol=1e-6)  # float32 noise
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    got = TL.rmsnorm(_torch(xb), torch.as_tensor(w))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(JL.rmsnorm(xb, jnp.asarray(w))),
                               rtol=2 ** -7, atol=0)  # one bfloat16 ulp


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_matches_reference(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 40, 64)).astype(np.float32)
    pos = np.arange(40)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = TL.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # Per-sequence positions, as decode applies them.
    lens = np.array([3, 17])
    want = JL.apply_rope(jnp.asarray(x[:, :, :1]), jnp.asarray(lens)[:, None, None], theta)
    got = TL.apply_rope(torch.as_tensor(x[:, :, :1]), torch.as_tensor(lens)[:, None, None], theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("length,chunk", [(16, 128), (24, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_train_and_decode_match_reference(length, chunk, dtype):
    """One Mamba2 block: ``mamba2_train(return_state=True)`` over one
    chunk and over three (the scan kernel's recurrence), then one
    ``mamba2_decode`` step from the returned cache. Float32 at 1e-4;
    bfloat16 outputs at 2e-2 (their float32 state at 1e-4)."""
    arch = "zamba2-1.2b"
    _, _, tree, _ = _reference(arch)
    cfg = jax_smoke_config(arch)
    p_np = jax.tree.map(lambda a: a[0], tree["blocks"])["mamba"]
    jp = jax.tree.map(jnp.asarray, p_np)
    port = _port(arch, tree, float32=dtype == "float32")
    tp = port["blocks"][0]["mamba"]
    rng = np.random.default_rng(2)
    jd = getattr(jnp, dtype)
    x = jnp.asarray(rng.normal(size=(B, length, cfg.d_model)).astype(np.float32)).astype(jd)
    xt = jnp.asarray(rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)).astype(jd)
    tol = F32_TOL if dtype == "float32" else BF16_TOL

    jy, jc = JM.mamba2_train(jp, x, cfg, chunk=chunk, return_state=True)
    ty, tc = TM.mamba2_train(tp, _torch(x, getattr(torch, dtype)), cfg, chunk=chunk,
                             return_state=True)
    np.testing.assert_allclose(ty.float().numpy(), _np(jy), **tol)
    for key in ("conv", "ssm"):
        np.testing.assert_allclose(tc[key].numpy(), _np(jc[key]), **F32_TOL, err_msg=key)

    jy, jc = JM.mamba2_decode(jp, xt, jc, cfg)
    ty, tc = TM.mamba2_decode(tp, _torch(xt, getattr(torch, dtype)), tc, cfg)
    np.testing.assert_allclose(ty.float().numpy(), _np(jy), **tol)
    np.testing.assert_allclose(tc["ssm"].numpy(), _np(jc["ssm"]), **F32_TOL)


def test_mamba2_rejects_a_length_the_chunk_does_not_divide():
    arch = "zamba2-1.2b"
    _, _, tree, _ = _reference(arch)
    cfg = get_smoke_config(arch)
    tp = _port(arch, tree, float32=True)["blocks"][0]["mamba"]
    with pytest.raises(ValueError, match="chunk"):
        TM.mamba2_train(tp, torch.zeros(1, 12, cfg.d_model), cfg, chunk=8)


# --------------------------------------------------------------------------
# whole models
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference_float32(arch, reference_in_float32):
    model, params, tree, toks = _reference(arch)
    want = _run_reference(model, params, toks, _embeds(arch))
    got = _run_port(_port(arch, tree, float32=True), toks, _embeds(arch))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, **F32_TOL, err_msg=f"step {i}")


def test_decode_off_by_one_is_caught(reference_in_float32, monkeypatch):
    """The decode layer passes ``lengths + 1`` to the kernel (which
    attends to positions ``< length``). Passing ``lengths`` drops the
    token just written, and the comparison above catches it."""
    arch = "qwen1.5-4b"
    model, params, tree, toks = _reference(arch)
    want = _run_reference(model, params, toks)
    monkeypatch.setattr(TA, "attended_length", lambda lengths: lengths)
    got = _run_port(_port(arch, tree, float32=True), toks)
    np.testing.assert_allclose(got[0], want[0], **F32_TOL)  # prefill is unaffected
    for g, w in zip(got[1:], want[1:]):
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(g, w, **BF16_TOL)


def _caches_to_port(jc, cfg):
    conv = lambda t: {k: torch.as_tensor(_np(v)).to(  # noqa: E731
        torch.bfloat16 if k in ("k", "v") else torch.float32) for k, v in t.items()}
    layers = lambda tree, n: [conv(jax.tree.map(lambda a: a[i], tree))  # noqa: E731
                              for i in range(n)]
    if cfg.family == "ssm":
        return {"xl": [conv(c) for c in jc["xl"]]}
    if cfg.family == "hybrid":
        return {"mamba": layers(jc["mamba"], cfg.n_layers),
                "shared_kv": layers(jc["shared_kv"], jc["shared_kv"]["k"].shape[0])}
    out = {"kv": layers(jc["kv"], cfg.n_layers)}
    if cfg.family == "audio":
        out["enc"] = _torch(jc["enc"])
    return out


def _jax_xl_block(blk, x, cfg):
    """The reference's xLSTM block (inline in its ``train_forward``)."""
    h = JL.apply_norm(cfg.norm, blk["ln"], x, cfg.norm_eps)
    cell = JX.slstm_train if "kind_slstm" in blk else JX.mlstm_train
    return x + cell(blk["cell"], h, cfg)


def _jax_xl_block_decode(blk, x, cache, cfg):
    h = JL.apply_norm(cfg.norm, blk["ln"], x, cfg.norm_eps)
    cell = JX.slstm_decode if "kind_slstm" in blk else JX.mlstm_decode
    y, _ = cell(blk["cell"], h, cache, cfg)
    return x + y


def _jax_ffn(blk, x, cfg):
    """The reference block's FFN residual (``_dense_block_train``'s second
    half): the MoE, plus arctic's dense residual MLP."""
    h = JL.apply_norm(cfg.norm, blk["ln2"], x, cfg.norm_eps)
    y, _ = JMOE.apply_moe(blk["moe"], h, cfg)
    if "mlp" in blk:
        y = y + JMLP.apply_mlp(blk["mlp"], h, cfg.act)
    return x + y


def _jax_cross(blk, x, enc, cfg):
    """The reference decoder block's cross-attention residual."""
    hx = JL.apply_norm(cfg.norm, blk["ln_x"], x, cfg.norm_eps)
    return x + JA.attention_train(blk["xattn"], hx, cfg, causal=False,
                                  kv_override=JA.cross_kv(blk["xattn"], enc))


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_layers_match_reference(arch):
    """As built: every block, fed the reference block's bfloat16 input,
    in prefill and in one decode step (on the reference's caches).

    A MoE block is held in two halves, each fed the reference's input:
    the attention residual at 2e-2, then the FFN residual at
    :func:`assert_rows_close`'s bar. The reference draws its expert
    weights with ``dense_init``'s fan-in of ``shape[0]``, the number of
    experts, so expert outputs reach ~100 at smoke size, where a bfloat16
    ulp is 0.5; XLA's and PyTorch's bfloat16 products round differently in
    a few elements, and where a token's gate-weighted experts cancel, that
    ulp is more than 2e-2 of the small result."""
    model, params, tree, toks = _reference(arch)
    cfg = jax_smoke_config(arch)
    port = _port(arch, tree, float32=False)
    pos = PROMPT
    inputs = {k: jnp.asarray(v) for k, v in model_inputs(cfg, toks, PROMPT, _embeds(arch)).items()}
    x = JT._embed_in(params, cfg, inputs)
    xd = params["embed"][jnp.asarray(toks[:, pos])][:, None, :].astype(jnp.bfloat16)
    _, jcaches = model.prefill(params, inputs, max_len=MAX_LEN)
    tcaches = _caches_to_port(jcaches, cfg)
    lengths_j = jnp.full((B,), pos, jnp.int32)
    lengths_t = torch.full((B,), pos, dtype=torch.int32)
    layer = lambda tree_, i: jax.tree.map(lambda a: a[i], tree_)  # noqa: E731

    def check(name, jy, ty):
        np.testing.assert_allclose(ty.float().numpy(), _np(jy), **BF16_TOL, err_msg=name)

    def check_rows(name, jy, ty):
        assert_rows_close(ty.float().numpy(), _np(jy), name)

    if cfg.family == "audio":
        for i in range(cfg.encoder_layers):
            jy, _ = JT._dense_block_train(layer(params["enc_blocks"], i), x, cfg, causal=False)
            check(f"encoder block {i}", jy, TT._encoder_block(port["enc_blocks"][i], _torch(x), cfg))
            x = jy
        enc = JL.apply_norm(cfg.norm, params["enc_norm"], x, cfg.norm_eps)
        check("encoder norm", enc, TL.apply_norm(cfg.norm, port["enc_norm"], _torch(x), cfg.norm_eps))
        x = params["embed"][inputs["tokens"]].astype(jnp.bfloat16)
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        for i in range(cfg.n_layers):
            jb, tb = layer(params["blocks"], i), port["blocks"][i]
            if "moe" in jb:  # each half of the block on the reference's input
                jnorm = lambda w, h: JL.apply_norm(cfg.norm, w, h, cfg.norm_eps)  # noqa: E731
                tnorm = lambda w, h: TL.apply_norm(cfg.norm, w, _torch(h), cfg.norm_eps)  # noqa: E731
                ja = x + JA.attention_train(jb["attn"], jnorm(jb["ln1"], x), cfg)
                check(f"prefill attention {i}", ja,
                      _torch(x) + TA.attention_train(tb["attn"], tnorm(tb["ln1"], x), cfg))
                jy = _jax_ffn(jb, ja, cfg)
                check_rows(f"prefill ffn {i}", jy,
                           _torch(ja) + TT._ffn(tb, tnorm(tb["ln2"], ja), cfg)[0])
                jad = xd + JA.attention_decode(jb["attn"], jnorm(jb["ln1"], xd),
                                               layer(jcaches["kv"], i), lengths_j, cfg)[0]
                tad = TA.attention_decode(tb["attn"], tnorm(tb["ln1"], xd), tcaches["kv"][i],
                                          lengths_t, cfg)[0]
                check(f"decode attention {i}", jad, _torch(xd) + tad)
                jyd = _jax_ffn(jb, jad, cfg)
                check_rows(f"decode ffn {i}", jyd,
                           _torch(jad) + TT._ffn(tb, tnorm(tb["ln2"], jad), cfg)[0])
            else:
                jy, _ = JT._dense_block_train(jb, x, cfg)
                jyd, _ = JT._dense_block_decode(jb, xd, layer(jcaches["kv"], i), lengths_j, cfg)
                check(f"prefill block {i}", jy, TT._dense_block(tb, _torch(x), cfg)[0])
                tyd, _ = TT._dense_block_decode(tb, _torch(xd), tcaches["kv"][i], lengths_t, cfg)
                check(f"decode block {i}", jyd, tyd)
            if cfg.family == "audio":  # each side's cross-attention on the same input
                jyx, jydx = _jax_cross(jb, jy, enc, cfg), _jax_cross(jb, jyd, enc, cfg)
                check(f"prefill cross {i}", jyx, TT._cross(tb, _torch(jy), _torch(enc), cfg))
                check(f"decode cross {i}", jydx, TT._cross(tb, _torch(jyd), _torch(enc), cfg))
                jy, jyd = jyx, jydx
            x, xd = jy, jyd
    elif cfg.family == "ssm":
        for i, (jb, tb) in enumerate(zip(params["xl_blocks"], port["xl_blocks"])):
            jy = _jax_xl_block(jb, x, cfg)
            check(f"prefill xlstm {i}", jy, TT._xl_block(tb, _torch(x), cfg)[0])
            jyd = _jax_xl_block_decode(jb, xd, jcaches["xl"][i], cfg)
            check(f"decode xlstm {i}", jyd,
                  TT._xl_block_decode(tb, _torch(xd), tcaches["xl"][i], cfg)[0])
            x, xd = jy, jyd
    else:
        segs, off = TT.zamba_segments(cfg), 0
        for si, seg in enumerate(segs):
            for i in range(off, off + seg):
                jb, tb = layer(params["blocks"], i), port["blocks"][i]
                jy = JT._mamba_block_train(jb, x, cfg)
                ty, _ = TT._mamba_block(tb, _torch(x), cfg)
                check(f"prefill mamba {i}", jy, ty)
                jyd, _ = JT._mamba_block_decode(jb, xd, layer(jcaches["mamba"], i), cfg)
                tyd, _ = TT._mamba_block_decode(tb, _torch(xd), tcaches["mamba"][i], cfg)
                check(f"decode mamba {i}", jyd, tyd)
                x, xd = jy, jyd
            off += seg
            if si < len(segs) - 1:
                jy, _ = JT._dense_block_train(params["shared"], x, cfg)
                ty = TT._dense_block(port["shared"], _torch(x), cfg)[0]
                check(f"prefill shared {si}", jy, ty)
                jyd, _ = JT._dense_block_decode(params["shared"], xd,
                                                layer(jcaches["shared_kv"], si), lengths_j, cfg)
                tyd, _ = TT._dense_block_decode(port["shared"], _torch(xd),
                                                tcaches["shared_kv"][si], lengths_t, cfg)
                check(f"decode shared {si}", jyd, tyd)
                x, xd = jy, jyd
    check("prefill logits", JT._lm_head(params, cfg, x), TT._lm_head(port, cfg, _torch(x)))
    check("decode logits", JT._lm_head(params, cfg, xd), TT._lm_head(port, cfg, _torch(xd)))


@pytest.mark.parametrize("arch", ARCHS)
def test_port_prefill_decode_matches_its_forward(arch):
    """The port alone, in bfloat16, as ``tests/test_models.py:72-96``
    holds the reference: prefill(15) logits == forward logits at 14,
    one decode step == forward at 15 == prefill(16), at 2e-2.

    Per family: MoE runs at a capacity that drops nothing (capacity
    depends on the token count, so prefill and forward would otherwise
    drop different pairs); pixtral's last 8 positions are text, embedded
    by the model's own table, so that its decode step (token ids) sees
    what its forward saw; whisper's decode step is held to prefill(16)
    only through its forward's first 15 positions: the reference rotates
    a cross-attention query at its position within the call (0 for a
    decode step), so its decode step is held to the reference's decode
    step instead (``test_prefill_and_decode_match_reference_float32``)."""
    _, _, tree, toks = _reference(arch)
    cfg = get_smoke_config(arch)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    port = _port(arch, tree, float32=False, cfg=cfg)
    t = torch.as_tensor(toks[:, :16]).long()
    embeds = _embeds(arch)
    if cfg.frontend == "vision_stub":
        embeds = torch.cat([torch.as_tensor(embeds[:, :8]), port["embed"][t[:, 8:]].float()], 1)
    inputs = lambda n: model_inputs(cfg, t, n, None if embeds is None  # noqa: E731
                                    else torch.as_tensor(embeds))
    full, _ = port.train_forward(inputs(16))
    assert full.shape == (B, 16, cfg.vocab_size)
    assert bool(torch.isfinite(full).all())
    pre, caches = port.prefill(inputs(15), MAX_LEN)
    np.testing.assert_allclose(pre.numpy(), full[:, 14].numpy(), **BF16_TOL)
    pre16, _ = port.prefill(inputs(16), MAX_LEN)
    np.testing.assert_allclose(pre16.numpy(), full[:, 15].numpy(), **BF16_TOL)
    dec, _ = port.decode_step(caches, t[:, 15], torch.full((B,), 15, dtype=torch.int32))
    assert bool(torch.isfinite(dec).all())
    if cfg.family != "audio":
        np.testing.assert_allclose(dec.numpy(), full[:, 15].numpy(), **BF16_TOL)
        np.testing.assert_allclose(dec.numpy(), pre16.numpy(), **BF16_TOL)


def test_params_from_jax_covers_every_parameter():
    for arch in ARCHS:
        _, _, tree, _ = _reference(arch)
        cfg = get_smoke_config(arch)
        sd = params_from_jax(tree, cfg)
        port = build_model(cfg, device="cpu")
        assert set(sd) == set(port.state_dict()), arch
        for name, value in port.state_dict().items():
            assert tuple(sd[name].shape) == tuple(value.shape), name


def test_unported_families_raise():
    """Every family is ported: each configuration builds, prefills and
    decodes on the CPU. A family the reference does not know raises
    ``ValueError``, as its ``init_model_params`` does."""
    for arch in ARCH_IDS:
        cfg = get_smoke_config(arch)
        model = build_model(cfg, device="cpu")
        toks = torch.zeros((1, 8), dtype=torch.long)
        embeds = torch.zeros((1, cfg.encoder_frames if cfg.family == "audio" else 8, cfg.d_model))
        logits, caches = model.prefill(model_inputs(cfg, toks, 8, embeds), 16)
        logits, _ = model.decode_step(caches, toks[:, 0], torch.full((1,), 8, dtype=torch.int32))
        assert logits.shape == (1, cfg.vocab_size) and bool(torch.isfinite(logits).all()), arch
    with pytest.raises(ValueError, match="unknown family"):
        build_model(dataclasses.replace(get_smoke_config("qwen1.5-4b"), family="rnn"),
                    device="cpu")
