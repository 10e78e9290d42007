"""The port's training slice against the JAX package, on the CPU.

Inputs come from a numpy seed; model weights from one JAX init carried
across by ``params_from_jax``. Bars and their reasons:

* plain backward versions (``repro_torch.kernels.ref.*_bwd_ref``) against
  ``jax.vjp`` of the JAX oracles: float32 summation order only (1e-5);
* optimizers on the same trees: AdamW's arithmetic op by op (1e-6 on
  the update); the int8 quantizers exactly, except where one rounding
  of ``x / scale`` lands on the other side of .5 (one code);
* one train step of a smoke model of every family (zamba2, qwen1.5,
  dbrx, arctic, xLSTM, whisper, pixtral; the MoE balance loss included),
  float32 activations on both sides (``reference_in_float32``): loss and
  aux 1e-5 relative, every
  gradient within 1e-4 of its tensor's norm, every updated parameter
  within 2e-6 plus what the two gradients' float32 difference can move
  Adam's first step, ``lr * g / (|g| + eps)`` (large only for elements
  whose gradient is near ``eps`` or differs in sign);
* five bfloat16 steps of smoke zamba2 and qwen1.5: the loss curves
  within 2e-2 (bfloat16 rounds in other places in the two frameworks,
  see ``test_torch_models.py``). Not for MoE and xLSTM, whose bfloat16
  training amplifies those roundings: a one-ulp difference can move a
  token's top-k choice or capacity rank (a step change in its output),
  and xLSTM's exponential gates compound it over the sequence; their
  five-step curves part by more than 2e-2 (float32, above, holds them).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import TokenChunkSource as JaxTokenChunkSource
from repro.kernels import ref as jref
from repro.models import build_model as jax_build_model
from repro.optim import AdamW as JaxAdamW
from repro.optim import AdamW8bit as JaxAdamW8bit
from repro.optim import compress_int8 as jax_compress_int8
from repro.optim import cosine_schedule as jax_cosine_schedule
from repro.optim import global_norm as jax_global_norm
from repro.optim.adamw8bit import quantize_blockwise as jax_quantize_blockwise
from repro.train import TrainState as JaxTrainState
from repro.train import make_train_step as jax_make_train_step
from repro_torch.ckpt import latest_step, load_checkpoint, save_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.data import ChunkLedger, PrefetchLoader, TokenChunkSource
from repro_torch.kernels import ops, ref
from repro_torch.launch.train import run_training
from repro_torch.models import build_model, params_from_jax
from repro_torch.optim import (AdamW, AdamW8bit, compress_int8, cosine_schedule,
                               decompress_int8, dequantize_blockwise, global_norm,
                               quantize_blockwise)
from repro_torch.staging import HostTier, RegionStore
from repro_torch.train import TrainState, loss_and_grads, make_train_step
from test_torch_models import _perturb, reference_in_float32  # noqa: F401 (fixture)

RNG = np.random.default_rng(19)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.ascontiguousarray(np.asarray(a, np.float32))).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# --------------------------------------------------------------------------
# plain backward versions against jax.vjp of the oracles
# --------------------------------------------------------------------------


@pytest.mark.parametrize("b,h,hkv,s,d", [(1, 2, 2, 64, 32), (2, 8, 2, 37, 64),
                                         (1, 4, 1, 130, 128), (1, 2, 2, 1, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_backward_matches_jax_vjp(b, h, hkv, s, d, causal):
    """GQA (the JAX oracle takes repeated K/V: its vjp sums the groups),
    ragged S, causal and not; through ``ops.flash_attention``'s autograd
    path on CPU tensors (the plain forward with its lse, then the plain
    backward)."""
    q = RNG.normal(0, 1, (b, h, s, d)).astype(np.float32)
    k, v = (RNG.normal(0, 1, (b, hkv, s, d)).astype(np.float32) for _ in range(2))
    g = RNG.normal(0, 1, (b, h, s, d)).astype(np.float32)
    group = h // hkv

    def jfun(q, k, v):
        return jref.flash_attention_ref(q, jnp.repeat(k, group, 1), jnp.repeat(v, group, 1),
                                        causal)

    want_out, vjp = jax.vjp(jfun, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    ops.reset_launch_counts()
    out = ops.flash_attention(tq, tk, tv, causal)
    got = torch.autograd.grad(out, (tq, tk, tv), _t(g))
    assert sum(ops.launch_counts().values()) == 0
    np.testing.assert_allclose(_np(out), np.asarray(want_out), rtol=1e-5, atol=1e-5)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(_np(a), np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_backward_keeps_input_types(dtype):
    td = getattr(torch, dtype)
    q, k, v, dout = (_t(RNG.normal(0, 1, (1, 4, 20, 32)), td) for _ in range(4))
    out, lse = ref.flash_attention_fwd_ref(q, k[:, :2], v[:, :2], True)
    assert lse.dtype == torch.float32 and lse.shape == (1, 4, 20)
    grads = ref.flash_attention_bwd_ref(q, k[:, :2], v[:, :2], out, lse, dout, True)
    assert [t.dtype for t in grads] == [td] * 3
    assert [t.shape for t in grads] == [q.shape, (1, 2, 20, 32), (1, 2, 20, 32)]


@pytest.mark.parametrize("c,h,f", [(1, 3, 5), (4, 6, 33), (9, 16, 64)])
@pytest.mark.parametrize("outputs", ["both", "states", "final"])
def test_mamba2_chunk_scan_plain_backward_matches_jax_vjp(c, h, f, outputs):
    decay = RNG.uniform(0.3, 1.0, (c, h)).astype(np.float32)
    inc = RNG.normal(0, 1, (c, h, f)).astype(np.float32)
    gs = RNG.normal(0, 1, (c, h, f)).astype(np.float32) * (outputs != "final")
    gf = RNG.normal(0, 1, (h, f)).astype(np.float32) * (outputs != "states")
    _, vjp = jax.vjp(jref.mamba2_chunk_scan_ref, jnp.asarray(decay), jnp.asarray(inc))
    want = vjp((jnp.asarray(gs), jnp.asarray(gf)))
    td, ti = _t(decay).requires_grad_(), _t(inc).requires_grad_()
    states, final = ops.mamba2_chunk_scan(td, ti)
    terms = {"both": (states * _t(gs)).sum() + (final * _t(gf)).sum(),
             "states": (states * _t(gs)).sum(), "final": (final * _t(gf)).sum()}
    got = torch.autograd.grad(terms[outputs], (td, ti))
    for name, a, w in zip(("g_decay", "g_inc"), got, want):
        np.testing.assert_allclose(_np(a), np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=name)


# --------------------------------------------------------------------------
# optimizers
# --------------------------------------------------------------------------


def _tree(seed=3):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(0, 1, (6, 5)).astype(np.float32),
            "b": rng.normal(0, 1, (5,)).astype(np.float32),
            "s": np.float32(rng.normal()),
            "k": rng.normal(0, 1, (2, 3, 4)).astype(np.float32)}


def _jax_tree(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch_tree(tree):
    return {k: torch.as_tensor(np.array(v, np.float32)) for k, v in tree.items()}


@pytest.mark.parametrize("opt_name", ["adamw", "adamw8bit"])
@pytest.mark.parametrize("lr", ["const", "cosine"])
def test_optimizer_matches_reference(opt_name, lr):
    """Four updates of the same tree with the same gradients (the last
    one large, so the global-norm clip engages)."""
    jcls, tcls = {"adamw": (JaxAdamW, AdamW), "adamw8bit": (JaxAdamW8bit, AdamW8bit)}[opt_name]
    kw = dict(weight_decay=0.1, clip_norm=1.0)
    jopt = jcls(lr=jax_cosine_schedule(1e-2, 2, 6) if lr == "cosine" else 1e-2, **kw)
    topt = tcls(lr=cosine_schedule(1e-2, 2, 6) if lr == "cosine" else 1e-2, **kw)
    tree = _tree()
    jp, tp = _jax_tree(tree), _torch_tree(tree)
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(4):
        g = _tree(10 + i)
        if i == 3:
            g = {k: v * 100 for k, v in g.items()}
        jp, js = jopt.update(_jax_tree(g), js, jp)
        tp, ts = topt.update(_torch_tree(g), ts, tp)
        for k in tree:
            np.testing.assert_allclose(_np(tp[k]), _np(jp[k]), rtol=1e-6, atol=1e-6,
                                       err_msg=f"step {i} {k}")
    assert int(ts.step) == int(js.step) == 4


def test_adamw_moments_match_reference():
    jopt, topt = JaxAdamW(lr=1e-3), AdamW(lr=1e-3)
    tree, g = _tree(), _tree(7)
    jp, tp = _jax_tree(tree), _torch_tree(tree)
    _, js = jopt.update(_jax_tree(g), jopt.init(jp), jp)
    _, ts = topt.update(_torch_tree(g), topt.init(tp), tp)
    for k in tree:
        np.testing.assert_allclose(_np(ts.mu[k]), _np(js.mu[k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(_np(ts.nu[k]), _np(js.nu[k]), rtol=1e-6, atol=1e-9)
        assert ts.mu[k].dtype == ts.nu[k].dtype == torch.float32


def test_global_norm_and_schedule_match_reference():
    tree = _tree(5)
    np.testing.assert_allclose(float(global_norm(_torch_tree(tree))),
                               float(jax_global_norm(_jax_tree(tree))), rtol=1e-6)
    jl, tl = jax_cosine_schedule(3e-4, 20, 100), cosine_schedule(3e-4, 20, 100)
    for step in (0, 1, 19, 20, 21, 50, 99, 100, 150):
        np.testing.assert_allclose(float(tl(torch.tensor(step, dtype=torch.int32))),
                                   float(jl(jnp.asarray(step, jnp.int32))), rtol=1e-6)


def test_clip_scale_stays_on_the_device_of_the_gradients():
    from repro_torch.optim.adamw import clip_scale

    s = clip_scale({"w": torch.full((3,), 10.0)}, 1.0)
    assert isinstance(s, torch.Tensor) and s.dim() == 0
    np.testing.assert_allclose(float(s), 1.0 / np.sqrt(300.0), rtol=1e-6)


@pytest.mark.parametrize("shape", [(8, 64), (5,), (), (3, 4, 7)])
def test_quantizers_match_reference(shape):
    x = RNG.normal(0, 3, shape).astype(np.float32)
    jq, js = jax_quantize_blockwise(jnp.asarray(x))
    tq, ts = quantize_blockwise(torch.as_tensor(x))
    assert tq.dtype == torch.int8 and tuple(tq.shape) == shape
    np.testing.assert_allclose(_np(ts), _np(js), rtol=1e-7)
    assert np.abs(tq.numpy().astype(int) - np.asarray(jq).astype(int)).max(initial=0) <= 1
    back = dequantize_blockwise(tq, ts, shape)
    np.testing.assert_allclose(_np(back), x, atol=float(ts.max()) / 2 + 1e-6)


@pytest.mark.parametrize("vals", [[0.0], [1.0, -2.0, 3.5], list(np.linspace(-100, 100, 64))])
def test_compress_int8_matches_reference(vals):
    g = np.array(vals, np.float32)
    jq, js = jax_compress_int8(jnp.asarray(g))
    tq, ts = compress_int8(torch.as_tensor(g))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-7)
    back = decompress_int8(tq, ts)
    assert float((back - torch.as_tensor(g)).abs().max()) <= float(ts) + 1e-6


# --------------------------------------------------------------------------
# one train step against repro.train.make_train_step
# --------------------------------------------------------------------------

ARCHS = ["zamba2-1.2b", "qwen1.5-4b", "dbrx-132b", "arctic-480b", "xlstm-125m",
         "whisper-small", "pixtral-12b"]
B, S = 2, 33  # 33 tokens: 32 predicted, one SSD (and mLSTM) chunk of 33


@functools.lru_cache(maxsize=None)
def _reference(arch):
    cfg = jax_smoke_config(arch)
    model = jax_build_model(cfg)
    tree = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    tree = _perturb(tree, np.random.default_rng(1))
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return model, tree, toks


@functools.lru_cache(maxsize=None)
def _embeds(arch, batch=B):
    """Seeded frontend-stub embeddings of a batch (``tests/test_models.py``'s
    inputs): whisper's encoder frames, pixtral's patches and text; None
    for a token-only family."""
    cfg = jax_smoke_config(arch)
    n = cfg.encoder_frames if cfg.family == "audio" else S
    if cfg.frontend == "none":
        return None
    return np.random.default_rng(12).normal(size=(batch, n, cfg.d_model)).astype(np.float32)


def _batch(cfg, toks, embeds, convert):
    """The train batch: token ids (the labels), plus the frontend stub's
    embeddings where the family reads them; ``convert`` makes each array a
    JAX or torch input."""
    out = {"tokens": convert(toks)}
    if embeds is not None:
        out["embeds"] = convert(embeds)
    return out


def _port(arch, tree, act_dtype):
    cfg = get_smoke_config(arch)
    model = build_model(cfg, device="cpu", seed=3, trainable=True, act_dtype=act_dtype)
    model.load_state_dict(params_from_jax(tree, cfg))
    return model


def _jax_step(model, tree, toks, lr, steps=1, embeds=None):
    params = jax.tree.map(jnp.asarray, tree)
    opt = JaxAdamW(lr=lr)
    step = jax.jit(jax_make_train_step(model, opt))
    state = JaxTrainState(params, opt.init(params))
    losses = []
    for i in range(steps):
        state, metrics = step(state, _batch(model.cfg, toks[i % len(toks)], embeds, jnp.asarray))
        losses.append(float(metrics["loss"]))
    return state, losses


def _port_step(model, toks, lr, steps=1, microbatches=1, embeds=None):
    opt = AdamW(lr=lr)
    params = dict(model.named_parameters())
    state = TrainState(params, opt.init(params))
    step = make_train_step(model, opt, microbatches=microbatches)
    losses = []
    for i in range(steps):
        batch = _batch(model.cfg, torch.as_tensor(toks[i % len(toks)]).long(), embeds,
                       torch.as_tensor)
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return state, losses


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference_float32(arch, reference_in_float32):
    jmodel, tree, toks = _reference(arch)
    cfg = get_smoke_config(arch)
    model = _port(arch, tree, torch.float32)
    params = jax.tree.map(jnp.asarray, tree)
    embeds = _embeds(arch)
    batch = _batch(cfg, toks, embeds, jnp.asarray)
    tbatch = _batch(cfg, torch.as_tensor(toks).long(), embeds, torch.as_tensor)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, batch), has_aux=True))(params)
    tloss, tmetrics, tgrads = loss_and_grads(model, tbatch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(model.loss_fn(tbatch)[0].detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(tmetrics["aux"]), float(jmetrics["aux"]), rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), cfg)
    assert set(want) == set(tgrads)
    for name, w in want.items():
        g = tgrads[name]
        assert torch.isfinite(g).all(), name
        bar = 1e-4 * max(float(w.norm()), 1e-6)
        assert float((g - w).abs().max()) <= bar, (name, float((g - w).abs().max()), bar)

    lr = 1e-3
    jstate, jl = _jax_step(jmodel, tree, toks[None], lr, embeds=embeds)
    tstate, tl = _port_step(model, toks[None], lr, embeds=embeds)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    # Adam's first step moves an element by lr * u(g), u(g) = g / (|g| + eps),
    # g the clipped gradient, which the first moment holds as (1 - b1) g: two
    # gradients a float32 noise dg apart give steps at most
    # lr * dg eps / (min|g| + eps)^2 apart, or 2 lr if their signs differ
    # (e.g. qwen's key bias, whose exact gradient is 0: softmax ignores a
    # shift shared by every key).
    jnew = params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg)
    jmu = params_from_jax(jax.tree.map(np.asarray, jstate.opt.mu), cfg)
    eps = 1e-8
    for name, w in jnew.items():
        g1, g2 = tstate.opt.mu[name] / 0.1, jmu[name] / 0.1
        assert float((g1 - g2).abs().max()) <= 1e-4 * max(float(g2.norm()), 1e-6), name
        gmin = torch.minimum(g1.abs(), g2.abs()).double()
        drift = (g1 - g2).abs().double() * eps / (gmin + eps) ** 2
        bound = lr * torch.where(g1.sign() != g2.sign(), torch.full_like(drift, 2.0), drift)
        diff = (tstate.params[name].detach() - w).abs()
        bad = diff.double() > 2e-6 + bound
        assert not bool(bad.any()), (name, float(diff.max()))
    assert int(tstate.opt.step) == 1


#: Families whose five bfloat16 steps are held to the reference's (see the
#: module docstring for MoE and xLSTM).
BF16_CURVE_ARCHS = ["zamba2-1.2b", "qwen1.5-4b"]


@pytest.mark.parametrize("arch", BF16_CURVE_ARCHS)
def test_train_loss_curve_bfloat16_matches_reference(arch):
    jmodel, tree, _ = _reference(arch)
    cfg = get_smoke_config(arch)
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (1, B, S)).astype(np.int32)
    _, jl = _jax_step(jmodel, tree, toks, 1e-3, steps=5, embeds=_embeds(arch))
    _, tl = _port_step(_port(arch, tree, torch.bfloat16), toks, 1e-3, steps=5,
                       embeds=_embeds(arch))
    np.testing.assert_allclose(tl, jl, rtol=2e-2, atol=2e-2)
    assert tl[-1] < tl[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatches_match_full_batch(arch):
    """Two micro-batches of 2 against one batch of 4 (the reference's
    ``test_microbatch_grad_accumulation_matches_full_batch`` bar)."""
    _, tree, _ = _reference(arch)
    toks = np.random.default_rng(9).integers(0, 512, (1, 4, S)).astype(np.int32)
    embeds = _embeds(arch, 4)
    s1, l1 = _port_step(_port(arch, tree, torch.bfloat16), toks, 1e-3, embeds=embeds)
    s2, l2 = _port_step(_port(arch, tree, torch.bfloat16), toks, 1e-3, microbatches=2,
                        embeds=embeds)
    np.testing.assert_allclose(l2, l1, rtol=1e-2)
    d = max(float((s1.params[k] - s2.params[k]).abs().max()) for k in s1.params)
    assert d < 5e-3


def test_remat_gives_the_same_gradients():
    _, tree, toks = _reference("zamba2-1.2b")
    model = _port("zamba2-1.2b", tree, torch.float32)
    batch = {"tokens": torch.as_tensor(toks).long()}
    l1, _, g1 = loss_and_grads(model, batch, remat=True)
    l2, _, g2 = loss_and_grads(model, batch, remat=False)
    assert float(l1) == float(l2)
    for k in g1:
        torch.testing.assert_close(g1[k], g2[k], rtol=1e-6, atol=1e-7)


def test_trainable_model_keeps_float32_masters_and_serving_stays_frozen():
    cfg = get_smoke_config("zamba2-1.2b")
    train = build_model(cfg, device="cpu", trainable=True)
    serve = build_model(cfg, device="cpu")
    assert all(p.requires_grad and p.dtype == torch.float32 for p in train.parameters())
    assert not any(p.requires_grad for p in serve.parameters())
    assert serve["blocks"][0]["mamba"]["in_proj"].dtype == torch.bfloat16
    assert train["blocks"][0]["mamba"]["in_proj"].dtype == torch.float32
    toks = torch.randint(0, cfg.vocab_size, (1, 16))
    logits, aux = train.train_forward({"tokens": toks})
    assert logits.dtype == torch.float32 and float(aux) == 0.0


def test_unported_families_raise_in_training():
    """The MoE balance loss reaches training: ``train_forward`` of a smoke
    moe model (4 layers, each with its loss) returns a positive aux, and
    ``loss_fn`` adds ``aux_weight * aux`` to the NLL."""
    cfg = get_smoke_config("dbrx-132b")
    model = build_model(cfg, device="cpu", trainable=True, act_dtype=torch.float32)
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 16)))
    _, aux = model.train_forward({"tokens": toks})
    assert aux.dtype == torch.float32 and float(aux) > 0
    for w in (0.0, 0.01, 0.5):
        loss, parts = model.loss_fn({"tokens": toks}, aux_weight=w)
        np.testing.assert_allclose(float(loss), float(parts["nll"]) + w * float(aux), rtol=1e-6)
        np.testing.assert_allclose(float(parts["aux"]), float(aux), rtol=1e-6)


def test_loss_fn_masks_negative_labels():
    cfg = get_smoke_config("qwen1.5-4b")
    model = build_model(cfg, device="cpu", trainable=True, act_dtype=torch.float32)
    toks = torch.randint(0, cfg.vocab_size, (2, 9))
    labels = torch.randint(0, cfg.vocab_size, (2, 9))
    full, _ = model.loss_fn({"tokens": toks, "labels": labels})
    masked = labels.clone()
    masked[:, 4:] = -1
    part, _ = model.loss_fn({"tokens": toks, "labels": masked})
    logits, _ = model.train_forward({"tokens": toks})
    logp = torch.log_softmax(logits[:, :4], -1)
    want = -logp.gather(-1, labels[:, :4, None])[..., 0].mean()
    np.testing.assert_allclose(float(part), float(want), rtol=1e-5)
    assert float(full) != float(part)


# --------------------------------------------------------------------------
# data: ledger and loader
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n_chunks,n_workers,block", [(1, 1, 1), (17, 3, 4), (60, 5, 7)])
def test_ledger_no_loss_no_duplicate(n_chunks, n_workers, block):
    led = ChunkLedger(n_chunks, lease_timeout=1e9)
    done, rounds = [], 0
    while not led.done() and rounds < 10_000:
        rounds += 1
        for w in range(n_workers):
            ids = led.lease(w, block)
            if w == 1 and rounds == 2:
                led.worker_lost(w)  # its lease returns to the queue
                continue
            for cid in ids:
                led.commit(w, cid)
                done.append(cid)
    assert led.done() and sorted(done) == list(range(n_chunks))


def test_token_chunks_equal_reference_and_are_deterministic():
    args = dict(vocab=100, seq_len=16, batch_per_chunk=2, seed=1)
    src, jsrc = TokenChunkSource(**args), JaxTokenChunkSource(**args)
    for cid in (0, 42, 9999):
        np.testing.assert_array_equal(src(cid), jsrc(cid))
        np.testing.assert_array_equal(src(cid), src(cid))
    assert src(42).shape == (2, 17) and src(42).dtype == np.int32


def test_loader_yields_every_chunk_once_in_order():
    led = ChunkLedger(11)
    src = TokenChunkSource(vocab=50, seq_len=8, batch_per_chunk=2, seed=2)
    loader = PrefetchLoader(led, src, lease_block=3, device="cpu")
    seen = []
    for cid, batch in loader:
        assert isinstance(batch["tokens"], torch.Tensor)
        np.testing.assert_array_equal(batch["tokens"].numpy(), src(cid))
        seen.append(cid)
        loader.commit(cid)
    assert seen == list(range(11)) and led.done()


def test_loader_serves_re_leased_chunks_from_the_store():
    store = RegionStore([HostTier()])
    src = TokenChunkSource(vocab=50, seq_len=8, batch_per_chunk=2, seed=3)
    first = PrefetchLoader(ChunkLedger(4), src, lease_block=2, device="cpu", store=store)
    assert [cid for cid, _ in first] == [0, 1, 2, 3]
    assert first.staged_chunks == 4 and first.store_hits == 0
    again = PrefetchLoader(ChunkLedger(4), src, lease_block=2, device="cpu", store=store)
    got = {cid: b["tokens"] for cid, b in again}
    assert again.store_hits == 4 and again.staged_chunks == 0
    for cid, toks in got.items():
        np.testing.assert_array_equal(toks.numpy(), src(cid))


# --------------------------------------------------------------------------
# checkpoint
# --------------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    tree = TrainState({"w": torch.arange(12.0).reshape(3, 4)},
                      {"b": [torch.ones(5, dtype=torch.bfloat16), torch.tensor(3)]})
    save_checkpoint(tmp_path, 7, tree, meta={"k": "v"})
    assert latest_step(tmp_path) == 7
    assert (tmp_path / "step_00000007" / "manifest.json").exists()
    assert (tmp_path / "step_00000007" / "shard_00000.pt").exists()
    template = TrainState({"w": torch.zeros(3, 4)},
                          {"b": [torch.zeros(5, dtype=torch.bfloat16), torch.tensor(0)]})
    got, manifest = load_checkpoint(tmp_path, template)
    assert isinstance(got, TrainState)
    assert manifest["step"] == 7 and manifest["meta"]["k"] == "v"
    assert torch.equal(got.params["w"], tree.params["w"])
    assert got.opt["b"][0].dtype == torch.bfloat16 and torch.equal(got.opt["b"][0],
                                                                    tree.opt["b"][0])
    assert int(got.opt["b"][1]) == 3


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    save_checkpoint(tmp_path, 1, {"w": torch.ones(2, 2)})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(tmp_path, {"w": torch.ones(3, 3)})


def test_checkpoint_gc_keeps_latest(tmp_path):
    for s in range(5):
        save_checkpoint(tmp_path, s, {"w": torch.ones(1)}, keep=2)
    steps = sorted(p.name for p in tmp_path.glob("step_*"))
    assert len(steps) == 2 and steps[-1] == "step_00000004"


def test_uncommitted_checkpoint_is_not_restored(tmp_path):
    save_checkpoint(tmp_path, 3, {"w": torch.ones(2)})
    (tmp_path / "step_00000009").mkdir()
    (tmp_path / "step_00000009" / "shard_00000.pt").write_bytes(b"partial")
    assert latest_step(tmp_path) == 3


# --------------------------------------------------------------------------
# run_training on the CPU (the reference's test_train_integration.py)
# --------------------------------------------------------------------------


def test_training_loss_decreases(tmp_path):
    out = run_training(arch="qwen1.5-4b", smoke=True, steps=25, batch=4, seq=64,
                       ckpt_dir=str(tmp_path), ckpt_every=10, log_every=5, device="cpu")
    losses = [m["loss"] for m in out["metrics"]]
    assert out["final_step"] == 25 and out["device"] == "cpu"
    assert losses[-1] < losses[0] * 0.9
    assert np.isfinite(losses).all()


def test_restart_resumes_mid_epoch(tmp_path):
    first = run_training(arch="zamba2-1.2b", smoke=True, steps=12, batch=2, seq=31,
                         ckpt_dir=str(tmp_path), ckpt_every=6, log_every=6, device="cpu")
    saved = {k: v.detach().clone() for k, v in first["state"].params.items()}
    restored, manifest = load_checkpoint(tmp_path, first["state"])
    assert manifest["step"] == 12
    for k, v in saved.items():
        assert torch.equal(restored.params[k], v), k
    out = run_training(arch="zamba2-1.2b", smoke=True, steps=20, batch=2, seq=31,
                       ckpt_dir=str(tmp_path), resume=True, log_every=4, device="cpu")
    assert out["final_step"] == 20
    assert out["chunks"] <= 20 - 12 + 4  # + prefetch overshoot


def test_injected_failure_then_recovery(tmp_path):
    with pytest.raises(RuntimeError, match="injected failure"):
        run_training(smoke=True, steps=20, batch=2, seq=32, ckpt_dir=str(tmp_path),
                     ckpt_every=5, fail_at=8, log_every=5, device="cpu")
    out = run_training(smoke=True, steps=20, batch=2, seq=32, ckpt_dir=str(tmp_path),
                       resume=True, log_every=5, device="cpu")
    assert out["final_step"] == 20  # resumed from the step-5 checkpoint
