"""The port's multi-rank layer (``launch/{mesh,sharding,spmd,elastic}.py``,
``optim.ef_roundtrip``, ``train.make_compressed_dp_grads``) on ``gloo``
ranks spawned on the CPU, against one rank and against the JAX package.

Each job runs once (a module-scoped fixture) in spawned ranks with a
``file://`` rendezvous under a temporary directory (no ports), each
spawn under its own time limit; a rank that raises or hangs fails the
tests that read it. Weights come from one JAX init
(``test_torch_train._reference``) carried across by ``params_from_jax``;
every rank loads the whole tree and keeps its chunk.

Why one rank is the oracle of the sharded runs: the reference's own
sharded training step cannot run in this container. Its
``tests/test_elastic.py::test_elastic_remesh_subprocess`` fails on jax
0.9.0 with a ``ShardingTypeError`` at ``models/transformer.py:290``
(``p["embed"][inputs["tokens"]]``): the gather from an embedding sharded
``(V@model, D@data)`` needs an explicit ``out_sharding``. So a sharded
step is held to the port's one-rank step (float32: loss 1e-5 relative,
gradients 1e-4 of their norm, the update within what the gradients'
float32 difference can move Adam's first step), and through it to the
reference's one-device ``make_train_step`` at ``tests/test_torch_train.py``'s
bars. Only the reference's ``shard_map`` programs run sharded here:
``ef_roundtrip`` and ``make_compressed_dp_grads`` on 4 virtual CPU
devices in a subprocess.
"""

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_jobs as J
from repro.models import attention as JA
from repro.models import transformer as JT
from repro_torch.configs import get_smoke_config
from repro_torch.models import params_from_jax
from repro_torch.optim import AdamW, AdamW8bit, global_norm, quantize_blockwise
from repro_torch.train import TrainState, loss_and_grads, make_serve_step, make_train_step
from test_torch_models import _Float32Numpy
from test_torch_train import _embeds, _jax_step, _reference

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen1.5-4b", "dbrx-132b", "zamba2-1.2b"]  # dense + biases, MoE, hybrid
MESHES = [(1, 2), (2, 1), (2, 2), (1, 2, 2)]
# the other families' training: audio (encoder-decoder), ssm (xLSTM,
# replicated over model), vlm (frontend embeddings), and MoE beside a
# dense MLP (arctic)
MORE_ARCHS = ["whisper-small", "xlstm-125m", "pixtral-12b", "arctic-480b"]
MORE_MESHES = [(2, 1), (2, 2)]
STEP_CASES = ([(a, m) for a in ARCHS for m in MESHES]
              + [(a, m) for a in MORE_ARCHS for m in MORE_MESHES])
LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Each check here runs on small tensors beside the spawned ranks: one
    intra-op thread keeps it from oversubscribing the cores that the
    other test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _state(arch):
    _, tree, toks = _reference(arch)
    return params_from_jax(tree, get_smoke_config(arch)), torch.as_tensor(toks).long()


def _batch(arch):
    """The train batch of ``_state``'s tokens, with the frontend stub's
    embeddings where the family reads them."""
    batch = {"tokens": _state(arch)[1]}
    embeds = _embeds(arch)
    if embeds is not None:
        batch["embeds"] = torch.as_tensor(embeds)
    return batch


def _one_rank(arch, trainable=True):
    return J._model(get_smoke_config(arch), _state(arch)[0], trainable)


def _assert_adam_step(new, want_new, g1, g2, lr, what):
    """Adam's first step moves an element by lr * g / (|g| + eps): two
    gradients a float32 noise dg apart give steps at most
    lr * dg eps / (min|g| + eps)^2 apart, or 2 lr where their signs
    differ (``tests/test_torch_train.py``'s bound)."""
    eps = 1e-8
    for k, w in want_new.items():
        a, b = g1[k].double(), g2[k].double()
        drift = (a - b).abs() * eps / (torch.minimum(a.abs(), b.abs()) + eps) ** 2
        bound = 2e-6 + lr * torch.where(a.sign() != b.sign(), torch.full_like(drift, 2.0), drift)
        diff = (new[k] - w).abs().double()
        assert not bool((diff > bound).any()), (what, k, float(diff.max()))


def _assert_grads(got, want, what, rel=1e-4):
    assert set(got) == set(want), what
    for k, w in want.items():
        bar = rel * max(float(w.norm()), 1e-6)
        assert float((got[k] - w).abs().max()) <= bar, (what, k)


# --------------------------------------------------------------------------
# the sharded train step
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def train_run(tmp_path_factory):
    """One float32 step of smoke qwen1.5 (dense, biases), dbrx (MoE,
    experts over the model axis) and zamba2 (hybrid, Mamba replicated)
    on (1, 2), (2, 1), (2, 2) and the 3-D (pod, data, model) (1, 2, 2);
    of smoke whisper, xLSTM, pixtral and arctic on (2, 1) and (2, 2);
    AdamW8bit and a binding clip on (2, 2). 4 ranks."""
    models = {a: (_state(a)[0], _batch(a), [m for b, m in STEP_CASES if b == a])
              for a in ARCHS + MORE_ARCHS}
    args = dict(models=models, meshes=MESHES, lr=LR, opt_mesh=(2, 2), opt_arch="qwen1.5-4b",
                clip_norm=0.05)
    return J.spawn("train", 4, tmp_path_factory.mktemp("train"), args)


@pytest.fixture(scope="module")
def one_rank_steps():
    """The port's one-rank step of each model: loss, gradients, weights."""
    out = {}
    for arch in ARCHS + MORE_ARCHS:
        model = _one_rank(arch)
        params = dict(model.named_parameters())
        loss, metrics, grads = loss_and_grads(model, _batch(arch))
        kept = {k: g.clone() for k, g in grads.items()}
        opt = AdamW(lr=LR)
        _, st = opt.update(grads, opt.init(params), params)
        out[arch] = dict(loss=float(loss), aux=float(metrics["aux"]), grads=kept,
                         new={k: p.detach().clone() for k, p in params.items()},
                         g_used={k: m / 0.1 for k, m in st.mu.items()})
    return out


def _used(res, clip_norm=1.0):
    """The clipped gradients a run's first Adam step used."""
    scale = min(1.0, clip_norm / max(res["norm"], 1e-9))
    return {k: g * scale for k, g in res["grads"].items()}


@pytest.mark.parametrize("arch,mesh", STEP_CASES,
                         ids=[f"{a}-{'x'.join(map(str, m))}" for a, m in STEP_CASES])
def test_sharded_step_equals_one_rank(train_run, one_rank_steps, arch, mesh):
    """The sharded step against the port's one-rank step (see the module
    docstring for why one rank is the oracle)."""
    got, want = train_run[arch, mesh], one_rank_steps[arch]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-5, atol=1e-7)
    _assert_grads(got["grads"], want["grads"], (arch, mesh))
    _assert_adam_step(got["new"], want["new"], _used(got), want["g_used"], LR, (arch, mesh))


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_reference_one_device(train_run, arch, monkeypatch):
    """Through the one-rank step, against the reference's one-device
    ``make_train_step`` (float32 activations on both sides), at
    ``tests/test_torch_train.py``'s bars, on the 3-D mesh (pod, data,
    model) = (1, 2, 2)."""
    monkeypatch.setattr(JT, "jnp", _Float32Numpy())
    monkeypatch.setattr(JA.init_kv_cache, "__defaults__", (jnp.float32,))
    jmodel, tree, toks = _reference(arch)
    cfg = get_smoke_config(arch)
    jstate, jloss = _jax_step(jmodel, tree, toks[None], LR)
    got = train_run[arch, (1, 2, 2)]
    np.testing.assert_allclose(got["loss"], jloss[0], rtol=1e-5)
    # the first moment holds (1 - b1) times the clipped gradient
    jused = {k: m / 0.1 for k, m in params_from_jax(jax.tree.map(np.asarray, jstate.opt.mu),
                                                      cfg).items()}
    _assert_grads(_used(got), jused, arch)
    jnew = params_from_jax(jax.tree.map(np.asarray, jstate.params), cfg)
    _assert_adam_step(got["new"], jnew, _used(got), jused, LR, arch)


def test_binding_clip_equals_one_rank(train_run):
    """A clip that binds (clip_norm 0.05): the global norm over the chunks
    counts a replicated leaf once, so the norm, and the step, are one
    rank's."""
    got = train_run["clip"]
    model = _one_rank("qwen1.5-4b")
    params = dict(model.named_parameters())
    _, _, grads = loss_and_grads(model, {"tokens": _state("qwen1.5-4b")[1]})
    norm = float(global_norm(grads))
    assert norm > 0.05 * 10  # the clip binds
    np.testing.assert_allclose(got["norm"], norm, rtol=1e-6)
    used = {k: g * 0.05 / norm for k, g in grads.items()}
    opt = AdamW(lr=LR, clip_norm=0.05)
    opt.update(grads, opt.init(params), params)
    _assert_adam_step(got["new"], {k: p.detach() for k, p in params.items()},
                      _used(got, 0.05), used, LR, "clip")


def test_adamw8bit_equals_one_rank(train_run):
    """AdamW8bit on (2, 2): the row scales take the maximum over the ranks
    that split a row, so the whole codes and scales are one rank's (a
    code may differ by one where float32 noise rounds across .5)."""
    got = train_run["adamw8bit"]
    model = _one_rank("qwen1.5-4b")
    params = dict(model.named_parameters())
    _, _, grads = loss_and_grads(model, {"tokens": _state("qwen1.5-4b")[1]})
    norm = float(global_norm(grads))
    used = {k: g * min(1.0, 1.0 / norm) for k, g in grads.items()}
    opt = AdamW8bit(lr=LR)
    _, st = opt.update(grads, opt.init(params), params)
    _assert_adam_step(got["new"], {k: p.detach() for k, p in params.items()}, _used(got), used,
                      LR, "adamw8bit")
    for f in ("mu_q", "nu_q"):
        for k, want in getattr(st, f).items():
            diff = (got["opt"][f][k].int() - want.int()).abs()
            assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 1e-3, (f, k)
    for f in ("mu_s", "nu_s"):
        for k, want in getattr(st, f).items():
            # a 1-D leaf has a scale per element: float32 noise of a
            # gradient near 0 moves it relative to itself, not to the leaf
            torch.testing.assert_close(got["opt"][f][k], want, rtol=1e-5,
                                       atol=1e-4 * float(want.abs().max()))


def test_row_scales_of_a_chunk_are_the_whole_tensors():
    """``quantize_blockwise``'s ``row_max`` hook: a chunk split on dim 1
    takes the whole row's maximum (here the two chunks of one tensor)."""
    x = torch.randn(6, 8)
    codes, scale = quantize_blockwise(x)
    halves = x.chunk(2, dim=1)
    whole_max = lambda amax: x.abs().amax(dim=1, keepdim=True)  # noqa: E731
    parts = [quantize_blockwise(h, whole_max) for h in halves]
    assert torch.equal(torch.cat([c for c, _ in parts], dim=1), codes)
    assert all(torch.equal(s, scale) for _, s in parts)


# --------------------------------------------------------------------------
# serving and elastic re-meshing
# --------------------------------------------------------------------------

PROMPT, STEPS = 16, 8


@pytest.fixture(scope="module")
def serve_elastic_run(tmp_path_factory):
    """Smoke qwen1.5 and dbrx served on (1, 2) in float32; smoke qwen1.5
    trained 3 steps on (2, 2), resharded onto (1, 2), 3 more. 4 ranks."""
    serve = {}
    for arch in ("qwen1.5-4b", "dbrx-132b"):
        state, _ = _state(arch)
        toks = np.random.default_rng(31).integers(0, 512, (2, PROMPT))
        serve[arch] = (state, torch.as_tensor(toks))
    state, _ = _state("qwen1.5-4b")
    toks = torch.as_tensor(np.random.default_rng(32).integers(0, 512, (8, 33)))
    args = dict(serve=serve, prompt=PROMPT, steps=STEPS,
                elastic=dict(arch="qwen1.5-4b", state=state, tokens=toks, steps=3, lr=LR))
    return J.spawn("serve_elastic", 4, tmp_path_factory.mktemp("serve"), args), args


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "dbrx-132b"])
def test_serving_on_a_mesh_equals_one_rank(serve_elastic_run, arch):
    """Prefill and 8 greedy decode steps on (1, 2), the KV cache's slots
    split over the model axis: float32 logits within 1e-5 of one rank's,
    and the same greedy tokens."""
    res, args = serve_elastic_run
    got = res["serve"][arch]
    state, toks = args["serve"][arch]
    model = J._model(get_smoke_config(arch), state, trainable=False)
    logits, caches = model.prefill({"tokens": toks}, PROMPT + STEPS)
    assert got["slots"] * 2 == caches["kv"][0]["k"].shape[1]
    step = make_serve_step(model)
    lengths = torch.full((toks.shape[0],), PROMPT, dtype=torch.int32)
    seq, greedy = [logits], []
    for _ in range(STEPS):
        nxt = seq[-1].argmax(-1).to(torch.int32)
        greedy.append(nxt)
        _, logits, caches, lengths = step(caches, nxt, lengths)
        seq.append(logits)
    torch.testing.assert_close(got["logits"], torch.stack(seq), rtol=1e-5, atol=1e-5)
    assert torch.equal(got["tokens"], torch.stack(greedy))


def test_elastic_remesh_equals_one_rank(serve_elastic_run):
    """(2, 2) for 3 steps, ``reshard_state`` onto (1, 2), 3 more steps:
    the loss falls, and the weights and the last loss equal one rank's
    6-step run at the reference test's 2e-3."""
    res, args = serve_elastic_run
    e, got = args["elastic"], res["elastic"]
    assert got["ranks"] == 2
    losses = got["losses"]
    assert len(losses) == 6 and losses[-1] < losses[2] < losses[0]
    model = _one_rank("qwen1.5-4b")
    opt = AdamW(lr=LR)
    params = dict(model.named_parameters())
    state, step = TrainState(params, opt.init(params)), make_train_step(model, opt)
    for _ in range(6):
        state, m = step(state, {"tokens": e["tokens"]})
    np.testing.assert_allclose(losses[-1], float(m["loss"]), rtol=2e-3, atol=2e-3)
    for k, p in state.params.items():
        np.testing.assert_allclose(got["params"][k].numpy(), p.detach().numpy(),
                                   rtol=2e-3, atol=2e-3, err_msg=k)


# --------------------------------------------------------------------------
# int8 error feedback against the reference's shard_map programs
# --------------------------------------------------------------------------

REFERENCE_EF = textwrap.dedent(
    """
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_cpu_multi_thread_eigen=false")
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P

    from repro.launch.mesh import axes_for
    from repro.launch.sharding import param_specs
    from repro.models import attention as JA, build_model, transformer as JT
    from repro.optim.compress import ef_roundtrip
    from repro.train.step import make_compressed_dp_grads


    class F32:  # jax.numpy with bfloat16 read as float32 (float32 activations)
        bfloat16 = jnp.float32

        def __getattr__(self, name):
            return getattr(jnp, name)


    JT.jnp = F32()
    JA.init_kv_cache.__defaults__ = (jnp.float32,)
    with open(sys.argv[1], "rb") as f:
        a = pickle.load(f)
    mesh = jax.make_mesh((4,), ("data",))
    f = jax.shard_map(lambda g, e: tuple(x[None] for x in ef_roundtrip(g[0], e[0], "data")),
                      mesh=mesh, in_specs=(P("data"), P("data")),
                      out_specs=(P("data"), P("data")))
    mean, err = jax.jit(f)(jnp.asarray(a["g"]), jnp.asarray(a["err"]))
    model = build_model(a["cfg"])
    params = jax.tree.map(jnp.asarray, a["tree"])
    mesh2 = jax.make_mesh((4, 1), ("data", "model"))
    specs = param_specs(params, a["cfg"], axes_for(mesh2), mesh2)
    fn = make_compressed_dp_grads(model, mesh2, ("data",), specs)
    zero = jax.tree.map(jnp.zeros_like, params)
    grads, new_err, loss = jax.jit(fn)(params, {"tokens": jnp.asarray(a["tokens"])}, zero)
    out = dict(mean=np.asarray(mean), err=np.asarray(err), loss=float(loss),
               grads=jax.tree.map(np.asarray, grads), grad_err=jax.tree.map(np.asarray, new_err))
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
    print("REFERENCE_OK")
    """
)


@pytest.fixture(scope="module")
def ef_runs(tmp_path_factory):
    """The same numpy inputs through the port's 4 ranks and through the
    reference's ``shard_map`` programs on 4 virtual CPU devices."""
    tmp = tmp_path_factory.mktemp("ef")
    rng = np.random.default_rng(41)
    g = (rng.normal(size=(4, 4096)) * rng.uniform(0.5, 2.0, (4, 1))).astype(np.float32)
    err = (rng.normal(size=(4, 4096)) * 1e-3).astype(np.float32)
    jmodel, tree, _ = _reference("qwen1.5-4b")
    toks = np.random.default_rng(42).integers(0, 512, (4, 33)).astype(np.int32)
    cfg = get_smoke_config("qwen1.5-4b")
    state = params_from_jax(tree, cfg)
    port = J.spawn("ef", 4, tmp, dict(g=g, err=err, arch="qwen1.5-4b", state=state,
                                      tokens=torch.as_tensor(toks).long()))
    port["g0"] = g[0] + err[0]
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(dict(g=g, err=err, tree=tree, tokens=toks, cfg=jmodel.cfg), f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REFERENCE_EF, str(tmp / "in.pkl"),
                          str(tmp / "out.pkl")], env=env, capture_output=True, text=True,
                         timeout=120)
    assert "REFERENCE_OK" in out.stdout, out.stderr[-3000:]
    with open(tmp / "out.pkl", "rb") as f:
        ref = pickle.load(f)
    return port, ref


def test_ef_roundtrip_matches_reference(ef_runs):
    """``ef_roundtrip`` on 4 ranks against the reference's under
    ``jax.shard_map`` on 4 devices, from the same numpy inputs. The mean
    (the int32 sum of the codes, times the largest scale, over 4) is
    bit-equal, so the sums and the scales are: both frameworks divide by
    the scale in float32 and round half to even. Rank 0's new error,
    ``g + err - q * scale``, is within one float32 rounding of the
    product (far inside one int8 step): XLA fuses the product into the
    subtraction, torch rounds it first."""
    port, ref = ef_runs
    np.testing.assert_array_equal(port["mean"].numpy(), ref["mean"][0])
    g32 = port["g0"]
    bar = float(np.abs(g32).max()) * 2.0**-23
    np.testing.assert_allclose(port["new_err"].numpy(), ref["err"][0], rtol=0, atol=bar)


def test_compressed_dp_grads_match_reference(ef_runs):
    """``make_compressed_dp_grads`` on (4, 1) against the reference's under
    ``jax.jit`` on 4 virtual devices, the weights carried across by
    ``params_from_jax``, float32 activations: each gradient element
    within one int8 step (the largest rank's scale: a code of one rank
    may round the other way where float32 noise moves its input across
    .5), the loss at 1e-5. A stacked leaf of the reference (every layer's
    ``w_down``) has one scale, so the port compresses its layers
    together: ``scales`` holds each rank's largest scale over them."""
    port, ref = ef_runs
    cfg = get_smoke_config("qwen1.5-4b")
    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=1e-5)
    want = params_from_jax(ref["grads"], cfg)
    want_err = params_from_jax(ref["grad_err"], cfg)
    assert set(want) == set(port["grads"])
    for k, w in want.items():
        step = float(port["scales"][k])
        assert float((port["grads"][k] - w).abs().max()) <= step * (1 + 1e-5), k
        assert float((port["grad_err"][k] - want_err[k]).abs().max()) <= step * (1 + 1e-5), k
