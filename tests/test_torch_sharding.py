"""The port's sharding rules and tensor-parallel planner against the JAX
package's, on the CPU, with no devices.

``param_specs``, ``fsdp_gather_specs``, ``input_structs`` and
``cache_specs`` read only ``mesh.shape[axis]`` and ``mesh.axis_names``,
so duck-typed meshes give the production 16x16 and 2x16x16 layouts here.
Every arch config at its published widths, ``tp`` = the mesh's model
axis: the port's shapes from a tree built on ``device="meta"``, the
reference's from ``init_shapes()`` (``jax.eval_shape``). The depth is
cut to the fewest layers that keep each family's block pattern (no rule
reads the depth; tracing the reference's whole init would take minutes). The reference
stacks ``blocks`` and ``enc_blocks`` (and the KV and Mamba caches) with a
leading layer dim and prefixes its spec with ``None``; the port keeps one
entry per layer, whose spec must be the reference's with that ``None``
dropped. The reference's ``fsdp_gather_specs`` wraps each spec in a
``NamedSharding``, which needs a real mesh: the test reads the spec
through a stand-in for ``NamedSharding`` (only in this test's patch).
"""

import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, SHAPES, get_config
from repro.launch import mesh as jmesh
from repro.launch import sharding as jsharding
from repro.models import build_model as jax_build_model
from repro.models.plan import make_plan as jax_make_plan
from repro.models.plan import plan_attention as jax_plan_attention
from repro_torch.configs import get_config as port_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsharding
from repro_torch.models import build_model, make_plan, params_from_jax, plan_attention
from repro_torch.models import transformer as TT
from repro_torch.models.config import reduced
from test_torch_models import reference_in_float32  # noqa: F401 (fixture)

MESHES = {
    "16x16": ({"data": 16, "model": 16}, ("data", "model")),
    "2x16x16": ({"pod": 2, "data": 16, "model": 16}, ("pod", "data", "model")),
    "2x2": ({"data": 2, "model": 2}, ("data", "model")),
    "4x1": ({"data": 4, "model": 1}, ("data", "model")),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors only: one intra-op thread keeps these checks from
    oversubscribing the cores that the other test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(name):
    shape, axes = MESHES[name]
    return SimpleNamespace(shape=shape, axis_names=axes)


def _path(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _flat(tree, is_leaf=None) -> dict:
    return {_path(p): v for p, v in jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=is_leaf)[0]}


def _is_spec(x):
    return isinstance(x, jax.sharding.PartitionSpec)


def _cut(cfg):
    """``cfg`` at its widths with the fewest layers that keep its pattern:
    two segments of zamba2's shared attention, an sLSTM among xLSTM's
    mLSTM blocks, two encoder layers."""
    layers = max(2, 2 * cfg.attn_every, cfg.slstm_every + 1 if cfg.slstm_every else 0)
    return dataclasses.replace(cfg, n_layers=min(cfg.n_layers, layers),
                               encoder_layers=min(cfg.encoder_layers, 2))


@functools.lru_cache(maxsize=None)
def _configs(arch):
    return _cut(get_config(arch)), _cut(port_config(arch))


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch, tp):
    cfg = _configs(arch)[0]
    return cfg, jax_build_model(cfg, jax_make_plan(cfg, tp=tp)).init_shapes()


@functools.lru_cache(maxsize=None)
def _port_shapes(arch, tp):
    cfg = _configs(arch)[1]
    return TT.init_model_params(torch.Generator(), cfg, make_plan(cfg, tp=tp), "meta")


def _port_names(tree) -> dict:
    return tsharding._named(tree)


def _to_ref(name: str) -> tuple[str, bool]:
    """(reference path, stacked) of a port parameter or cache leaf name."""
    parts = name.split(".")
    if parts[0] in ("blocks", "enc_blocks", "kv", "shared_kv", "mamba"):
        return "/".join(parts[:1] + parts[2:]), True
    return "/".join(parts), False


def _same(port_specs: dict, ref_flat: dict, what: str) -> int:
    """Every port leaf's spec equals the reference's (its leading ``None``
    dropped for a stacked leaf); every reference leaf is reached."""
    seen = set()
    for name, spec in port_specs.items():
        ref_path, stacked = _to_ref(name)
        want = tuple(ref_flat[ref_path])
        if stacked:
            assert want[0] is None, (what, name, want)
            want = want[1:]
        assert tuple(spec) == want, (what, name, spec, want)
        seen.add(ref_path)
    assert seen == set(ref_flat), (what, set(ref_flat) - seen)
    return len(port_specs)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, mesh_name):
    mesh = _mesh(mesh_name)
    tp = mesh.shape["model"]
    cfg, ref_shapes = _ref_shapes(arch, tp)
    ref = jsharding.param_specs(ref_shapes, cfg, jmesh.axes_for(mesh), mesh)
    port_tree = _port_shapes(arch, tp)
    got = tsharding.param_specs(port_tree, _configs(arch)[1], tmesh.axes_for(mesh), mesh)
    n = _same(got, _flat(ref, _is_spec), f"{arch} {mesh_name}")
    # the port's leaves have the reference's per-layer shapes
    ref_leaf = _flat(ref_shapes)
    for name, t in _port_names(port_tree).items():
        ref_path, stacked = _to_ref(name)
        assert tuple(t.shape) == tuple(ref_leaf[ref_path].shape)[int(stacked):], name
    assert n == len(_port_names(port_tree))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_fsdp_gather_specs_match_reference(arch, mesh_name, monkeypatch):
    monkeypatch.setattr(jsharding, "NamedSharding", lambda mesh, spec: spec)
    mesh = _mesh(mesh_name)
    tp = mesh.shape["model"]
    cfg, ref_shapes = _ref_shapes(arch, tp)
    ref = jsharding.fsdp_gather_specs(ref_shapes, cfg, jmesh.axes_for(mesh), mesh)
    got = tsharding.fsdp_gather_specs(_port_shapes(arch, tp), _configs(arch)[1],
                                      tmesh.axes_for(mesh), mesh)
    assert tuple(got.pop("__act__")) == tuple(ref.pop("__act__"))
    flat = {}
    for group, tree in ref.items():
        for path, spec in _flat(tree, _is_spec).items():
            flat[f"{group}/{path}"] = spec
    seen = set()
    for name, spec in got.items():
        parts = name.split(".")
        key = "/".join(parts[:1] + parts[2:]) if parts[0] in ("blocks", "enc_blocks") else \
            "/".join(parts)
        assert tuple(spec) == tuple(flat[key]), (name, spec, flat[key])
        seen.add(key)
    assert seen == set(flat)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_structs_match_reference(arch, mesh_name):
    mesh = _mesh(mesh_name)
    cfg, pcfg = get_config(arch), port_config(arch)
    for shape in SHAPES.values():
        rs, rspecs = jsharding.input_structs(cfg, shape, jmesh.axes_for(mesh), mesh)
        ps, pspecs = tsharding.input_structs(pcfg, shape, tmesh.axes_for(mesh), mesh)
        assert set(ps) == set(rs) and set(pspecs) == set(rspecs), shape.name
        for k in rs:
            assert tuple(ps[k].shape) == tuple(rs[k].shape), (shape.name, k)
            assert str(ps[k].dtype).removeprefix("torch.") == str(rs[k].dtype), (shape.name, k)
            assert ps[k].device.type == "meta"
            assert tuple(pspecs[k]) == tuple(rspecs[k]), (shape.name, k)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_reference(arch, mesh_name):
    """Every shape of ``configs.SHAPES`` (train, prefill, decode and the
    long-context decode of batch 1, whose cache sequence the data axes
    shard), its global batch and its sequence as the cache's length."""
    mesh = _mesh(mesh_name)
    tp = mesh.shape["model"]
    cfg, pcfg = _configs(arch)
    jmodel = jax_build_model(cfg, jax_make_plan(cfg, tp=tp))
    for shape in SHAPES.values():
        b, s = shape.global_batch, shape.seq_len
        ref_caches = jax.eval_shape(lambda: jmodel.init_caches(b, s))  # noqa: B023
        ref = jsharding.cache_specs(ref_caches, cfg, jmesh.axes_for(mesh), mesh, batch=b)
        port_caches = TT.init_caches(pcfg, b, s, make_plan(pcfg, tp=tp), "meta")
        got = tsharding.cache_specs(port_caches, pcfg, tmesh.axes_for(mesh), mesh, batch=b)
        _same(_cache_leaves(got), _flat(ref, _is_spec), f"{arch} {mesh_name} {shape.name}")
        ref_leaf = _flat(ref_caches)
        for name, t in _cache_leaves(port_caches).items():
            ref_path, stacked = _to_ref(name)
            assert tuple(t.shape) == tuple(ref_leaf[ref_path].shape)[int(stacked):], name


def _cache_leaves(tree) -> dict:
    """``{dotted name: leaf}`` of caches (a spec tuple counts as a leaf)."""
    out = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{k}.", v)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(f"{prefix}{i}.", v)
        else:
            out[prefix[:-1]] = node

    walk("", tree)
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_mesh_axes_match_reference(mesh_name):
    mesh = _mesh(mesh_name)
    got, want = tmesh.axes_for(mesh), jmesh.axes_for(mesh)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.data_size(mesh) == want.data_size(mesh)
    assert got.model_size(mesh) == want.model_size(mesh)


def test_to_placements_and_batch_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _mesh("2x16x16")
    assert tsharding.to_placements((("pod", "data"), "model", None), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert tsharding.to_placements((None, "model"), mesh) == (Replicate(), Replicate(), Shard(1))
    assert tsharding.to_placements((), mesh) == (Replicate(),) * 3
    cfg = port_config("qwen1.5-4b")
    jcfg = get_config("qwen1.5-4b")
    for dp in ((), ("data",), ("pod", "data")):
        want = jax_make_plan(jcfg, tp=2, dp_axes=dp).batch_spec()
        assert make_plan(cfg, tp=2, dp_axes=dp).batch_spec() == tuple(want)


# --------------------------------------------------------------------------
# the tensor-parallel planner and the padded model
# --------------------------------------------------------------------------


@pytest.mark.parametrize("tp", [1, 2, 4, 8, 16])
def test_attention_plan_properties(tp):
    """``tests/test_models.py``'s properties on a grid of (kv heads,
    group) for the port's planner, and each plan equal to the reference's."""
    base = port_config("yi-34b")
    jbase = get_config("yi-34b")
    for hkv in (1, 2, 3, 4, 5, 7, 8, 12, 16, 24, 33, 48, 64):
        for group in range(1, 9):
            kw = dict(n_heads=hkv * group, n_kv_heads=hkv, head_dim=32,
                      d_model=max(256, hkv * group * 32))
            cfg = reduced(base, **kw)
            plan = plan_attention(cfg, tp)
            assert dataclasses.asdict(plan) == dataclasses.asdict(
                jax_plan_attention(reduced(jbase, **kw), tp))
            assert plan.slots % tp == 0
            assert plan.head_mask().sum() == cfg.n_heads
            qm = plan.q_map()
            assert len({(s, p) for s, p in qm}) == cfg.n_heads
            assert (qm[:, 0] < plan.slots).all() and (qm[:, 1] < plan.g_eff).all()
            kvm = plan.kv_map()
            for i, (s, _) in enumerate(qm):
                assert kvm[s] == i // group
            assert plan.q_eff <= max(2 * cfg.n_heads, tp * plan.g_eff)


def _gqa_cfg():
    return reduced(port_config("yi-34b"), n_heads=8, n_kv_heads=2, head_dim=32, d_model=256)


@pytest.mark.parametrize("tp", [2, 4, 8, 16])
def test_padded_attention_equals_exact_gqa(tp):
    """TP head padding is invisible: the same seed at ``tp`` (padded or
    replicated slots, ``head_mask``) and at tp=1 gives the same logits,
    in float32 (the reference's test holds bfloat16 at 3e-2)."""
    cfg = _gqa_cfg()
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 32)))
    out = {}
    for t in (1, tp):
        model = build_model(cfg, make_plan(cfg, tp=t), device="cpu", seed=3).float()
        out[t] = model.train_forward({"tokens": toks})[0]
    assert model.plan.attention.slots % tp == 0
    torch.testing.assert_close(out[tp], out[1], rtol=1e-5, atol=1e-5)


def test_tp4_model_matches_reference_tp4(reference_in_float32):  # noqa: F811
    """The port's model built with ``make_plan(cfg, tp=4)`` (replicated kv
    slots, rep 2, g_eff 2) against the reference's at tp=4, the padded
    tree carried across by ``params_from_jax``: float32 logits."""
    jcfg = reduced(get_config("yi-34b"), n_heads=8, n_kv_heads=2, head_dim=32, d_model=256)
    jmodel = jax_build_model(jcfg, jax_make_plan(jcfg, tp=4))
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(3)))
    cfg = _gqa_cfg()
    model = build_model(cfg, make_plan(cfg, tp=4), device="cpu", seed=0).float()
    assert tuple(model["blocks"][0]["attn"]["wq"].shape) == tree["blocks"]["attn"]["wq"].shape[1:]
    model.load_state_dict(params_from_jax(tree, cfg))
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    want, _ = jax.jit(jmodel.train_forward)(jax.tree.map(jnp.asarray, tree),
                                            {"tokens": jnp.asarray(toks)})
    got, _ = model.train_forward({"tokens": torch.as_tensor(toks).long()})
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_adamw8bit_on_a_model_tree_matches_reference():
    """AdamW8bit on smoke qwen1.5's parameters, two updates with seeded
    gradients, against the reference's on its stacked tree: the
    reference's ``blocks`` leaves hold every layer, so its row scales are
    one per layer, and the port's per-layer parameters take one scale
    each. Weights at the optimizer tests' 1e-6; codes within one (a
    rounding across .5), scales at 1e-6 relative (plus 1e-6 of the
    leaf's largest scale)."""
    from repro.optim import AdamW8bit as JaxAdamW8bit
    from repro_torch.configs import get_smoke_config
    from repro_torch.optim import AdamW8bit

    jcfg = get_config("qwen1.5-4b")
    jcfg = reduced(jcfg)
    tree = jax.tree.map(np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
    cfg = get_smoke_config("qwen1.5-4b")
    rng = np.random.default_rng(5)
    grads = [jax.tree.map(lambda a: rng.normal(0, 1, a.shape).astype(np.float32), tree)
             for _ in range(2)]
    jopt, topt = JaxAdamW8bit(lr=1e-2), AdamW8bit(lr=1e-2)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_jax(tree, cfg)
    js, ts = jopt.init(jp), topt.init(tp)
    jupdate = jax.jit(jopt.update)
    for g in grads:
        jp, js = jupdate(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = topt.update(params_from_jax(g, cfg), ts, tp)
    for k, w in params_from_jax(jax.tree.map(np.asarray, jp), cfg).items():
        np.testing.assert_allclose(tp[k].numpy(), w.numpy(), rtol=1e-6, atol=1e-6, err_msg=k)
    for f in ("mu", "nu"):
        codes = params_from_jax(jax.tree.map(np.asarray, getattr(js, f + "_q")), cfg)
        scales = params_from_jax(jax.tree.map(np.asarray, getattr(js, f + "_s")), cfg)
        for k in codes:
            assert int((getattr(ts, f + "_q")[k].int() - codes[k].int()).abs().max()) <= 1, k
            got = getattr(ts, f + "_s")[k]
            assert got.shape == scales[k].shape, (k, got.shape, scales[k].shape)
            # a 1-D leaf has a scale per element: one near 0 (a first
            # moment that cancels) carries float32 noise relative to itself
            torch.testing.assert_close(got, scales[k], rtol=1e-6,
                                       atol=1e-6 * float(scales[k].max()), msg=k)
