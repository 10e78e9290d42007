"""Sharding rules: a spec per parameter, input and cache (the port of
``repro/launch/sharding.py``).

The reference's rule engine, with its paths and divisibility guards: a
dim is sharded only where the mesh axis divides it. A spec is a plain
tuple with one entry per dim, each an axis name, a tuple of names (the
data axes of a multi-pod mesh, outermost first) or ``None``; the
reference's ``PartitionSpec`` entries, without JAX. Parameters shard
over ``model`` (tensor and expert parallelism) and over the data axes
(FSDP), so the optimizer's moments, which reuse these specs, are
ZeRO-sharded.

The port splits the reference's layer-stacked groups into one entry per
layer (``blocks.3.attn.wq``; ``convert.params_from_jax``): where the
reference's spec for the stack is ``(None, *inner)``, the port's spec for
each layer is ``inner``. xLSTM's ``xl_blocks`` are a list in both
packages, so their paths keep the layer index. Caches likewise
(``kv.3.k``, ``mamba.3.ssm``).

:func:`tp_split_dim` reads the same rules for the dim that a layer
splits over ``model`` when it computes (``launch/spmd.py``).
:func:`to_placements` maps a spec onto a ``DeviceMesh``'s DTensor
placements (``Shard(dim)`` / ``Replicate()`` per mesh dim); the port's
sharded step (:mod:`.spmd`) slices and gathers the same chunks itself.
"""

from __future__ import annotations

from typing import Any

import torch

from ..configs import ShapeSpec
from ..models.config import ArchConfig
from ..models.convert import stacked_in_reference
from .mesh import MeshAxes

__all__ = ["param_specs", "input_structs", "cache_specs", "fsdp_gather_specs",
           "to_placements", "leaf_spec", "tp_split_dim", "batch_entry", "reference_path"]

Spec = tuple


def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def leaf_spec(path: str, shape: tuple[int, ...], cfg: ArchConfig,
              ax: MeshAxes, dsz: int, msz: int) -> Spec:
    """Spec for an unstacked leaf (no leading layer dim); ``path`` is the
    reference's ``/``-joined pytree path."""
    if len(shape) == 0 or max(shape) < 128:
        return ()
    return _rule(path, shape, ax, dsz, msz)


def tp_split_dim(path: str, shape: tuple[int, ...], tp: int) -> int | None:
    """The dim of a leaf that its layer splits over ``model`` (None: the
    layer reads it whole): the dim the rules shard over ``model``, at any
    size, except in the MoE router, which top-k reads whole, and xLSTM's
    cells, which run replicated; and ``head_mask``, which is split with
    the attention's slots."""
    if tp == 1 or path.endswith("moe/router") or "/cell/" in path:
        return None
    if path.endswith("attn/head_mask"):
        return 0
    spec = _rule(path, shape, MeshAxes(data=("data",), model="model"), 1, tp)
    return spec.index("model") if "model" in spec else None


def _rule(path: str, shape: tuple[int, ...], ax: MeshAxes, dsz: int, msz: int) -> Spec:
    """The reference's rules by path, without its size guard."""
    nd = len(shape)
    data = ax.data if len(ax.data) > 1 else ax.data[0]

    def dspec(i):  # shard dim i over data axes if divisible
        return data if _div(shape[i], dsz) else None

    def mspec(i):
        return ax.model if _div(shape[i], msz) else None

    if "embed" in path and nd == 2:                 # (V, D)
        return (mspec(0), dspec(1))
    if path.endswith("head") and nd == 2:           # (D, V)
        return (dspec(0), mspec(1))
    if "attn/" in path or "xattn/" in path:
        if path.endswith("wq") and nd == 4:         # (D, slots, g, hd)
            return (dspec(0), mspec(1), None, None)
        if path.endswith(("wk", "wv")) and nd == 3:  # (D, slots, hd)
            return (dspec(0), mspec(1), None)
        if path.endswith("wo") and nd == 4:         # (slots, g, hd, D)
            return (mspec(0), None, None, dspec(3))
        if path.endswith("bq") and nd == 3:
            return (mspec(0), None, None)
        if path.endswith(("bk", "bv")) and nd == 2:
            return (mspec(0), None)
        return ()                                   # head_mask etc.
    if "moe/" in path:
        if path.endswith("router") and nd == 2:     # (D, E)
            return (dspec(0), mspec(1))
        if nd == 3 and path.endswith(("w_up", "w_gate")):  # (E, D, F)
            return (mspec(0), dspec(1), None)
        if nd == 3 and path.endswith("w_down"):     # (E, F, D)
            return (mspec(0), None, dspec(2))
        return ()
    if path.endswith(("w_up", "w_gate")) and nd == 2:   # (D, F)
        return (dspec(0), mspec(1))
    if path.endswith("w_down") and nd == 2:             # (F, D)
        return (mspec(0), dspec(1))
    if "mamba/" in path:
        if path.endswith("in_proj"):                # (D, d_in_proj)
            return (dspec(0), None)
        if path.endswith("out_proj"):               # (d_inner, D)
            return (None, dspec(1))
        return ()
    if "cell/" in path:                             # xlstm cells
        if nd >= 2 and _div(shape[0], dsz) and shape[0] >= 256:
            return (data, *([None] * (nd - 1)))
        return ()
    if nd == 2 and _div(shape[0], dsz) and shape[0] >= 1024:
        return (data, None)                         # generic large matrix
    return ()


def reference_path(name: str) -> str:
    """The reference's pytree path of the port's parameter ``name``: the
    layer index of a stacked group dropped (``blocks.3.attn.wq`` ->
    ``blocks/attn/wq``); xLSTM's listed blocks keep theirs."""
    parts = name.split(".")
    if stacked_in_reference(name):
        parts = parts[:1] + parts[2:]
    return "/".join(parts)


def _named(tree) -> dict[str, Any]:
    """``{dotted name: leaf}`` of a state dict or nested dicts and lists."""
    if hasattr(tree, "named_parameters"):
        return dict(tree.named_parameters())
    out: dict[str, Any] = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{k}.", v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}{i}.", v)
        else:
            out[prefix[:-1]] = node

    walk("", tree)
    return out


def param_specs(params, cfg: ArchConfig, ax: MeshAxes, mesh) -> dict[str, Spec]:
    """``{name: spec}`` for every parameter of ``params`` (a model, its
    state dict, or nested dicts of tensors; only the shapes are read, so
    a model built on ``device="meta"`` serves)."""
    dsz = ax.data_size(mesh)
    msz = ax.model_size(mesh)
    return {name: leaf_spec(reference_path(name), tuple(t.shape), cfg, ax, dsz, msz)
            for name, t in _named(params).items()}


# --------------------------------------------------------------------------
# Inputs (meta tensors + specs) per (arch, shape)
# --------------------------------------------------------------------------


def batch_entry(batch: int, ax: MeshAxes, mesh):
    """The batch dim's spec entry: the data axes where they divide it."""
    data = ax.data if len(ax.data) > 1 else ax.data[0]
    return data if _div(batch, ax.data_size(mesh)) else None


def input_structs(cfg: ArchConfig, shape: ShapeSpec, ax: MeshAxes, mesh):
    """-> (inputs: {name: meta tensor of the global shape and dtype},
    their specs)."""
    b, s = shape.global_batch, shape.seq_len
    bspec = batch_entry(b, ax, mesh)

    def struct(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    structs: dict[str, Any] = {}
    specs: dict[str, Spec] = {}
    if shape.kind in ("train", "prefill"):
        tok = struct((b, s), torch.int32)
        if cfg.family == "audio":
            structs["tokens"] = tok
            specs["tokens"] = (bspec, None)
            structs["embeds"] = struct((b, cfg.encoder_frames, cfg.d_model), torch.float32)
            specs["embeds"] = (bspec, None, None)
        elif cfg.frontend == "vision_stub":
            structs["embeds"] = struct((b, s, cfg.d_model), torch.float32)
            specs["embeds"] = (bspec, None, None)
            if shape.kind == "prefill":
                structs["tokens"] = tok
                specs["tokens"] = (bspec, None)
        else:
            structs["tokens"] = tok
            specs["tokens"] = (bspec, None)
    else:  # decode shapes: one new token + lengths
        structs["tokens"] = struct((b,), torch.int32)
        specs["tokens"] = (bspec,)
        structs["lengths"] = struct((b,), torch.int32)
        specs["lengths"] = (bspec,)
    return structs, specs


def _cache_rule(pstr: str, shape: tuple[int, ...], ax: MeshAxes, dsz: int, msz: int,
                long_ctx: bool) -> Spec:
    """The reference's rule for one cache leaf at its reference path and
    (stacked) shape."""
    data = ax.data if len(ax.data) > 1 else ax.data[0]
    if pstr.startswith(("kv", "shared_kv")) and len(shape) == 5:
        # (L, B, slots, Smax, hd)
        mdim = ax.model if _div(shape[2], msz) else None
        if long_ctx:
            sdim = data if _div(shape[3], dsz) else None
            return (None, None, mdim, sdim, None)
        return (None, data, mdim, None, None)
    if pstr.startswith("enc") and len(shape) == 3:  # whisper enc out
        return (data if not long_ctx else None, None, None)
    if pstr.startswith("mamba"):
        bdim = None if long_ctx else (data if _div(shape[1], dsz) else None)
        if pstr.endswith("ssm") and len(shape) == 5:   # (L,B,H,P,N)
            mdim = ax.model if _div(shape[2], msz) else None
            return (None, bdim, mdim, None, None)
        if len(shape) >= 2:
            return (None, bdim, *([None] * (len(shape) - 2)))
    if pstr.startswith("xl"):
        bdim = None if long_ctx else (
            data if len(shape) >= 1 and _div(shape[0], dsz) else None)
        return (bdim, *([None] * (len(shape) - 1)))
    return (None,) * len(shape)


_STACKED_CACHES = ("kv", "shared_kv", "mamba")  # per layer in the port, stacked in the reference


def cache_specs(caches, cfg: ArchConfig, ax: MeshAxes, mesh, *, batch: int):
    """Specs for decode caches, in the caches' own structure.

    KV caches (B, slots, Smax, hd) per layer: batch over data when
    divisible, slots over model; for a batch the data axes do not divide
    (batch 1, long context), the cache *sequence* dim shards over data
    (sequence parallelism) instead."""
    dsz = ax.data_size(mesh)
    msz = ax.model_size(mesh)
    long_ctx = not _div(batch, dsz)

    def rule(name: str, leaf) -> Spec:
        parts = name.split(".")
        shape = tuple(leaf.shape)
        if parts[0] in _STACKED_CACHES:
            ref = "/".join(parts[:1] + parts[2:])
            return _cache_rule(ref, (1, *shape), ax, dsz, msz, long_ctx)[1:]
        return _cache_rule("/".join(parts), shape, ax, dsz, msz, long_ctx)

    def walk(prefix, node):
        if isinstance(node, dict):
            return {k: walk(f"{prefix}{k}.", v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(f"{prefix}{i}.", v) for i, v in enumerate(node)]
        return rule(prefix[:-1], node)

    return walk("", caches)


def _strip(spec: Spec, data_names: set[str]) -> Spec:
    parts = []
    for part in spec:
        if part is None:
            parts.append(None)
        elif isinstance(part, (tuple, list)):
            kept = tuple(a for a in part if a not in data_names)
            parts.append(kept if kept else None)
        else:
            parts.append(None if part in data_names else part)
    return tuple(parts)


def fsdp_gather_specs(params, cfg: ArchConfig, ax: MeshAxes, mesh) -> dict[str, Spec]:
    """Per-layer *gathered* specs for the FSDP schedule: the storage specs
    of every block parameter (``blocks``, ``enc_blocks``, ``shared``,
    ``xl_blocks``) with the data axes stripped and the model axis kept,
    keyed by the parameter's name, and ``"__act__"``, the residual
    stream's spec (batch over the data axes)."""
    full = param_specs(params, cfg, ax, mesh)
    data_names = set(ax.data)
    groups = ("blocks", "enc_blocks", "shared", "xl_blocks")
    out = {name: _strip(spec, data_names) for name, spec in full.items()
           if name.split(".")[0] in groups}
    data = ax.data if len(ax.data) > 1 else ax.data[0]
    out["__act__"] = (data, None, None)
    return out


def to_placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh axis,
    ``Shard(dim)`` for the dim that axis splits, else ``Replicate()``.
    A dim split over several axes (the data axes of a multi-pod mesh) is
    split over the outer axis first, as the reference's tuple entry."""
    from torch.distributed.tensor import Replicate, Shard

    owner: dict[str, int] = {}
    for dim, part in enumerate(spec):
        for a in (part if isinstance(part, (tuple, list)) else (part,)):
            if a is not None:
                owner[a] = dim
    return tuple(Shard(owner[a]) if a in owner else Replicate() for a in mesh.axis_names)
