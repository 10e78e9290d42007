"""The sharded step made explicit: what GSPMD does for the reference.

The reference gives each array a ``PartitionSpec`` and lets GSPMD place
the collectives. PyTorch has no GSPMD, so this module puts them where
GSPMD does, on a :class:`~.mesh.Mesh`:

* **Storage.** :func:`distribute` keeps, on each rank, its chunk of
  every parameter as laid out by :func:`.sharding.param_specs` (FSDP over
  the data axes, tensor and expert parallelism over ``model``); the
  optimizer's moments take the same chunks.
* **A per-layer gather** (the reference's ``fsdp_gather`` /
  ``_gather_leaf``). A layer reads its parameters through a
  :class:`ShardView` of its ``Params``: a leaf is cast to the activation
  type where the layer would cast it anyway, then all-gathered over the
  data axes (its gradient reduce-scattered back: the reference's
  ``grad_shardings``), and brought to the layout the layer computes in:
  split over ``model`` where the layer splits it (attention slots, MLP
  columns, experts), whole where it runs replicated (the MoE router,
  Mamba2, xLSTM, norms). The view is made inside the rematerialised
  layer, so the backward pass gathers again. A leaf that is not sharded
  over the data axes has its gradient all-reduced over them.
* **Collectives in the layers** (``layers.tp_enter`` / ``tp_exit``):
  where a tensor-parallel layer starts, identity forward and an
  all-reduce of the gradient; after ``wo``, ``w_down`` and the expert
  combine, an all-reduce forward with identity as its backward.
* **Vocab-parallel embedding, head and loss.** Each rank holds a block
  of vocabulary rows; the embedding masks the ids outside it and
  all-reduces, the head leaves the logits split over the vocabulary,
  and the loss takes a vocab-parallel log-softmax. Serving gathers the
  last position's logits.
* **MoE routing over the data axes.** Capacity, ranks within each
  expert and the balance loss are those of the whole batch: each rank
  offsets its ranks by the counts of the ranks before it.
* **Serving layouts** (:meth:`Spmd.serve_layout`, :meth:`Spmd.init_caches`,
  :meth:`Spmd.shard_caches`, by :func:`.sharding.cache_specs`), derived
  from the global batch and the caches' length at each prefill and
  decode step, and in force only for that call. A batch the data axes divide is
  split over them (each rank serves its rows). A batch they do not
  divide (batch 1, long context) is served whole by every rank, and the
  KV caches' *sequence* is split over the data axes instead: each rank
  holds ``Smax / dp`` positions, writes the new K/V row only where its
  chunk holds it, attends over its chunk with the decode kernel's
  log-sum-exp, and the ranks' partial results merge
  (:func:`merge_partials`: one all-reduce of the max of the
  log-sum-exps, one of the weighted outputs and weights). The Mamba2 and
  xLSTM states are replicated over the data axes there, as the
  reference's rule has them. The cache is never gathered to one rank.

The train step takes the global batch and uses its rank's rows (the
data axes split the batch; the loss and metrics are averaged over
them); so does the prefill, which returns the rank's rows of the logits
and its chunk of the caches; a decode step takes and returns the rank's
rows, under the layout its caches were made in. Weights: every rank
builds the whole model from the same seed (or state dict) and keeps its
chunk, so the sharded model computes what one rank computes.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.convert import stacked_in_reference
from ..models.layers import BF16_WEIGHTS
from .mesh import Comm, Mesh, axes_for
from .sharding import cache_specs, param_specs, reference_path, tp_split_dim

__all__ = ["distribute", "Spmd", "ShardView", "TensorParallel", "SequenceSplit", "ServeLayout",
           "shard_of", "gather_whole", "split_counts", "merge_partials"]


# --------------------------------------------------------------------------
# Differentiable collectives
# --------------------------------------------------------------------------


class _CopyIn(torch.autograd.Function):
    """Identity; the backward all-reduces the gradient."""

    @staticmethod
    def forward(ctx, x, comm: Comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g), None


class _ReduceOut(torch.autograd.Function):
    """All-reduce (sum); identity backward: every rank computes the same
    downstream, so each rank's gradient is already the whole one."""

    @staticmethod
    def forward(ctx, x, comm: Comm):
        return comm.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumAll(torch.autograd.Function):
    """All-reduce (sum) whose consumers differ per rank (the data axes):
    the backward all-reduces too."""

    @staticmethod
    def forward(ctx, x, comm: Comm):
        ctx.comm = comm
        return comm.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g), None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``. Backward: reduce-scatter when the ranks'
    consumers differ (FSDP over the data axes), this rank's chunk when
    they compute the same (a replicated layer over ``model``)."""

    @staticmethod
    def forward(ctx, x, comm: Comm, dim: int, summed: bool):
        ctx.comm, ctx.dim, ctx.summed = comm, dim, summed
        return comm.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            return ctx.comm.reduce_scatter(g, ctx.dim), None, None, None
        return ctx.comm.chunk(g, ctx.dim).contiguous(), None, None, None


class _Split(torch.autograd.Function):
    """This rank's chunk along ``dim`` of a replicated tensor; the
    backward all-gathers the chunks' gradients."""

    @staticmethod
    def forward(ctx, x, comm: Comm, dim: int):
        ctx.comm, ctx.dim = comm, dim
        return comm.chunk(x, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_gather(g, ctx.dim), None, None


@dataclass(frozen=True)
class TensorParallel:
    """A layer's tensor-parallel group (``model``), as the layers see it
    (``p.tp``): ``enter`` where the layer starts, ``exit`` after its
    last product."""

    comm: Comm

    @property
    def rank(self) -> int:
        return self.comm.rank

    @property
    def size(self) -> int:
        return self.comm.size

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyIn.apply(x, self.comm)

    def exit(self, y: torch.Tensor) -> torch.Tensor:
        return _ReduceOut.apply(y, self.comm)


@dataclass(frozen=True)
class BatchAxes:
    """The data axes that split the batch, as the MoE router sees them
    (``p.dp``)."""

    comm: Comm

    @property
    def rank(self) -> int:
        return self.comm.rank

    @property
    def size(self) -> int:
        return self.comm.size

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the batch's ranks (gradient summed back)."""
        return _SumAll.apply(x, self.comm)

    def gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` (no gradient), joined along ``dim``."""
        return self.comm.all_gather(x.detach(), dim)


def merge_partials(out: torch.Tensor, lse: torch.Tensor, all_reduce) -> torch.Tensor:
    """The attention over a whole sequence from the ranks' attention over
    their chunks of it. ``out`` (..., D) is this rank's result over its
    chunk, ``lse`` (...) float32 the log-sum-exp of its scores (-inf
    where the chunk holds no valid key, and then ``out`` is 0);
    ``all_reduce(t, op)`` reduces over the ranks (``Comm.all_reduce``).
    Two reductions: the max of ``lse``, then the sum of
    ``out * exp(lse - max)`` and ``exp(lse - max)`` in one tensor.
    Returns float32 (0 where no rank holds a key)."""
    peak = all_reduce(lse, "max")
    w = torch.where(torch.isneginf(lse), torch.zeros_like(lse), torch.exp(lse - peak))
    both = all_reduce(torch.cat([out.float() * w[..., None], w[..., None]], dim=-1), "sum")
    den = both[..., -1:]
    return torch.where(den > 0, both[..., :-1] / den.clamp_min(torch.finfo(den.dtype).tiny),
                       torch.zeros_like(both[..., :-1]))


@dataclass(frozen=True)
class SequenceSplit:
    """The data axes that split the decode caches' sequence (the
    long-context layout), as ``attention_decode`` sees them (``p.seq``):
    this rank holds positions ``[rank * chunk, (rank + 1) * chunk)``."""

    comm: Comm

    @property
    def rank(self) -> int:
        return self.comm.rank

    def merge(self, out: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
        return merge_partials(out, lse, self.comm.all_reduce)


@dataclass(frozen=True)
class ServeLayout:
    """How a forward pass lays out its batch over the data axes:
    ``rows_split`` (each rank computes its rows; MoE routing sums over
    the ranks) or every rank the whole batch; ``seq`` the split of the
    decode caches' sequence (the long-context layout) or None. Training
    runs in :data:`ROWS_SPLIT`; :meth:`Spmd.serve_layout` gives a
    serving call's."""

    rows_split: bool
    seq: SequenceSplit | None = None


ROWS_SPLIT = ServeLayout(rows_split=True)


# --------------------------------------------------------------------------
# Layouts
# --------------------------------------------------------------------------


def _axes_of(part) -> tuple[str, ...]:
    if part is None:
        return ()
    return tuple(part) if isinstance(part, (tuple, list)) else (part,)


def split_counts(spec: tuple, mesh) -> list[int]:
    """Per dim, the number of chunks ``spec`` cuts it into on ``mesh``."""
    out = []
    for part in spec:
        n = 1
        for a in _axes_of(part):
            n *= mesh.shape[a]
        out.append(n)
    return out


def shard_of(t: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's chunk of the whole tensor ``t`` laid out by ``spec``
    (DTensor's ``Shard`` chunks: a dim split over several axes is split
    over the outer one first)."""
    for dim, part in enumerate(spec):
        axes = _axes_of(part)
        if axes:
            comm = mesh.comm(axes)
            t = t.chunk(comm.size, dim)[comm.rank]
    return t


def gather_whole(t: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """The whole tensor of this rank's chunk ``t`` laid out by ``spec``
    (every rank of ``mesh`` calls it)."""
    for dim, part in enumerate(spec):
        if part is not None:
            t = mesh.comm(part).all_gather(t, dim)
    return t


@dataclass(frozen=True)
class Layout:
    data_dim: int | None      # dim sharded over the data axes
    model_dim: int | None     # dim sharded over model in storage
    compute_dim: int | None   # dim the layer splits over model (sharding.tp_split_dim)
    cast: torch.dtype | None  # cast before the gather


# --------------------------------------------------------------------------
# The sharded model
# --------------------------------------------------------------------------


class ShardView:
    """One module's parameters as its layer reads them on this rank
    (``p["wq"]``, ``"bq" in p``, ``p["attn"]``), gathered on first read
    and kept for the life of the view. ``tp`` is the layer's
    :class:`TensorParallel` group where it is split over ``model``, else
    None; ``dp`` the :class:`BatchAxes` that split the batch (None on
    one data rank, and where the serving layout keeps the batch whole);
    ``seq`` the :class:`SequenceSplit` of the decode caches' sequence
    (None unless the serving layout is the long-context one)."""

    def __init__(self, spmd: "Spmd", module: nn.Module, prefix: str):
        self._spmd, self._module, self._prefix = spmd, module, prefix
        self._cache: dict[str, torch.Tensor] = {}
        self.tp = spmd.module_tp.get(prefix)
        self.dp = spmd.batch_axes if spmd.layout.rows_split else None
        self.seq = spmd.layout.seq

    def __getitem__(self, key: str):
        item = self._module[key]
        if isinstance(item, torch.Tensor):
            if key not in self._cache:
                self._cache[key] = self._spmd.gather(self._prefix + key, item)
            return self._cache[key]
        return ShardView(self._spmd, item, f"{self._prefix}{key}.")

    def __contains__(self, key: str) -> bool:
        return key in self._module


class Spmd:
    """A model's layout on a mesh (``model.spmd``): each parameter's
    :class:`Layout`, the groups its collectives run on, and the sharded
    pieces of the forward pass (:meth:`view`, :meth:`embed`,
    :meth:`vocab_nll`, :meth:`full_logits`) and of the optimizer
    (:meth:`global_sq`, :meth:`row_max`)."""

    def __init__(self, model: nn.Module, mesh: Mesh, shapes: dict[str, tuple[int, ...]]):
        ax = axes_for(mesh)
        tp = ax.model_size(mesh)
        if model.plan.tp != tp:
            raise ValueError(f"the model's plan has tp={model.plan.tp}, the mesh's model "
                             f"axis {tp}: build it with make_plan(cfg, tp={tp})")
        self.mesh, self.cfg, self.shapes = mesh, model.cfg, shapes
        self.data = mesh.comm(ax.data)
        self.model = mesh.comm(ax.model)
        self.all = mesh.comm(mesh.axis_names)
        self.dp = self.data.size
        self.specs = param_specs({n: torch.empty(s, device="meta") for n, s in shapes.items()},
                                 model.cfg, ax, mesh)
        act = getattr(model, "act_dtype", None)
        self.layouts: dict[str, Layout] = {}
        for name, spec in self.specs.items():
            data_dim = model_dim = None
            for dim, part in enumerate(spec):
                axes = _axes_of(part)
                if ax.model in axes:
                    model_dim = dim
                elif axes:
                    data_dim = dim
            leaf = name.rsplit(".", 1)[-1]
            cast = act if act is not None and leaf in BF16_WEIGHTS else None
            self.layouts[name] = Layout(data_dim, model_dim,
                                        tp_split_dim(reference_path(name), shapes[name], tp),
                                        cast)
        tpg = TensorParallel(self.model) if tp > 1 else None
        # A module whose layer splits a leaf over ``model`` runs tensor-parallel.
        self.module_tp: dict[str, TensorParallel] = {
            name.rsplit(".", 1)[0] + ".": tpg for name, lay in self.layouts.items()
            if tpg is not None and "." in name and lay.compute_dim is not None}
        self.vocab = tpg if tpg is not None and self.layouts["embed"].compute_dim is not None \
            else None
        self.batch_axes = BatchAxes(self.data) if self.dp > 1 else None
        # The layout of the call in progress (:meth:`serving`), else training's.
        self.layout = ROWS_SPLIT
        self.prefixes = {id(m): (f"{n}." if n else "") for n, m in model.named_modules()}
        self.root = model

    # ---- parameters ------------------------------------------------------

    def gather(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The leaf ``name`` (this rank's chunk ``t``) as its layer reads it."""
        lay = self.layouts[name]
        x = t if lay.cast is None or t.dtype == lay.cast else t.to(lay.cast)
        # A gathered leaf is made contiguous: a product of one gathered on
        # another dim than 0 rounds otherwise, unlike one rank's (xLSTM's
        # decode, the int8 KV cache's codes).
        if self.data.size > 1:
            if lay.data_dim is not None:
                x = _Gather.apply(x, self.data, lay.data_dim, True).contiguous()
            elif x.requires_grad:
                x = _CopyIn.apply(x, self.data)
        if self.model.size > 1 and lay.model_dim != lay.compute_dim:
            if lay.model_dim is not None:
                x = _Gather.apply(x, self.model, lay.model_dim, False).contiguous()
            if lay.compute_dim is not None:
                x = _Split.apply(x, self.model, lay.compute_dim)
        return x

    def view(self, module: nn.Module) -> ShardView:
        return ShardView(self, module, self.prefixes[id(module)])

    # ---- vocabulary ------------------------------------------------------

    def embed(self, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Token ids -> embeddings in ``dtype``, from this rank's block of
        vocabulary rows (the others' ids masked), summed over ``model``."""
        w = self.view(self.root)["embed"]
        if self.vocab is None:
            return w[tokens].to(dtype)
        rows = w.shape[0]
        local = tokens - self.vocab.rank * rows
        inside = (local >= 0) & (local < rows)
        e = w[local.clamp(0, rows - 1)].to(dtype) * inside[..., None].to(dtype)
        return self.vocab.exit(e)

    def vocab_nll(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """-log softmax(logits)[label] per position, the logits split over
        the vocabulary (max and sum of exponentials all-reduced)."""
        if self.vocab is None:
            logp = F.log_softmax(logits, dim=-1)
            return -logp.gather(-1, labels.long()[..., None])[..., 0]
        rows = logits.shape[-1]
        peak = self.model.all_reduce(logits.detach().amax(dim=-1), "max")
        z = logits - peak[..., None]
        sumexp = self.vocab.exit(z.exp().sum(dim=-1))
        local = labels.long() - self.vocab.rank * rows
        inside = (local >= 0) & (local < rows)
        picked = z.gather(-1, local.clamp(0, rows - 1)[..., None])[..., 0]
        picked = self.vocab.exit(torch.where(inside, picked, torch.zeros_like(picked)))
        return sumexp.log() - picked

    def full_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """Logits split over the vocabulary, joined (serving's argmax)."""
        return logits if self.vocab is None else self.model.all_gather(logits, logits.dim() - 1)

    # ---- batch -----------------------------------------------------------

    def local_batch(self, batch: dict) -> dict:
        """This rank's rows of a global batch (the data axes split dim 0)."""
        if self.dp == 1:
            return batch
        out = {}
        for k, v in batch.items():
            if v.shape[0] % self.dp:
                raise ValueError(f"batch {k} of {v.shape[0]} rows on {self.dp} data ranks")
            out[k] = v.chunk(self.dp, 0)[self.data.rank]
        return out

    def data_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the data axes of a per-rank value (no gradient)."""
        return self.data.all_reduce(x.detach()) / self.dp

    # ---- caches ----------------------------------------------------------

    def serve_layout(self, batch: int, max_len: int) -> ServeLayout:
        """The layout of prefill and decode for a global ``batch`` and
        caches of ``max_len`` positions (the reference's ``cache_specs``):
        rows split over the data axes where they divide ``batch``;
        otherwise every rank serves the whole batch, and the KV caches'
        sequence is split over the data axes where they divide
        ``max_len``."""
        if batch % self.dp == 0:
            return ROWS_SPLIT
        long_seq = self.dp > 1 and max_len % self.dp == 0
        return ServeLayout(rows_split=False, seq=SequenceSplit(self.data) if long_seq else None)

    @contextlib.contextmanager
    def serving(self, layout: ServeLayout):
        """``layout`` for the views made inside the block (one prefill or
        decode step), training's after it, whatever the block raised."""
        prev, self.layout = self.layout, layout
        try:
            yield
        finally:
            self.layout = prev

    def cache_layout(self, batch: int, max_len: int, dtype: torch.dtype = torch.float32):
        """-> (the whole caches of a global ``batch`` as ``meta``
        tensors, the spec of each leaf as this rank holds it). The specs
        are :func:`.sharding.cache_specs`', except that a Mamba2 state
        split over ``model`` there (``ssm``'s heads) is held whole: the
        Mamba2 layers run whole on every model rank (ROADMAP.md,
        intended differences)."""
        from torch.utils._python_dispatch import _disable_current_modes

        from ..models import transformer as T

        # The template holds shapes only: a dispatch mode over the caller
        # (the dry run's count of live storage) must not see it made.
        with _disable_current_modes():
            whole = T.init_caches(self.cfg, batch, max_len, self.root.plan, "meta", dtype)
        specs = cache_specs(whole, self.cfg, axes_for(self.mesh), self.mesh, batch=batch)
        model = axes_for(self.mesh).model
        if "mamba" in specs:
            specs["mamba"] = [{k: tuple(None if a == model else a for a in spec)
                               for k, spec in leaf.items()} for leaf in specs["mamba"]]
        return whole, specs

    def init_caches(self, batch: int, max_len: int, device, dtype: torch.dtype) -> dict:
        """This rank's chunk of empty decode caches for a global ``batch``,
        laid out by :meth:`cache_layout` (batch or, for a batch the data
        axes do not divide, the KV sequence over the data axes; slots
        over ``model``)."""
        whole, specs = self.cache_layout(batch, max_len, dtype)
        return _map_leaves(whole, specs, lambda leaf, spec: torch.zeros(
            [n // c for n, c in zip(leaf.shape, split_counts(spec, self.mesh))],
            dtype=leaf.dtype, device=device))

    def shard_caches(self, caches: dict, batch: int) -> dict:
        """This rank's chunk, as :meth:`init_caches` lays it out, of the
        caches of a global ``batch`` that a prefill made: whole caches
        (one rank's model) are cut; a dim the prefill already split (a
        mesh's prefill gives its slots of ``model``, or its rows of a
        batch the data axes divide) is kept."""
        kv = caches.get("kv") or caches.get("shared_kv")
        max_len = next(iter(kv[0].values())).shape[2] if kv else 1
        whole, specs = self.cache_layout(batch, max_len)

        def cut(whole_leaf, spec, leaf):
            for dim, part in enumerate(spec):
                axes = _axes_of(part)
                if axes and leaf.shape[dim] == whole_leaf.shape[dim]:
                    comm = self.mesh.comm(axes)
                    leaf = leaf.chunk(comm.size, dim)[comm.rank]
            return leaf.contiguous()

        return _map_leaves(whole, specs, cut, caches)

    # ---- optimizer -------------------------------------------------------

    def global_sq(self, tree: dict[str, torch.Tensor]) -> torch.Tensor:
        """The sum of squares of every leaf of a parameter-shaped tree of
        chunks, each element counted once: a leaf's chunk is weighted by
        one over the number of ranks that hold the same chunk."""
        names = list(tree)
        norms = torch._foreach_norm([tree[n].float() for n in names])
        total = torch.zeros((), device=norms[0].device if norms else None)
        for n, v in zip(names, norms):
            held = 1
            for c in split_counts(self.specs[n], self.mesh):
                held *= c
            total = total + v.square() * (held / self.mesh.size)
        return self.all.all_reduce(total)

    def row_max(self, name: str, amax: torch.Tensor) -> torch.Tensor:
        """The row maxima of ``AdamW8bit``'s scales for leaf ``name``,
        taken over the ranks that split a row: the non-leading dims, or
        every dim of one layer of a group the reference stacks (whose
        row is the layer)."""
        spec = self.specs[name] if stacked_in_reference(name) else self.specs[name][1:]
        axes = tuple(a for part in spec for a in _axes_of(part))
        return amax if not axes else self.mesh.comm(axes).all_reduce(amax, "max")


def _map_leaves(whole, specs, fn, *others):
    """``fn(leaf, spec, *other leaves)`` over the leaves of ``whole`` (dicts
    and lists of tensors), with ``specs`` and ``others`` of its structure."""
    if isinstance(whole, dict):
        return {k: _map_leaves(v, specs[k], fn, *(o[k] for o in others))
                for k, v in whole.items()}
    if isinstance(whole, list):
        return [_map_leaves(v, specs[i], fn, *(o[i] for o in others))
                for i, v in enumerate(whole)]
    return fn(whole, specs, *others)


def distribute(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Keep this rank's chunk of every parameter of the whole ``model``
    (built by every rank from the same seed or state dict), in place, and
    attach its layout on ``mesh`` (``model.spmd``). Returns ``model``."""
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    spmd = Spmd(model, mesh, shapes)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.data = shard_of(p.data, spmd.specs[name], mesh).clone()
    model.spmd = spmd
    return model
