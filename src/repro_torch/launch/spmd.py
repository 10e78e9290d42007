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

The train step takes the global batch and uses its rank's rows (the
data axes split the batch; the loss and metrics are averaged over
them); serving takes and returns the rank's rows. Weights: every rank
builds the whole model from the same seed (or state dict) and keeps its
chunk, so the sharded model computes what one rank computes.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.convert import stacked_in_reference
from ..models.layers import BF16_WEIGHTS
from .mesh import Comm, Mesh, axes_for
from .sharding import cache_specs, param_specs, reference_path, tp_split_dim

__all__ = ["distribute", "Spmd", "ShardView", "TensorParallel", "shard_of",
           "gather_whole", "split_counts"]


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
    one data rank)."""

    def __init__(self, spmd: "Spmd", module: nn.Module, prefix: str):
        self._spmd, self._module, self._prefix = spmd, module, prefix
        self._cache: dict[str, torch.Tensor] = {}
        self.tp = spmd.module_tp.get(prefix)
        self.dp = spmd.batch_axes

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
        self.prefixes = {id(m): (f"{n}." if n else "") for n, m in model.named_modules()}
        self.root = model

    # ---- parameters ------------------------------------------------------

    def gather(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The leaf ``name`` (this rank's chunk ``t``) as its layer reads it."""
        lay = self.layouts[name]
        x = t if lay.cast is None or t.dtype == lay.cast else t.to(lay.cast)
        if self.data.size > 1:
            if lay.data_dim is not None:
                x = _Gather.apply(x, self.data, lay.data_dim, True)
            elif x.requires_grad:
                x = _CopyIn.apply(x, self.data)
        if self.model.size > 1 and lay.model_dim != lay.compute_dim:
            if lay.model_dim is not None:
                x = _Gather.apply(x, self.model, lay.model_dim, False)
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

    def init_caches(self, batch: int, max_len: int, device, dtype: torch.dtype) -> dict:
        """This rank's chunk of empty decode caches for a global ``batch``,
        laid out by :func:`.sharding.cache_specs`: batch over the data
        axes, slots over ``model``."""
        from ..models import transformer as T

        cfg = self.cfg
        if cfg.family not in ("dense", "moe", "vlm"):
            raise NotImplementedError(
                f"serving {cfg.family} on a mesh is not ported (ROADMAP.md, open items: "
                "the other families' serving on a mesh)")
        if batch % self.dp:
            raise NotImplementedError(
                f"batch {batch} on {self.dp} data ranks: the long-context layout (the "
                "cache's sequence over the data axes) is not ported (ROADMAP.md, open items)")
        whole = T.init_caches(cfg, batch, max_len, self.root.plan, "meta", dtype)
        specs = cache_specs(whole, cfg, axes_for(self.mesh), self.mesh, batch=batch)

        def local(node, spec):
            if isinstance(node, dict):
                return {k: local(v, spec[k]) for k, v in node.items()}
            if isinstance(node, list):
                return [local(v, s) for v, s in zip(node, spec)]
            shape = [n // c for n, c in zip(node.shape, split_counts(spec, self.mesh))]
            return torch.zeros(shape, dtype=node.dtype, device=device)

        return local(whole, specs)

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
