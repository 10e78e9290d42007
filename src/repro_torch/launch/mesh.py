"""Device meshes over ``torch.distributed`` (the port of ``repro/launch/mesh.py``).

A :class:`Mesh` lays the ranks of a process group out on named axes, the
``model`` (tensor-parallel) axis innermost, ``data`` next, ``pod``
outermost, as the reference's production mesh does. It holds the
``torch.distributed`` ``DeviceMesh`` of those ranks and one
:class:`Comm` per group of axes that the sharded step reduces over: each
single axis (the ``DeviceMesh``'s own groups), the data axes together
(:func:`axes_for`) and all axes.

The process group comes from the caller (``torchrun``'s environment, or
a test's spawned ranks): :func:`make_mesh` raises where there is none,
instead of running on one rank unasked. ``mesh.shape[axis]`` and
``mesh.axis_names`` are all that :class:`MeshAxes` and the sharding rules
read, so a duck-typed mesh serves them too.

:class:`Comm` runs the collectives. On ``nccl`` (one card per rank) they
run on the card. ``gloo`` runs them in host memory: a CUDA tensor is
copied to the host, reduced there and copied back (ranks that share one
card cannot use ``nccl``), and the bytes so staged are counted beside
the bytes of each kind of collective. On ``meta`` tensors (the dry run
over a ``fake`` process group, ``launch/dryrun.py``) a collective only
counts its bytes.
"""

from __future__ import annotations

import itertools
from collections import Counter
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

__all__ = ["make_mesh", "make_production_mesh", "Mesh", "MeshAxes", "axes_for", "Comm"]


@dataclass(frozen=True)
class MeshAxes:
    """Logical roles of the mesh axes for the sharding rules."""

    data: tuple[str, ...]       # axes carrying batch (DP / FSDP)
    model: str                  # axis carrying TP / EP
    pod: str | None = None

    def data_size(self, mesh) -> int:
        n = 1
        for a in self.data:
            n *= mesh.shape[a]
        return n

    def model_size(self, mesh) -> int:
        return mesh.shape[self.model]


def axes_for(mesh) -> MeshAxes:
    names = mesh.axis_names
    if "pod" in names:
        return MeshAxes(data=("pod", "data"), model="model", pod="pod")
    return MeshAxes(data=("data",), model="model")


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclass
class Comm:
    """Collectives over one group of mesh ranks, in the order of their
    mesh coordinates (the order in which the group's ranks hold the
    chunks of a sharded dim). A group of one rank moves nothing.

    ``bytes`` counts, per kind, the bytes each call hands the collective
    (a tensor's size before an all-gather, its whole size before an
    all-reduce or reduce-scatter); ``staged`` the bytes copied between
    the card and the host for ``gloo``. Both may be shared by several
    ``Comm`` of one mesh."""

    group: object
    size: int
    rank: int
    backend: str
    bytes: Counter = field(default_factory=Counter)
    staged: Counter = field(default_factory=Counter)

    def _run(self, kind: str, t: torch.Tensor, out_shape, fn) -> torch.Tensor:
        """``fn(src, dst)`` on ``t``'s data into a new tensor of
        ``out_shape`` (dim 0 first; None: ``fn`` works in place on ``src``,
        a copy of ``t``); through pinned host buffers for a CUDA tensor on
        ``gloo``."""
        self.bytes[kind] += t.numel() * t.element_size()
        if t.is_meta:  # the dry run (``launch/dryrun.py``): counted, nothing moves
            return t.new_empty(t.shape if out_shape is None else out_shape)
        staged = t.is_cuda and self.backend == "gloo"
        if staged:
            src = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            src.copy_(t)
        else:
            src = t if out_shape is not None else t.clone()
        if out_shape is None:
            fn(src, src)
            dst = src
        else:
            dst = torch.empty(out_shape, dtype=t.dtype, pin_memory=True) if staged \
                else t.new_empty(out_shape)
            fn(src, dst)
        if not staged:
            return dst
        self.staged[kind] += src.numel() * src.element_size() + dst.numel() * dst.element_size()
        return dst.to(t.device)

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """A new tensor: the elementwise sum (or max) over the group."""
        if self.size == 1:
            return t
        return self._run(f"all_reduce_{op}", t.contiguous(), None,
                         lambda x, _: dist.all_reduce(x, op=_OPS[op], group=self.group))

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The group's tensors joined along ``dim`` in rank order."""
        if self.size == 1:
            return t
        x = t.movedim(dim, 0).contiguous()
        out = self._run("all_gather", x, (self.size * x.shape[0], *x.shape[1:]),
                        lambda src, dst: dist.all_gather_into_tensor(dst, src, group=self.group))
        return out.movedim(0, dim)

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's chunk along ``dim`` of the group's sum."""
        if self.size == 1:
            return t
        x = t.movedim(dim, 0).contiguous()
        out = self._run("reduce_scatter", x, (x.shape[0] // self.size, *x.shape[1:]),
                        lambda src, dst: dist.reduce_scatter_tensor(dst, src, group=self.group))
        return out.movedim(0, dim)

    def chunk(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's chunk of ``t`` along ``dim`` (no communication)."""
        if self.size == 1:
            return t
        return t.chunk(self.size, dim)[self.rank]


@dataclass
class Mesh:
    """Ranks on named axes. ``shape`` maps each axis to its size;
    ``coords`` are this rank's coordinates (None outside the mesh);
    ``comms`` holds a :class:`Comm` per group of axes (see :meth:`comm`)."""

    shape: dict[str, int]
    axis_names: tuple[str, ...]
    ranks: tuple[int, ...]
    device_type: str
    device_mesh: object
    coords: tuple[int, ...] | None
    comms: dict[tuple[str, ...], Comm]

    @property
    def member(self) -> bool:
        return self.coords is not None

    @property
    def size(self) -> int:
        return len(self.ranks)

    def comm(self, axes) -> Comm:
        """The :class:`Comm` over ``axes`` (a name or a tuple of names),
        through this rank."""
        key = (axes,) if isinstance(axes, str) else tuple(axes)
        key = tuple(a for a in self.axis_names if a in key)
        return self.comms[key]


def _groups_needed(axis_names: tuple[str, ...]) -> list[tuple[str, ...]]:
    """Each axis, the data axes together and all axes, in mesh order."""
    data = ("pod", "data") if "pod" in axis_names else ("data",)
    want = [(a,) for a in axis_names] + [tuple(a for a in axis_names if a in data),
                                         axis_names]
    return list(dict.fromkeys(w for w in want if w))


def make_mesh(shape, axes, device_type: str = "cuda", ranks=None) -> Mesh:
    """A mesh of ``shape`` (sizes) on ``axes`` (names) over ``ranks`` of
    the default process group (all of them, in order, unless given).
    Every rank of the process group must call it, members or not: it
    creates the groups of the mesh's collectives. Raises without a
    process group, or if ``ranks`` do not fill ``shape`` in increasing order."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs a torch.distributed process group: start the "
                           "ranks with torchrun or init_process_group first")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA card is available")
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    ranks = tuple(range(dist.get_world_size())) if ranks is None else tuple(ranks)
    n = 1
    for s in shape:
        n *= s
    if len(shape) != len(axes) or n != len(ranks):
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs {n} ranks, got {len(ranks)}")
    if list(ranks) != sorted(set(ranks)):  # a group orders its ranks by number
        raise ValueError(f"the mesh's ranks must increase, got {ranks}")
    from torch.distributed.device_mesh import DeviceMesh

    grid = torch.tensor(ranks, dtype=torch.int64).view(shape)
    device_mesh = DeviceMesh(device_type, grid, mesh_dim_names=axes)
    me = dist.get_rank()
    coords = None
    for idx in itertools.product(*(range(s) for s in shape)):
        if int(grid[idx]) == me:
            coords = idx
    backend = dist.get_backend()
    counts, staged = Counter(), Counter()
    comms = {}
    for group_axes in _groups_needed(axes):
        dims = [axes.index(a) for a in group_axes]
        if len(dims) == 1:  # the DeviceMesh made one group per axis
            if coords is not None:
                group = device_mesh.get_group(group_axes[0])
                comms[group_axes] = Comm(group, shape[dims[0]], coords[dims[0]], backend,
                                         counts, staged)
            continue
        rest = [i for i in range(len(axes)) if i not in dims]
        for fixed in itertools.product(*(range(shape[i]) for i in rest)):
            members = []
            for inner in itertools.product(*(range(shape[i]) for i in dims)):
                idx = [0] * len(axes)
                for i, v in zip(rest, fixed):
                    idx[i] = v
                for i, v in zip(dims, inner):
                    idx[i] = v
                members.append(int(grid[tuple(idx)]))
            group = dist.new_group(members)
            if me in members:
                comms[group_axes] = Comm(group, len(members), members.index(me), backend,
                                         counts, staged)
    return Mesh(dict(zip(axes, shape)), axes, ranks, device_type, device_mesh, coords, comms)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> Mesh:
    """The reference's production mesh: (data 16, model 16), or with
    ``multi_pod`` (pod 2, data 16, model 16); 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)
