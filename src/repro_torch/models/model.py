"""Model facade: config + plan + parameters -> forward / prefill / decode.

The port of ``repro/models/model.py``. ``Model`` is an ``nn.Module``
holding its parameter tree (the reference passes the pytree to each
call); ``build_model`` draws the weights from a seeded generator on the
target device, frozen in bfloat16 for serving or, with
``trainable=True``, as float32 masters that take gradients. With a
``mesh`` (``launch/mesh.py``), every rank draws the whole tree from the
same generator and keeps its chunk (``launch/spmd.py``), so the sharded
model computes what one rank computes.
"""

from __future__ import annotations

import torch

from ..app._device import resolve_device
from . import transformer as T
from .config import ArchConfig
from .layers import COMPUTE_DTYPE, Params, stored
from .plan import ShardingPlan, make_plan

__all__ = ["Model", "build_model"]


class Model(Params):
    """Parameters of one architecture, with the reference ``Model``'s
    methods minus the ``params`` argument. The state-dict names follow
    the reference's pytree paths with ``blocks`` split per layer
    (``blocks.3.mamba.in_proj``), which ``convert.params_from_jax``
    produces. Activations run in bfloat16 as built; ``model.float()``
    runs every activation and cache in float32 (the CPU tests' check
    of the algorithm, free of bfloat16 rounding noise).

    A trainable model (``trainable=True``) keeps float32 masters and
    runs its activations in ``act_dtype`` (bfloat16, as the reference;
    float32 for the CPU tests' check of the algorithm).

    On a mesh (``spmd`` set, see ``launch/spmd.py``) the parameters are
    this rank's chunks; ``train_forward`` returns this rank's block of
    the vocabulary. ``prefill`` takes the global batch and returns this
    rank's rows of the logits and its chunk of the caches, in the layout
    ``init_caches`` gives for that batch (``launch/spmd.py``, serving
    layouts); ``decode_step`` takes and returns this rank's rows, and
    where the data axes have more than one rank, the ``layout`` its
    caches were made in (``model.spmd.serve_layout(batch, max_len)``)."""

    def __init__(self, cfg: ArchConfig, plan: ShardingPlan, params: dict,
                 trainable: bool = False, act_dtype: torch.dtype | None = None):
        super().__init__(params, trainable)
        self.cfg = cfg
        self.plan = plan
        self.act_dtype = act_dtype

    def train_forward(self, inputs: dict, remat: bool = True):
        return T.train_forward(self, inputs, self.cfg, remat)

    def loss_fn(self, inputs: dict, aux_weight: float = 0.01):
        """Causal LM loss: inputs["tokens"] (B, S); predicts t+1. With
        ``inputs["labels"]`` (B, S), positions whose label is negative
        are left out. -> (loss, {"nll", "aux"})."""
        logits, aux = self.train_forward(inputs)
        if "labels" in inputs:
            labels, logits_s = inputs["labels"], logits
        else:
            labels, logits_s = inputs["tokens"][:, 1:], logits[:, :-1]
        nll = T.token_nll(self, logits_s, labels.clamp_min(0))
        mask = (labels >= 0).float()
        loss = (nll * mask).sum() / mask.sum().clamp_min(1.0)
        return loss + aux_weight * aux, {"nll": loss, "aux": aux}

    def decode_step(self, caches, tokens, lengths, layout=None):
        sp = getattr(self, "spmd", None)
        if sp is None or sp.dp == 1:
            return T.decode_step(self, caches, tokens, lengths, self.cfg)
        if layout is None:
            raise ValueError(f"decode on {sp.dp} data ranks needs the caches' layout: "
                             "model.spmd.serve_layout(batch, max_len)")
        with sp.serving(layout):
            return T.decode_step(self, caches, tokens, lengths, self.cfg)

    def init_caches(self, batch: int, max_len: int):
        """Empty caches for ``batch`` rows; on a mesh, this rank's chunk
        of the caches of a global ``batch``."""
        sp = getattr(self, "spmd", None)
        if sp is not None:
            return sp.init_caches(batch, max_len, self["embed"].device, T.compute_dtype(self))
        return T.init_caches(self.cfg, batch, max_len, self.plan, self["embed"].device,
                             T.compute_dtype(self))

    def prefill(self, inputs: dict, max_len: int):
        sp = getattr(self, "spmd", None)
        if sp is None:
            return T.prefill(self, inputs, self.cfg, max_len)
        batch = next(iter(inputs.values())).shape[0]
        layout = sp.serve_layout(batch, max_len)
        with sp.serving(layout):
            logits, caches = T.prefill(self, sp.local_batch(inputs) if layout.rows_split
                                       else inputs, self.cfg, max_len)
        return logits, sp.shard_caches(caches, batch)


def build_model(cfg: ArchConfig, plan: ShardingPlan | None = None, *,
                device="cuda", generator: torch.Generator | None = None,
                seed: int = 0, trainable: bool = False,
                act_dtype: torch.dtype = COMPUTE_DTYPE, mesh=None) -> Model:
    """Weights drawn on ``device`` (the card unless the caller asks for
    the CPU; a CUDA device without a card raises) from ``generator``,
    or from a new generator seeded with ``seed``. ``trainable=True``
    keeps them as float32 masters that take gradients, with activations
    in ``act_dtype``; otherwise frozen, bfloat16 where the reference
    casts (serving), each tensor cast as soon as it is drawn.

    With ``mesh``, the plan's ``tp`` is the mesh's model axis (padded
    attention slots, ``plan.py``) and each rank keeps its chunk of every
    tensor (``launch.spmd.distribute``); the whole tree exists on each
    rank until it is cut."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator(dev).manual_seed(seed)
    if mesh is not None and plan is None:
        from ..launch.mesh import axes_for

        ax = axes_for(mesh)
        plan = make_plan(cfg, tp=ax.model_size(mesh), dp_axes=ax.data, tp_axis=ax.model)
    plan = plan or make_plan(cfg)
    tree = T.init_model_params(gen, cfg, plan, dev,
                               store=lambda name, t: stored(name, t, trainable))
    model = Model(cfg, plan, tree, trainable, act_dtype if trainable else None)
    if mesh is not None:
        from ..launch.spmd import distribute

        distribute(model, mesh)
    return model
