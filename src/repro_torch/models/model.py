"""Model facade: config + plan + parameters -> forward / prefill / decode.

The port of ``repro/models/model.py``. ``Model`` is an ``nn.Module``
holding its parameter tree (the reference passes the pytree to each
call); ``build_model`` draws the weights from a seeded generator on the
target device, frozen in bfloat16 for serving or, with
``trainable=True``, as float32 masters that take gradients.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..app._device import resolve_device
from . import transformer as T
from .config import ArchConfig
from .layers import COMPUTE_DTYPE, Params
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
    float32 for the CPU tests' check of the algorithm)."""

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
        logp = F.log_softmax(logits_s, dim=-1)
        nll = -logp.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
        mask = (labels >= 0).float()
        loss = (nll * mask).sum() / mask.sum().clamp_min(1.0)
        return loss + aux_weight * aux, {"nll": loss, "aux": aux}

    def decode_step(self, caches, tokens, lengths):
        return T.decode_step(self, caches, tokens, lengths, self.cfg)

    def init_caches(self, batch: int, max_len: int):
        return T.init_caches(self.cfg, batch, max_len, self.plan, self["embed"].device,
                             T.compute_dtype(self))

    def prefill(self, inputs: dict, max_len: int):
        return T.prefill(self, inputs, self.cfg, max_len)


def build_model(cfg: ArchConfig, plan: ShardingPlan | None = None, *,
                device="cuda", generator: torch.Generator | None = None,
                seed: int = 0, trainable: bool = False,
                act_dtype: torch.dtype = COMPUTE_DTYPE) -> Model:
    """Weights drawn on ``device`` (the card unless the caller asks for
    the CPU; a CUDA device without a card raises) from ``generator``,
    or from a new generator seeded with ``seed``. ``trainable=True``
    keeps them as float32 masters that take gradients, with activations
    in ``act_dtype``; otherwise frozen, bfloat16 where the reference
    casts (serving)."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator(dev).manual_seed(seed)
    plan = plan or make_plan(cfg)
    if plan.tp != 1:
        raise NotImplementedError("the port runs tp=1 only (sharding is a later slice)")
    return Model(cfg, plan, T.init_model_params(gen, cfg, plan, dev), trainable,
                 act_dtype if trainable else None)
