"""Model facade: config + plan + parameters -> forward / prefill / decode.

The port of ``repro/models/model.py``. ``Model`` is an ``nn.Module``
holding its parameter tree (the reference passes the pytree to each
call); ``build_model`` draws the weights from a seeded generator on the
target device. ``loss_fn`` and training come in a later slice.
"""

from __future__ import annotations

import torch

from ..app._device import resolve_device
from . import transformer as T
from .config import ArchConfig
from .layers import Params
from .plan import ShardingPlan, make_plan

__all__ = ["Model", "build_model"]


class Model(Params):
    """Parameters of one architecture, with the reference ``Model``'s
    methods minus the ``params`` argument. The state-dict names follow
    the reference's pytree paths with ``blocks`` split per layer
    (``blocks.3.mamba.in_proj``), which ``convert.params_from_jax``
    produces. Activations run in bfloat16 as built; ``model.float()``
    runs every activation and cache in float32 (the CPU tests' check
    of the algorithm, free of bfloat16 rounding noise)."""

    def __init__(self, cfg: ArchConfig, plan: ShardingPlan, params: dict):
        super().__init__(params)
        self.cfg = cfg
        self.plan = plan

    def train_forward(self, inputs: dict):
        return T.train_forward(self, inputs, self.cfg)

    def decode_step(self, caches, tokens, lengths):
        return T.decode_step(self, caches, tokens, lengths, self.cfg)

    def init_caches(self, batch: int, max_len: int):
        return T.init_caches(self.cfg, batch, max_len, self.plan, self["embed"].device,
                             T.compute_dtype(self))

    def prefill(self, inputs: dict, max_len: int):
        return T.prefill(self, inputs, self.cfg, max_len)


def build_model(cfg: ArchConfig, plan: ShardingPlan | None = None, *,
                device="cuda", generator: torch.Generator | None = None,
                seed: int = 0) -> Model:
    """Weights drawn on ``device`` (the card unless the caller asks for
    the CPU; a CUDA device without a card raises) from ``generator``,
    or from a new generator seeded with ``seed``."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator(dev).manual_seed(seed)
    plan = plan or make_plan(cfg)
    if plan.tp != 1:
        raise NotImplementedError("the port runs tp=1 only (sharding is a later slice)")
    return Model(cfg, plan, T.init_model_params(gen, cfg, plan, dev))
