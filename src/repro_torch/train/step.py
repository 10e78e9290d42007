"""Train / serve step builders (the port of ``repro/train/step.py``).

``make_train_step`` returns ``train_step(state, batch) -> (state,
metrics)``: the reference's loss (next-token NLL over ``tokens[:, 1:]``
plus ``0.01 * aux``), gradients by autograd (through the flash and scan
kernels' backward on the card), optional micro-batch accumulation of
float32 gradients (a loop over the batch split, where the reference
scans), and the optimizer's update. The model holds its parameters;
``TrainState.params`` is its ``{name: parameter}`` dict, which the
optimizer updates in place. Metrics stay device tensors (no host read
per step). The reference's ``grad_shardings`` and
``make_compressed_dp_grads`` belong to the multi-card launchers
(ROADMAP.md, queue 1, item 6).

``make_serve_step`` / ``make_prefill_step`` are the serving steps.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from ..models.model import Model

__all__ = ["TrainState", "make_train_step", "loss_and_grads", "make_serve_step",
           "make_prefill_step"]


class TrainState(NamedTuple):
    params: dict[str, torch.Tensor]
    opt: Any


def train_loss(model: Model, batch: dict, remat: bool = True):
    """The reference train step's loss: -> (loss, {"nll", "aux"})."""
    logits, aux = model.train_forward(batch, remat=remat)
    labels, lg = batch["tokens"][:, 1:], logits[:, :-1]
    logp = F.log_softmax(lg, dim=-1)
    nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
    return nll.mean() + 0.01 * aux, {"nll": nll.mean().detach(), "aux": aux.detach()}


def loss_and_grads(model: Model, batch: dict, remat: bool = True):
    """-> (loss, metrics, {name: float32 gradient}) for every parameter
    of ``model``."""
    names, params = zip(*model.named_parameters())
    loss, metrics = train_loss(model, batch, remat)
    grads = torch.autograd.grad(loss, params)
    return loss.detach(), metrics, {n: g.float() for n, g in zip(names, grads)}


def make_train_step(model: Model, optimizer, *, microbatches: int = 1, remat: bool = True):
    """-> train_step(state, batch) -> (state, metrics)."""

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        if microbatches == 1:
            loss, metrics, grads = loss_and_grads(model, batch, remat)
        else:
            parts = {k: v.chunk(microbatches) for k, v in batch.items()}
            grads, loss = None, 0.0
            for i in range(microbatches):
                l_i, _, g_i = loss_and_grads(model, {k: v[i] for k, v in parts.items()}, remat)
                loss = loss + l_i
                if grads is None:
                    grads = g_i
                else:
                    torch._foreach_add_(list(grads.values()), list(g_i.values()))
            torch._foreach_div_(list(grads.values()), float(microbatches))
            loss = loss / microbatches
            metrics = {"nll": loss, "aux": torch.zeros((), device=loss.device)}
        params, opt = optimizer.update(grads, state.opt, state.params)
        metrics = dict(metrics, loss=loss, step=opt.step)
        return TrainState(params, opt), metrics

    return step


def make_serve_step(model: Model):
    """-> serve_step(caches, tokens, lengths) ->
    (next_tokens, logits, caches, lengths)."""

    def serve_step(caches, tokens, lengths):
        logits, caches = model.decode_step(caches, tokens, lengths)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt, logits, caches, lengths + 1

    return serve_step


def make_prefill_step(model: Model, max_len: int):
    def prefill_step(inputs):
        logits, caches = model.prefill(inputs, max_len)
        return logits, caches

    return prefill_step
