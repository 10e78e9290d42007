"""Train / serve step builders (the port of ``repro/train/step.py``).

``make_train_step`` returns ``train_step(state, batch) -> (state,
metrics)``: the reference's loss (next-token NLL over ``tokens[:, 1:]``
plus ``0.01 * aux``), gradients by autograd (through the flash and scan
kernels' backward on the card), optional micro-batch accumulation of
float32 gradients (a loop over the batch split, where the reference
scans), and the optimizer's update. The model holds its parameters;
``TrainState.params`` is its ``{name: parameter}`` dict, which the
optimizer updates in place. Metrics stay device tensors (no host read
per step).

On a mesh (a model from ``build_model(..., mesh=)``, ``launch/spmd.py``)
the same step is sharded: it takes the global batch and uses its rank's
rows, the layers gather their parameters per layer and reduce-scatter
their gradients back to the rank's chunks (the reference's
``grad_shardings``), the loss is vocab-parallel and averaged over the
data axes, and the optimizer updates the chunks (``shards``).
``make_compressed_dp_grads`` is the reference's explicit data-parallel
exchange with int8 error feedback (``optim.ef_roundtrip``).

``make_serve_step`` / ``make_prefill_step`` are the serving steps.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..models import transformer as T
from ..models.model import Model

__all__ = ["TrainState", "make_train_step", "loss_and_grads", "make_serve_step",
           "make_prefill_step", "make_compressed_dp_grads"]


class TrainState(NamedTuple):
    params: dict[str, torch.Tensor]
    opt: Any


def train_loss(model: Model, batch: dict, remat: bool = True):
    """The reference train step's loss: -> (loss, {"nll", "aux"}). A
    batch of embeddings only (vlm) is scored against token 0, as the
    reference's proxy labels."""
    logits, aux = model.train_forward(batch, remat=remat)
    lg = logits[:, :-1]
    tokens = batch.get("tokens")
    if tokens is not None and tokens.dim() == 2:
        labels = tokens[:, 1:]
    else:
        labels = torch.zeros(lg.shape[:2], dtype=torch.long, device=lg.device)
    nll = T.token_nll(model, lg, labels)
    return nll.mean() + 0.01 * aux, {"nll": nll.mean().detach(), "aux": aux.detach()}


def loss_and_grads(model: Model, batch: dict, remat: bool = True):
    """-> (loss, metrics, {name: float32 gradient}) for every parameter
    of ``model``: 0 for the leaves the forward never reads
    (``unread_in_training``); every other parameter must reach the loss
    (autograd raises otherwise). On a mesh: the global batch in, the
    loss and metrics averaged over the data axes, the gradients of this
    rank's chunks."""
    named = dict(model.named_parameters())
    unread = T.unread_in_training(model.cfg)
    read = [n for n in named if n.rsplit(".", 1)[-1] not in unread]
    sp = getattr(model, "spmd", None)
    if sp is not None:
        batch = sp.local_batch(batch)
    loss, metrics = train_loss(model, batch, remat)
    # On a mesh each data rank's loss counts 1/dp of the whole; the
    # per-layer gathers sum the ranks' gradients back.
    scaled = loss if sp is None else loss / sp.dp
    grads = dict(zip(read, torch.autograd.grad(scaled, [named[n] for n in read])))
    if sp is not None:
        loss = sp.data_mean(loss)
        metrics = {k: sp.data_mean(v) for k, v in metrics.items()}
    return loss.detach(), metrics, {
        n: grads[n].float() if n in grads else torch.zeros_like(t, dtype=torch.float32)
        for n, t in named.items()}


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
        params, opt = optimizer.update(grads, state.opt, state.params,
                                       shards=getattr(model, "spmd", None))
        metrics = dict(metrics, loss=loss, step=opt.step)
        return TrainState(params, opt), metrics

    return step


def make_compressed_dp_grads(model: Model, mesh, dp_axes: tuple[str, ...]):
    """Explicit data parallelism with an int8 + error-feedback gradient
    exchange over ``dp_axes`` (the reference's ``shard_map`` program).
    Returns ``grads_fn(batch, err) -> (grads, new_err, loss)``: the rank's
    rows of the global ``batch`` (split over ``dp_axes``), the gradients
    of the loss through :func:`optim.ef_roundtrip` (the mean over the
    ranks, in float32), the new error per leaf, and the loss averaged
    over the ranks. ``err`` is a ``{name: float32 tensor}`` of the
    parameters' shapes (zeros to start).

    ``model`` is a whole model on each rank (no ``mesh`` at build), so its
    parameters are replicated over ``dp_axes`` as the reference requires;
    a MoE routes the rank's rows, as each device of ``shard_map`` does.
    The reference's ``specs`` argument has no counterpart: a sharded
    model is refused.

    The reference compresses each leaf of its pytree with one scale, and
    its ``blocks`` and ``enc_blocks`` leaves hold every layer: so the
    port's per-layer gradients of one such leaf are stacked and
    compressed together, as one tensor with one scale."""
    from ..launch.sharding import reference_path
    from ..optim.compress import ef_roundtrip

    if getattr(model, "spmd", None) is not None:
        raise ValueError("make_compressed_dp_grads takes a whole (unsharded) model")
    comm = mesh.comm(dp_axes)
    leaves: dict[str, list[str]] = {}
    for name, _ in model.named_parameters():
        leaves.setdefault(reference_path(name), []).append(name)

    def grads_fn(batch: dict, err: dict):
        rows = {}
        for k, v in batch.items():
            if v.shape[0] % comm.size:
                raise ValueError(f"batch {k} of {v.shape[0]} rows on {comm.size} ranks")
            rows[k] = v.chunk(comm.size, 0)[comm.rank]
        loss, _, grads = loss_and_grads(model, rows, remat=True)
        out, new_err = {}, {}
        for names in leaves.values():
            if len(names) == 1:
                out[names[0]], new_err[names[0]] = ef_roundtrip(grads[names[0]], err[names[0]],
                                                                comm)
                continue
            mean, e = ef_roundtrip(torch.stack([grads[n] for n in names]),
                                   torch.stack([err[n] for n in names]), comm)
            out.update(zip(names, mean))
            new_err.update(zip(names, e))
        return out, new_err, comm.all_reduce(loss) / comm.size

    return grads_fn


def make_serve_step(model: Model, layout=None):
    """-> serve_step(caches, tokens, lengths) ->
    (next_tokens, logits, caches, lengths). On a mesh with more than one
    data rank, ``layout`` is the caches' (``Model.decode_step``)."""

    def serve_step(caches, tokens, lengths):
        logits, caches = model.decode_step(caches, tokens, lengths, layout)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt, logits, caches, lengths + 1

    return serve_step


def make_prefill_step(model: Model, max_len: int):
    def prefill_step(inputs):
        logits, caches = model.prefill(inputs, max_len)
        return logits, caches

    return prefill_step
