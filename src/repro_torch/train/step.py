"""Serve / prefill step builders (the port of ``repro/train/step.py``'s
``make_serve_step`` and ``make_prefill_step``; the optimiser and the
train step come in the training slice). The model holds its
parameters, so the steps take none."""

from __future__ import annotations

import torch

from ..models.model import Model

__all__ = ["make_serve_step", "make_prefill_step"]


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
