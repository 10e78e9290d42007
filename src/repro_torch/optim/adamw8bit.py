"""AdamW with row-wise int8-quantized moment state.

The port of ``repro/optim/adamw8bit.py``: the float32 Adam moments are
kept as int8 codes of the parameter's own shape with one float32 scale
per leading-dim row (per element for a 1-D leaf), about 1 byte
per parameter per moment instead of 4. The reference's ``blocks`` and
``enc_blocks`` leaves hold every layer, their leading dim the layer's:
so a port parameter of those groups (one layer) has one scale, of shape
``(1,) * ndim``, as the reference's row of that layer. The update dequantizes, steps
in float32 and requantizes, leaf by leaf, with the reference's
arithmetic; the parameters are updated in place. On a mesh
(``shards``, see ``optim/adamw.py``) a row's scale is the maximum over
the ranks that split the row's other dims, so a chunk's codes are those
of the whole tensor; the scales are laid out by the leading dim only.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from ..models.convert import stacked_in_reference
from .adamw import clip_scale

__all__ = ["AdamW8bit", "Opt8State", "quantize_blockwise", "dequantize_blockwise"]

Params = dict[str, torch.Tensor]


def quantize_blockwise(x: torch.Tensor, row_max=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-wise symmetric int8: codes keep x's shape; one float32 scale
    per leading-dim row. A scalar has one scale; a 1-D leaf one per
    element, as the reference's maximum over no axes gives. ``row_max``
    maps the chunk's row maxima to the whole tensor's (on a mesh)."""
    x = x.float()
    dims = tuple(range(1, x.dim()))
    amax = x.abs().amax(dim=dims, keepdim=True) if dims else x.abs()
    if row_max is not None:
        amax = row_max(amax)
    scale = amax / 127.0 + 1e-20
    codes = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return codes, scale.float()


def _quantize(name: str, x: torch.Tensor, row_max=None):
    """Parameter ``name``'s codes and scales: one row per layer for a
    layer of a group the reference stacks."""
    if not stacked_in_reference(name):
        return quantize_blockwise(x, row_max)
    codes, scale = quantize_blockwise(x[None], row_max)
    return codes[0], scale[0]


def dequantize_blockwise(codes: torch.Tensor, scale: torch.Tensor,
                         shape: tuple[int, ...] | None = None) -> torch.Tensor:
    del shape  # codes already carry the shape
    return codes.float() * scale


class Opt8State(NamedTuple):
    step: torch.Tensor
    mu_q: Params   # int8 codes
    mu_s: Params   # float32 scales
    nu_q: Params
    nu_s: Params


@dataclass(frozen=True)
class AdamW8bit:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params: Params) -> Opt8State:
        q = {k: _quantize(k, torch.zeros(p.shape, dtype=torch.float32, device=p.device))
             for k, p in params.items()}
        dev = next(iter(params.values())).device if params else None
        return Opt8State(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            mu_q={k: c for k, (c, _) in q.items()}, mu_s={k: s for k, (_, s) in q.items()},
            nu_q={k: c.clone() for k, (c, _) in q.items()},
            nu_s={k: s.clone() for k, (_, s) in q.items()},
        )

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step)
        return torch.tensor(self.lr, dtype=torch.float32, device=step.device)

    @torch.no_grad()
    def update(self, grads: Params, state: Opt8State, params: Params, shards=None):
        step = state.step + 1
        scale = clip_scale(grads, self.clip_norm, shards)
        t = step.float()
        bc1 = 1 - torch.pow(self.b1, t)
        bc2 = 1 - torch.pow(self.b2, t)
        lr = self._lr(step)
        new = Opt8State(step, {}, {}, {}, {})
        for k, p in params.items():
            g = grads[k].float() * scale
            mu = dequantize_blockwise(state.mu_q[k], state.mu_s[k])
            nu = dequantize_blockwise(state.nu_q[k], state.nu_s[k])
            mu = self.b1 * mu + (1 - self.b1) * g
            nu = self.b2 * nu + (1 - self.b2) * g * g
            delta = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            delta = delta + self.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
            row_max = None if shards is None else functools.partial(shards.row_max, k)
            new.mu_q[k], new.mu_s[k] = _quantize(k, mu, row_max)
            new.nu_q[k], new.nu_s[k] = _quantize(k, nu, row_max)
        return params, new
