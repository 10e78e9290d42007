"""AdamW with decoupled weight decay, global-norm clipping, schedules.

The port of ``repro/optim/adamw.py``. Plain functions on tensors: the
parameters are a ``{name: tensor}`` dict (a model's
``named_parameters()``), the moments dicts of float32 tensors of the
same shapes. ``update`` follows the reference's arithmetic (global-norm
clip, float32 moments, bias correction, weight decay on every leaf, the
update in float32) and writes the new parameters into the given tensors
in place, under ``torch.no_grad`` (the reference returns new arrays;
in-place saves a copy of the model). The moments are updated in place
too. The clip scale, the step count and the learning rate stay on the
parameters' device: no host read per step. Not ``torch.optim.AdamW``,
whose clip and schedule differ.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

__all__ = ["AdamW", "OptState", "cosine_schedule", "global_norm"]

Params = dict[str, torch.Tensor]


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: Params
    nu: Params


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    leaves = [t.float() for t in tree.values()]
    if not leaves:
        return torch.zeros(())
    return torch.stack(torch._foreach_norm(leaves)).square().sum().sqrt()


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    floor: float = 0.1) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warm-up to ``peak_lr``, then a cosine down to
    ``floor * peak_lr`` at ``total_steps``; a function of the step tensor."""

    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = ((step - warmup_steps) / max(total_steps - warmup_steps, 1)).clamp(0, 1)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)

    return lr


def clip_scale(grads: Params, clip_norm: float) -> torch.Tensor:
    """``min(1, clip_norm / max(global_norm, 1e-9))`` as a device scalar."""
    gn = global_norm(grads)
    return (clip_norm / gn.clamp_min(1e-9)).clamp_max(1.0)


@dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params: Params) -> OptState:
        z = lambda: {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
                     for k, p in params.items()}
        dev = next(iter(params.values())).device if params else None
        return OptState(step=torch.zeros((), dtype=torch.int32, device=dev), mu=z(), nu=z())

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step)
        return torch.tensor(self.lr, dtype=torch.float32, device=step.device)

    @torch.no_grad()
    def update(self, grads: Params, state: OptState, params: Params) -> tuple[Params, OptState]:
        """-> (params, state): ``params`` updated in place and returned;
        ``grads`` are scaled in place (the caller's gradients are spent)."""
        keys = list(params)
        step = state.step + 1
        g = [grads[k] if grads[k].dtype == torch.float32 else grads[k].float() for k in keys]
        torch._foreach_mul_(g, clip_scale(grads, self.clip_norm))
        mu, nu = [state.mu[k] for k in keys], [state.nu[k] for k in keys]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - self.b2)
        t = step.float()
        bc1 = 1 - torch.pow(self.b1, t)
        bc2 = 1 - torch.pow(self.b2, t)
        lr = self._lr(step)
        p = [params[k] for k in keys]
        p32 = [x if x.dtype == torch.float32 else x.float() for x in p]
        denom = torch._foreach_div(nu, bc2)                     # vhat
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        delta = torch._foreach_div(mu, bc1)                     # mhat
        torch._foreach_div_(delta, denom)
        del denom
        torch._foreach_add_(delta, p32, alpha=self.weight_decay)
        torch._foreach_mul_(delta, lr)
        torch._foreach_sub_(p32, delta)
        for dst, src in zip(p, p32):
            if dst is not src:
                dst.copy_(src)
        return params, OptState(step=step, mu=state.mu, nu=state.nu)
