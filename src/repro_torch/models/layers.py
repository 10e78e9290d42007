"""Shared model layers: norms, RoPE, activations, initializers.

The port of ``repro/models/layers.py``. Norms compute in float32 and
return the input's dtype; RoPE rotates split halves in float32. The
initializers draw from an explicit ``torch.Generator`` (a JAX key and a
torch generator give different numbers from one seed, so the tests
carry weights across with :func:`repro_torch.models.convert.params_from_jax`).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = [
    "Params",
    "dense_init",
    "embed_init",
    "rmsnorm",
    "layernorm",
    "init_norm",
    "apply_norm",
    "rope_freqs",
    "apply_rope",
    "gelu",
    "swish",
]

COMPUTE_DTYPE = torch.bfloat16

#: Weights the reference casts to the activation type where it uses them
#: (matmul weights, biases, embedding, head). Stored in bfloat16 once:
#: the cast gives the same values.
BF16_WEIGHTS = frozenset({
    "wq", "wk", "wv", "wo", "bq", "bk", "bv",
    "w_up", "w_gate", "w_down", "in_proj", "out_proj", "embed", "head",
})


class Params(nn.Module):
    """A parameter tree that reads like the reference's pytree
    (``p["attn"]["wq"]``, ``"bq" in p``). Dicts become nested
    ``Params``, lists ``nn.ModuleList``s, tensors parameters, in one of
    two storages chosen when the tree is built:

    * serving (``trainable=False``): frozen parameters, stored in
      bfloat16 where the name is in :data:`BF16_WEIGHTS`;
    * training (``trainable=True``): float32 masters with
      ``requires_grad``, as the reference keeps every leaf; the layers
      cast the matmul weights to the activation type where they use
      them, as the reference does (``.astype(x.dtype)``).
    """

    def __init__(self, tree: dict | None = None, trainable: bool = False):
        super().__init__()
        self.trainable = trainable
        for key, value in (tree or {}).items():
            self[key] = value

    def __setitem__(self, key: str, value) -> None:
        if isinstance(value, dict):
            self.add_module(key, Params(value, self.trainable))
        elif isinstance(value, (list, tuple)):
            self.add_module(key, nn.ModuleList(Params(v, self.trainable) for v in value))
        elif self.trainable:
            self.register_parameter(key, nn.Parameter(value.float(), requires_grad=True))
        else:
            t = value.to(COMPUTE_DTYPE) if key in BF16_WEIGHTS else value.float()
            self.register_parameter(key, nn.Parameter(t, requires_grad=False))

    def __getitem__(self, key: str):
        if key in self._parameters:
            return self._parameters[key]
        if key in self._modules:
            return self._modules[key]
        raise KeyError(key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules


def dense_init(gen: torch.Generator, shape, fan_in: int | None = None,
               device=None) -> torch.Tensor:
    fan = fan_in if fan_in is not None else shape[0]
    scale = 1.0 / math.sqrt(max(fan, 1))
    return torch.randn(shape, generator=gen, device=device) * scale


def embed_init(gen: torch.Generator, vocab: int, d: int, device=None) -> torch.Tensor:
    return torch.randn((vocab, d), generator=gen, device=device) * 0.02


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * w.float() + b.float()).to(dt)


def init_norm(kind: str, d: int, device=None) -> dict[str, torch.Tensor]:
    if kind == "rmsnorm":
        return {"w": torch.ones(d, device=device)}
    return {"w": torch.ones(d, device=device), "b": torch.zeros(d, device=device)}


def apply_norm(kind: str, p, x: torch.Tensor, eps: float) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p["w"], eps)
    return layernorm(x, p["w"], p["b"], eps)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, head_dim); positions: (S,) or broadcastable (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)            # (hd/2,)
    ang = positions[..., :, None].float() * freqs             # (..., S, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rot.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def swish(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` with the logistic spelled ``1 / (1 + exp(-x))``,
    each step rounded to x's dtype: that is how XLA expands the
    reference's ``jax.nn.sigmoid`` for bfloat16, and ``torch.sigmoid``
    rounds a third of bfloat16 inputs to the neighbouring value."""
    return x * (1 / (1 + torch.exp(-x)))
