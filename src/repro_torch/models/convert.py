"""Carry the reference's parameters into the port.

``params_from_jax(tree, cfg)`` turns the JAX parameter pytree of
``repro.models`` (given as numpy arrays, e.g. after
``jax.tree.map(np.asarray, params)``) into a state dict for the port's
:class:`~repro_torch.models.model.Model`: the layer-stacked ``blocks``
become one entry per layer (``blocks.{i}.…``), and ``shared``,
``embed``, ``head`` and ``final_norm`` carry over by path. With it,
both packages compute the same function in the tests. Nothing here
imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ArchConfig
from .transformer import PORTED_FAMILIES

__all__ = ["params_from_jax"]

_CARRIED = ("embed", "head", "final_norm", "shared")


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _flatten(prefix: str, node, out: dict, index: int | None = None) -> None:
    if isinstance(node, dict):
        for key, sub in node.items():
            _flatten(f"{prefix}.{key}", sub, out, index)
    else:
        out[prefix] = _tensor(node if index is None else np.asarray(node)[index])


def params_from_jax(tree: dict, cfg: ArchConfig) -> dict[str, torch.Tensor]:
    """State dict of the port's model from the reference's pytree."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    out: dict[str, torch.Tensor] = {}
    for key, node in tree.items():
        if key == "blocks":
            for i in range(cfg.n_layers):
                _flatten(f"blocks.{i}", node, out, index=i)
        elif key in _CARRIED:
            if isinstance(node, dict):
                _flatten(key, node, out)
            else:
                out[key] = _tensor(node)
        else:
            raise NotImplementedError(f"parameter group {key!r} is not ported yet")
    return out
