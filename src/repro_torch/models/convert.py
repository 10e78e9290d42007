"""Carry the reference's parameters into the port.

``params_from_jax(tree, cfg)`` turns the JAX parameter pytree of
``repro.models`` (given as numpy arrays, e.g. after
``jax.tree.map(np.asarray, params)``) into a state dict for the port's
:class:`~repro_torch.models.model.Model`: the layer-stacked ``blocks``
and ``enc_blocks`` become one entry per layer (``blocks.{i}.…``, with a
MoE block's ``moe`` and arctic's ``mlp``, and whisper's ``ln_x`` and
``xattn``), xLSTM's ``xl_blocks`` (a list of per-layer trees in the
reference, with its ``kind_slstm`` tag leaf) carry over per entry, and
``shared``, ``embed``, ``head``, ``final_norm`` and ``enc_norm`` by
path. With it, both packages compute the same function in the tests.
Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ArchConfig

__all__ = ["params_from_jax"]

_CARRIED = ("embed", "head", "final_norm", "shared", "enc_norm")


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
    stacked = {"blocks": cfg.n_layers, "enc_blocks": cfg.encoder_layers}
    out: dict[str, torch.Tensor] = {}
    for key, node in tree.items():
        if key in stacked:
            for i in range(stacked[key]):
                _flatten(f"{key}.{i}", node, out, index=i)
        elif key == "xl_blocks":
            for i, blk in enumerate(node):
                _flatten(f"{key}.{i}", blk, out)
        elif key in _CARRIED:
            if isinstance(node, dict):
                _flatten(key, node, out)
            else:
                out[key] = _tensor(node)
        else:
            raise ValueError(f"unknown parameter group {key!r}")
    return out
