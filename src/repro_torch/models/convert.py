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

__all__ = ["params_from_jax", "stacked_in_reference", "STACKED_GROUPS"]

_CARRIED = ("embed", "head", "final_norm", "shared", "enc_norm")
#: Groups the reference stacks into one leaf per name, with a leading layer dim.
STACKED_GROUPS = ("blocks", "enc_blocks")


def stacked_in_reference(name: str) -> bool:
    """Whether the port's parameter ``name`` (``blocks.3.attn.wq``) is one
    layer of a leaf that the reference stacks over its layers."""
    return name.split(".", 1)[0] in STACKED_GROUPS


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
    stacked = dict(zip(STACKED_GROUPS, (cfg.n_layers, cfg.encoder_layers)))
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
