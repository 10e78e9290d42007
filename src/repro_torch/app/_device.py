"""Host/device helpers of the port's WSI application."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["resolve_device", "to_device", "to_host"]


def resolve_device(device: Any = "cuda") -> torch.device:
    """``torch.device`` with an explicit index; a CUDA device on a
    machine without a card raises (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() is False"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def to_device(x: Any, device: torch.device) -> torch.Tensor:
    """``x`` as a tensor on ``device``: numpy arrays are uploaded,
    tensors elsewhere are moved, tensors already there pass through."""
    if isinstance(x, torch.Tensor):
        return x if x.device == device else x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def to_host(x: Any) -> Any:
    """Tensors (on any device) as numpy arrays; anything else as is."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x
