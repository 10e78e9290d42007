"""Host/device helpers of the port's WSI application.

Every blocking read of the card by the host inside an op goes through
:func:`host_sync`: a fixpoint's test, an ``int`` of a count, a download
(:func:`to_host`), an upload from pageable memory (:func:`to_device`),
``bincount`` (which reads its input's maximum) and the synchronize that
ends a ``gpu`` op. :data:`SYNCS` counts them by site, traced or not.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Any, Callable, TypeVar

import numpy as np
import torch

from ..telemetry.lanes import current_op

__all__ = ["SYNCS", "alloc_counts", "host_sync", "resolve_device", "to_device", "to_host"]

T = TypeVar("T")

#: Blocking device-to-host reads by site (:func:`host_sync`). Reset by
#: ``SYNCS.clear()``.
SYNCS: Counter = Counter()

#: The caching allocator's counts read across a traced op, by the name
#: its ``lane:between`` span carries them under.
ALLOC_KEYS = {"allocs": "num_device_alloc", "frees": "num_device_free",
              "retries": "num_alloc_retries"}


def host_sync(site: str, read: Callable[..., T], *args: Any, **kwargs: Any) -> T:
    """``read(*args, **kwargs)``, a read that blocks the host until the
    card has caught up: counted in ``SYNCS[site]``, and a ``sync`` span
    (``args.site``) of the op this thread runs where it is traced. Under
    ``torch.cuda.set_sync_debug_mode`` the read alone runs with the mode
    off, so that one bypassing this helper still warns or raises."""
    SYNCS[site] += 1
    op = current_op()
    mode = torch.cuda.get_sync_debug_mode() if torch.cuda.is_initialized() else 0
    if mode:
        torch.cuda.set_sync_debug_mode(0)
    ts, t0 = time.time(), time.perf_counter()
    try:
        return read(*args, **kwargs)
    finally:
        if op is not None:
            op.span("sync", ts, time.perf_counter() - t0, site=site)
        if mode:
            torch.cuda.set_sync_debug_mode(mode)


def alloc_counts(device: torch.device) -> dict[str, int]:
    """The caching allocator's running counts on ``device`` (those of
    :data:`ALLOC_KEYS` this build of torch keeps). The nested form: the
    flat ``torch.cuda.memory_stats`` costs ~8x as much (125 us a call on
    an H100's host)."""
    stats = torch.cuda.memory_stats_as_nested_dict(device)
    return {name: int(stats[key]) for name, key in ALLOC_KEYS.items() if key in stats}


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
        return x if x.device == device else host_sync("move", x.to, device)
    return host_sync("upload", torch.as_tensor, np.asarray(x), device=device)


def to_host(x: Any) -> Any:
    """Tensors (on any device) as numpy arrays; anything else as is."""
    if isinstance(x, torch.Tensor):
        return host_sync("to_host", _download, x)
    return x


def _download(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()
