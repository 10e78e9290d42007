"""What a finished chunk keeps: the release of its outputs.

The Manager releases a stage instance's outputs once it and every stage
instance linked to it by dependencies (in a replicated workflow, the
other stages of its chunk) have completed, and none of them is pending,
leased or twinned: no lease can read them again. It then keeps of each
op's output only the result, on the host (:func:`result_of`), and each
in-process worker drops every reference it holds to those op outputs
(``WorkerRuntime.release_ops``): its host tier, its lanes' device
memory, its chained maps. A remote worker (a ``WorkerProxy``) keeps its
own copies, as before.

An op's result is what its :class:`~.workflow.Operation` names in
``outputs`` (the WSI workflow names them in ``app/pipeline.py``), and
every value that is not a tensor: a number or a numpy array is a result
already. Every other tensor goes.

A result tensor on the card has a host copy started by the op that made
it, inside the blocking read that ends the op (:class:`HostCopies`), so
the release reads nothing from the card. Every ``gpu`` op ends with a
synchronize of its device, so a released tensor has no pending use on
any stream: the caching allocator re-uses its block in stream order.
"""

from __future__ import annotations

from concurrent.futures import Future
from typing import Any, Iterable, Optional

import torch

__all__ = ["HostCopies", "result_of", "tensor_bytes"]


class HostCopies(dict):
    """An op's output state with ``host``: host copies of its result
    tensors, started before the op ended (key -> numpy array, or a
    Future of one still being written). It crosses a wire as the state
    alone."""

    __slots__ = ("host",)

    def __init__(self, state: dict, host: dict[str, Any]) -> None:
        super().__init__(state)
        self.host = host

    def __reduce__(self):
        return dict, (dict(self),)


def _on_host(t: torch.Tensor) -> Any:
    """A tensor result on the host, as a numpy array. A CUDA tensor
    without a host copy is read here, blocking."""
    return t.detach().cpu().numpy()


def result_of(op, value: Any) -> Optional[Any]:
    """What a released output of ``op`` keeps, or None for nothing: a
    state dict keeps its non-tensor values and the tensors ``op.outputs``
    names, on the host; a tensor is kept, on the host, where ``op`` names
    any output; anything else is kept as it is."""
    if isinstance(value, dict):
        host = getattr(value, "host", {})
        kept = {}
        for key, v in value.items():
            if not isinstance(v, torch.Tensor):
                kept[key] = v
            elif key in op.outputs:
                copy = host.get(key)
                if isinstance(copy, Future):
                    copy = copy.result()
                kept[key] = _on_host(v) if copy is None else copy
        return kept or None
    if isinstance(value, torch.Tensor):
        return _on_host(value) if op.outputs else None
    return value


def tensor_bytes(values: Iterable[Any]) -> int:
    """Bytes of the distinct tensor storages inside ``values`` (dicts,
    lists and tuples walked): what dropping them frees."""
    seen: set[tuple[str, int]] = set()
    total = 0
    stack = list(values)
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            storage = v.untyped_storage()
            key = (str(v.device), storage.data_ptr())
            if key not in seen:
                seen.add(key)
                total += storage.nbytes()
        elif isinstance(v, dict):
            stack.extend(v.values())
        elif isinstance(v, (list, tuple)):
            stack.extend(v)
    return total
