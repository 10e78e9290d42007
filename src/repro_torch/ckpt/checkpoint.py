"""Sharded, asynchronous, atomic checkpointing.

The port of ``repro/ckpt/checkpoint.py``, with the reference's layout
and commit order: ``<dir>/step_<n>/shard_<i>.pt`` + ``manifest.json``;
the shard is written to a ``.tmp`` file and renamed, and the manifest
is written *last* (atomic rename), so a partially-written checkpoint is
never restored; ``keep`` bounds the committed steps kept.
``AsyncCheckpointer`` snapshots the state to host memory (blocking only
for the copy) and writes behind on a thread.

The reference packs its shard with msgpack and zstandard, which this
port does not need: a shard here is a ``torch.save`` of the tree's
leaves as CPU tensors (bfloat16 included) in tree order, under its own
magic string. A tree is nested dicts (keys in insertion order), lists,
tuples and NamedTuples (``TrainState``, ``OptState``) over tensors,
numpy arrays and numbers. A checkpoint also carries the data-ledger
state (in the manifest's ``meta``) so a restart resumes mid-epoch.
"""

from __future__ import annotations

import json
import os
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step", "AsyncCheckpointer",
           "tree_leaves", "tree_unflatten", "to_host"]

_MAGIC = "repro-torch-ckpt-v1"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree`` in order (dict values in key order)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(template: Any, leaves: list) -> Any:
    """``template``'s structure with its leaves replaced, in order, by ``leaves``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if _is_namedtuple(node):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def _to_cpu(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return torch.as_tensor(np.array(x))


def to_host(tree: Any) -> Any:
    """A snapshot of ``tree`` with every leaf a CPU tensor copy."""
    return tree_unflatten(tree, [_to_cpu(x) for x in tree_leaves(tree)])


def save_checkpoint(
    directory: str | os.PathLike,
    step: int,
    tree: Any,
    *,
    meta: Optional[dict] = None,
    shard_id: int = 0,
    n_shards: int = 1,
    keep: int = 3,
) -> Path:
    d = Path(directory) / f"step_{step:08d}"
    d.mkdir(parents=True, exist_ok=True)
    leaves = [_to_cpu(x) for x in tree_leaves(tree)]
    shard = d / f"shard_{shard_id:05d}.pt"
    tmp = shard.with_suffix(".tmp")
    torch.save({"magic": _MAGIC, "leaves": leaves}, tmp)
    tmp.rename(shard)
    if shard_id == 0:  # coordinator commits the manifest last
        manifest = {
            "magic": _MAGIC,
            "step": step,
            "n_shards": n_shards,
            "meta": meta or {},
        }
        mtmp = d / "manifest.tmp"
        mtmp.write_text(json.dumps(manifest))
        mtmp.rename(d / "manifest.json")
        _gc(Path(directory), keep)
    return d


def _gc(root: Path, keep: int) -> None:
    steps = sorted(
        (p for p in root.glob("step_*") if (p / "manifest.json").exists()),
        key=lambda p: p.name,
    )
    for p in steps[:-keep]:
        for f in p.iterdir():
            f.unlink()
        p.rmdir()


def latest_step(directory: str | os.PathLike) -> Optional[int]:
    root = Path(directory)
    if not root.exists():
        return None
    steps = [
        int(p.name.split("_")[1])
        for p in root.glob("step_*")
        if (p / "manifest.json").exists()
    ]
    return max(steps) if steps else None


def load_checkpoint(
    directory: str | os.PathLike,
    template: Any,
    *,
    step: Optional[int] = None,
    shard_id: int = 0,
) -> tuple[Any, dict]:
    """Restore into the structure of ``template`` (validates shapes);
    the leaves come back as CPU tensors."""
    root = Path(directory)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
    d = root / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    if manifest.get("magic") != _MAGIC:
        raise ValueError("unrecognized checkpoint format")
    blob = torch.load(d / f"shard_{shard_id:05d}.pt", map_location="cpu", weights_only=True)
    if blob.get("magic") != _MAGIC:
        raise ValueError("unrecognized checkpoint shard")
    leaves = blob["leaves"]
    t_leaves = tree_leaves(template)
    if len(leaves) != len(t_leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, template {len(t_leaves)}"
        )
    for got, want in zip(leaves, t_leaves):
        if tuple(got.shape) != tuple(np.shape(want)):
            raise ValueError(
                f"shape mismatch: ckpt {tuple(got.shape)} vs template {tuple(np.shape(want))}"
            )
    return tree_unflatten(template, leaves), manifest


class AsyncCheckpointer:
    """Write-behind checkpointing: snapshot now, serialize on a thread."""

    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_saved: Optional[int] = None
        self.errors: list[str] = []

    def save(self, step: int, tree: Any, meta: Optional[dict] = None) -> None:
        self.wait()  # one outstanding write at a time
        host_tree = to_host(tree)  # snapshot (synchronous copy)

        def work() -> None:
            try:
                save_checkpoint(
                    self.directory, step, host_tree, meta=meta, keep=self.keep
                )
                self.last_saved = step
            except Exception as e:  # noqa: BLE001
                self.errors.append(f"step {step}: {e}")

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
