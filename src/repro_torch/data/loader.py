"""Chunk sources + double-buffered prefetching loader.

The port of ``repro/data/loader.py``. ``TokenChunkSource`` is the
reference's, unchanged (numpy, the same tokens from the same seed).
``PrefetchLoader``'s default ``device_put`` replaces
``jax.device_put``: a chunk's arrays are pinned and copied to the card
with ``non_blocking`` on a side stream, so the copy of the next batch
overlaps the current step. The loader records an event on the side
stream behind each batch; before a batch reaches the consumer, the
consumer's current stream waits on that event, and each tensor of the
batch is marked with ``record_stream`` so that the allocator does not
hand its memory to the side stream while the step still reads it. The
``RegionStore`` staging path is the reference's.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from ..app._device import resolve_device
from ..staging import RegionStore, chunk_key
from .ledger import ChunkLedger

__all__ = ["TokenChunkSource", "PrefetchLoader", "CardPut"]


class TokenChunkSource:
    """Deterministic synthetic LM token chunks.

    chunk_id -> (chunk_tokens, seq_len+1) int32, a pure function of
    (seed, chunk_id): leases are idempotent and re-executable after a
    worker failure, which is what makes the ledger's re-lease safe.
    """

    def __init__(self, vocab: int, seq_len: int, batch_per_chunk: int,
                 seed: int = 0):
        self.vocab = vocab
        self.seq_len = seq_len
        self.batch_per_chunk = batch_per_chunk
        self.seed = seed

    def __call__(self, chunk_id: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.uint64(self.seed) * np.uint64(0x9E3779B9) + np.uint64(chunk_id)
        )
        # Zipfian-ish token stream (more realistic routing/MoE behavior
        # than uniform; deterministic per chunk).
        z = rng.zipf(1.3, size=(self.batch_per_chunk, self.seq_len + 1))
        return (z % self.vocab).astype(np.int32)


class CardPut:
    """``device_put`` onto a card: each array of a dict is pinned and
    copied with ``non_blocking`` on this object's side stream.
    :meth:`ready` records an event behind everything copied so far."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)

    def __call__(self, tree: dict) -> dict:
        with torch.cuda.stream(self.stream):
            return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                    .to(self.device, non_blocking=True) for k, v in tree.items()}

    def ready(self) -> torch.cuda.Event:
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return ev


def _host_put(tree: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in tree.items()}


class PrefetchLoader:
    """Leases chunks, materializes batches, keeps ``depth`` batches
    device-ready ahead of the consumer (double buffering by default).

    ``device_put`` defaults to a :class:`CardPut` on ``device`` (the
    card unless the caller asks for ``"cpu"``, where batches become CPU
    tensors; a CUDA device without a card raises).

    With a ``store`` (hierarchical RegionStore), materialized batches
    are also staged into the host tier under ``chunk_key(cid)``: a
    re-leased chunk (worker failure, epoch replay) is served from the
    tier hierarchy instead of re-materialized, and other components
    (StagingAgent, checkpoint writer) can find the staged bytes.
    """

    def __init__(
        self,
        ledger: ChunkLedger,
        source: Callable[[int], np.ndarray],
        *,
        worker: int = 0,
        lease_block: int = 8,
        depth: int = 2,
        device_put: Optional[Callable[[Any], Any]] = None,
        store: Optional[RegionStore] = None,
        device: Any = "cuda",
    ):
        self.ledger = ledger
        self.source = source
        self.worker = worker
        self.lease_block = lease_block
        self.depth = depth
        if device_put is None:
            dev = resolve_device(device)
            device_put = CardPut(dev) if dev.type == "cuda" else _host_put
        self.device_put = device_put
        self.store = store
        self.store_hits = 0
        self.staged_chunks = 0
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=depth)
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self.chunks_seen: list[int] = []

    def _materialize(self, cid: int) -> Any:
        if self.store is not None:
            batch = self.store.get(chunk_key(cid), promote=True)
            if batch is not None:
                self.store_hits += 1
                return batch
        arr = self.source(cid)
        batch = self.device_put({"tokens": arr})
        if self.store is not None:
            self.store.put(chunk_key(cid), batch)
            self.staged_chunks += 1
        return batch

    def _ready(self) -> Optional[torch.cuda.Event]:
        return self.device_put.ready() if isinstance(self.device_put, CardPut) else None

    def _fill(self) -> None:
        while not self._stop:
            ids = self.ledger.lease(self.worker, self.lease_block)
            if not ids:
                self._q.put(None)  # epoch exhausted
                return
            for cid in ids:
                if self._stop:
                    return
                batch = self._materialize(cid)
                self._q.put((cid, batch, self._ready()))  # blocks when depth ahead
                self.ledger.heartbeat(self.worker)

    def __iter__(self) -> Iterator[tuple[int, Any]]:
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()
        while True:
            item = self._q.get()
            if item is None:
                return
            cid, batch, ready = item
            if ready is not None:  # the step's stream waits for the side-stream copy
                stream = torch.cuda.current_stream(self.device_put.device)
                stream.wait_event(ready)
                for t in batch.values():
                    t.record_stream(stream)
            self.chunks_seen.append(cid)
            yield cid, batch

    def commit(self, chunk_id: int) -> None:
        self.ledger.commit(self.worker, chunk_id)

    def stop(self) -> None:
        self._stop = True
        if self._thread is not None:
            while not self._q.empty():
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    break
            self._thread.join(timeout=2.0)
