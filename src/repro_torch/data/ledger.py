"""Chunk lease ledger — demand-driven, fault-tolerant, serializable.

The Manager side of the data plane.  Chunks are identified by integer
ids; workers lease blocks of ids, heartbeat while processing, and
commit completions.  Expired leases return to the queue (chunk
generation is idempotent, so re-execution is safe).  The full ledger
state serializes into the training checkpoint so a restart resumes
mid-epoch without repeating or skipping data.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional

__all__ = ["Lease", "ChunkLedger"]


@dataclass
class Lease:
    worker: int
    chunks: list[int]
    issued_at: float = field(default_factory=time.monotonic)
    heartbeat: float = field(default_factory=time.monotonic)


class ChunkLedger:
    def __init__(self, n_chunks: int, lease_timeout: float = 30.0):
        self.n_chunks = n_chunks
        self.lease_timeout = lease_timeout
        self._lock = threading.Lock()
        self._next = 0
        self._returned: list[int] = []
        self._completed: set[int] = set()
        self._leases: dict[int, Lease] = {}   # worker -> active lease
        self.releases = 0

    # -- worker API ---------------------------------------------------------

    def lease(self, worker: int, n: int) -> list[int]:
        """Lease up to ``n`` chunk ids (demand-driven)."""
        with self._lock:
            self._reap_locked()
            ids: list[int] = []
            while len(ids) < n and self._returned:
                ids.append(self._returned.pop(0))
            while len(ids) < n and self._next < self.n_chunks:
                ids.append(self._next)
                self._next += 1
            if ids:
                # Store a copy: the caller iterates the returned list
                # while commit() mutates the lease's copy.
                self._leases[worker] = Lease(worker=worker, chunks=list(ids))
            return ids

    def heartbeat(self, worker: int) -> None:
        with self._lock:
            if worker in self._leases:
                self._leases[worker].heartbeat = time.monotonic()

    def commit(self, worker: int, chunk_id: int) -> None:
        with self._lock:
            self._completed.add(chunk_id)
            lease = self._leases.get(worker)
            if lease is not None:
                if chunk_id in lease.chunks:
                    lease.chunks.remove(chunk_id)
                lease.heartbeat = time.monotonic()
                if not lease.chunks:
                    del self._leases[worker]

    def worker_lost(self, worker: int) -> None:
        """Explicit failure notification (elastic scale-down)."""
        with self._lock:
            self._release_locked(worker)

    # -- bookkeeping -------------------------------------------------------------

    def _release_locked(self, worker: int) -> None:
        lease = self._leases.pop(worker, None)
        if lease is not None:
            pending = [c for c in lease.chunks if c not in self._completed]
            self._returned.extend(pending)
            self.releases += len(pending)

    def _reap_locked(self) -> None:
        now = time.monotonic()
        dead = [
            w
            for w, l in self._leases.items()
            if now - l.heartbeat > self.lease_timeout
        ]
        for w in dead:
            self._release_locked(w)

    def done(self) -> bool:
        with self._lock:
            return (
                len(self._completed) >= self.n_chunks
                and not self._returned
                and not self._leases
            )

    def progress(self) -> tuple[int, int]:
        with self._lock:
            return len(self._completed), self.n_chunks

    # -- checkpointing -----------------------------------------------------------

    def state_dict(self) -> dict:
        with self._lock:
            inflight = [
                c
                for l in self._leases.values()
                for c in l.chunks
                if c not in self._completed
            ]
            return {
                "n_chunks": self.n_chunks,
                "next": self._next,
                "returned": sorted(self._returned + inflight),
                "completed": sorted(self._completed),
            }

    @classmethod
    def from_state(cls, state: dict, lease_timeout: float = 30.0) -> "ChunkLedger":
        led = cls(state["n_chunks"], lease_timeout)
        led._next = state["next"]
        led._returned = list(state["returned"])
        led._completed = set(state["completed"])
        return led
