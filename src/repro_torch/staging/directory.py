"""Cluster-wide placement directory: which worker holds which region.

The Manager's view of the storage hierarchy.  Workers (or the Manager
on their behalf) record region placements as stages complete and
evictions happen; the dispatch loop then asks "who already holds the
inputs of this stage instance?" and leases accordingly — converting the
per-node data-locality of ``core/scheduling.py`` into *cluster-level*
locality-aware lease placement.

The directory is deliberately metadata-only (key -> {worker: bytes});
it never touches payloads, so the same class serves the threaded
runtime, the discrete-event simulator, and — behind a distributed
transport — a real multi-node deployment (ROADMAP open item).
"""

from __future__ import annotations

import threading
from typing import Any, Iterable, Optional

from .tiers import RegionKey

__all__ = ["PlacementDirectory"]


class PlacementDirectory:
    """Thread-safe region -> {worker_id: nbytes} map."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._placement: dict[RegionKey, dict[int, int]] = {}
        # Worker-to-worker data plane: each worker's bus address, so a
        # holder lookup can be answered with a dialable peer instead of
        # relaying the region bytes through the coordinator.
        self._addresses: dict[int, Any] = {}
        # Network topology identity: worker -> rack (leaf switch).  A
        # replica on a same-rack sibling is one intra-rack hop away —
        # no oversubscribed uplink on the path — so placement scoring
        # can weight it above a cross-rack replica (rack_affinity).
        self._racks: dict[int, Any] = {}
        self.records = 0
        self.evictions = 0

    # -- updates -----------------------------------------------------------

    def set_address(self, worker_id: int, address: Any) -> None:
        """Record worker ``worker_id``'s bus address (peer-dial target)."""
        with self._lock:
            self._addresses[int(worker_id)] = address

    def set_rack(self, worker_id: int, rack: Any) -> None:
        """Record worker ``worker_id``'s rack (None = no topology)."""
        with self._lock:
            if rack is None:
                self._racks.pop(int(worker_id), None)
            else:
                self._racks[int(worker_id)] = rack

    def rack_of(self, worker_id: int) -> Any:
        with self._lock:
            return self._racks.get(worker_id)

    def racks(self) -> dict[int, Any]:
        with self._lock:
            return dict(self._racks)

    def address_of(self, worker_id: int) -> Any:
        with self._lock:
            return self._addresses.get(worker_id)

    def addresses(self) -> dict[int, Any]:
        with self._lock:
            return dict(self._addresses)

    def record(self, worker_id: int, key: RegionKey, nbytes: int) -> None:
        """Worker ``worker_id`` now holds ``key`` (``nbytes`` big)."""
        with self._lock:
            self._placement.setdefault(key, {})[worker_id] = nbytes
            self.records += 1

    def evict(self, worker_id: int, key: RegionKey) -> None:
        """Worker dropped its replica of ``key``."""
        with self._lock:
            holders = self._placement.get(key)
            if holders and holders.pop(worker_id, None) is not None:
                self.evictions += 1
                if not holders:
                    del self._placement[key]

    def drop_worker(self, worker_id: int) -> None:
        """Worker left/died: all of its replicas (and address) are gone."""
        with self._lock:
            self._addresses.pop(worker_id, None)
            self._racks.pop(worker_id, None)
            for key in list(self._placement):
                self.evict(worker_id, key)

    # -- queries -----------------------------------------------------------

    def holders(self, key: RegionKey) -> dict[int, int]:
        with self._lock:
            return dict(self._placement.get(key, {}))

    def replicated_elsewhere(self, worker_id: int, key: RegionKey) -> bool:
        """True when another worker also holds ``key`` — dropping the
        local replica then loses no data (replication-aware eviction)."""
        with self._lock:
            holders = self._placement.get(key)
            if not holders:
                return False
            return any(w != worker_id for w in holders)

    def bytes_on(self, worker_id: int, keys: Iterable[RegionKey]) -> int:
        """Bytes of ``keys`` already resident on ``worker_id``."""
        with self._lock:
            return sum(
                self._placement.get(k, {}).get(worker_id, 0) for k in keys
            )

    def total_bytes(self, keys: Iterable[RegionKey]) -> int:
        """Bytes of ``keys`` recorded anywhere (max replica per key)."""
        with self._lock:
            total = 0
            for k in keys:
                holders = self._placement.get(k)
                if holders:
                    total += max(holders.values())
            return total

    def local_fraction(
        self, worker_id: int, keys: Iterable[RegionKey]
    ) -> float:
        """Fraction of the recorded input bytes resident on ``worker_id``."""
        keys = list(keys)
        with self._lock:
            total = self.total_bytes(keys)
            if total <= 0:
                return 0.0
            return self.bytes_on(worker_id, keys) / total

    def rack_fraction(
        self, worker_id: int, keys: Iterable[RegionKey]
    ) -> float:
        """Fraction of the recorded input bytes held by OTHER workers
        in ``worker_id``'s rack (per key, the largest same-rack
        replica counts — never more than the key's own share)."""
        keys = list(keys)
        with self._lock:
            rack = self._racks.get(worker_id)
            if rack is None:
                return 0.0
            total = self.total_bytes(keys)
            if total <= 0:
                return 0.0
            near = 0
            for k in keys:
                holders = self._placement.get(k, {})
                near += max(
                    (
                        n
                        for w, n in holders.items()
                        if w != worker_id and self._racks.get(w) == rack
                    ),
                    default=0,
                )
            return min(near / total, 1.0)

    def placement_score(
        self,
        worker_id: int,
        keys: Iterable[RegionKey],
        rack_affinity: float = 0.0,
    ) -> float:
        """Locality score of leasing work over ``keys`` to ``worker_id``:
        the local byte fraction, plus a rack-locality bonus — bytes a
        same-rack sibling holds count at ``rack_affinity`` weight,
        because pulling them never crosses an oversubscribed uplink."""
        keys = list(keys)
        score = self.local_fraction(worker_id, keys)
        if rack_affinity > 0.0:
            score += rack_affinity * self.rack_fraction(worker_id, keys)
        return score

    def best_worker(
        self, keys: Iterable[RegionKey]
    ) -> Optional[tuple[int, float]]:
        """Worker holding the largest fraction of ``keys``' bytes.

        Returns ``(worker_id, fraction)`` or None when nothing about
        these keys has been recorded yet.
        """
        keys = list(keys)
        with self._lock:
            per_worker: dict[int, int] = {}
            for k in keys:
                for w, n in self._placement.get(k, {}).items():
                    per_worker[w] = per_worker.get(w, 0) + n
            if not per_worker:
                return None
            total = self.total_bytes(keys)
            if total <= 0:
                return None
            w = max(per_worker, key=lambda x: (per_worker[x], -x))
            return w, per_worker[w] / total

    def __len__(self) -> int:
        with self._lock:
            return len(self._placement)
