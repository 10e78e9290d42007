"""Pluggable storage tiers of the hierarchical region store.

Each tier is a bounded key/value container with LRU discipline and
byte accounting.  The :class:`~repro.staging.store.RegionStore` stacks
tiers fastest-first (device -> host RAM -> local disk -> global store)
and moves regions between them; a tier itself only knows how to hold
data and report what it evicted so the store can demote it.

Tiers never raise on overflow — ``put`` returns the evicted entries —
so a caller can always write and let the hierarchy absorb the spill.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import sys
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Hashable, Iterable, Optional

__all__ = [
    "TierStats",
    "Tier",
    "DeviceTier",
    "HostTier",
    "DiskTier",
    "GlobalTier",
    "sizeof",
]

RegionKey = Hashable


def sizeof(value: Any) -> int:
    """Best-effort byte size of a region payload.

    Understands numpy-like arrays (``nbytes``), containers (recursive),
    and falls back to ``sys.getsizeof``.  Used for tier budgets and the
    placement directory, so only *relative* accuracy matters.
    """
    nbytes = getattr(value, "nbytes", None)
    if isinstance(nbytes, (int, float)):
        return int(nbytes)
    if isinstance(value, dict):
        return sum(sizeof(v) for v in value.values()) or sys.getsizeof(value)
    if isinstance(value, (list, tuple, set, frozenset)):
        return sum(sizeof(v) for v in value) or sys.getsizeof(value)
    if isinstance(value, (bytes, bytearray, memoryview)):
        return len(value)
    try:
        return sys.getsizeof(value)
    except TypeError:  # pragma: no cover - exotic objects
        return 64


@dataclass
class TierStats:
    """Per-tier traffic counters (mirrors SchedulerStats reporting)."""

    puts: int = 0
    gets: int = 0
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    bytes_in: int = 0
    bytes_out: int = 0

    def as_dict(self) -> dict[str, int]:
        return {
            "puts": self.puts,
            "gets": self.gets,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "bytes_in": self.bytes_in,
            "bytes_out": self.bytes_out,
        }


class Tier:
    """LRU key/value tier with a byte budget (``None`` = unbounded)."""

    name = "tier"

    def __init__(self, budget_bytes: Optional[int] = None, name: str | None = None):
        if name is not None:
            self.name = name
        self.budget_bytes = budget_bytes
        self.stats = TierStats()
        self._lock = threading.RLock()
        self._entries: "OrderedDict[RegionKey, tuple[Any, int]]" = OrderedDict()
        self._bytes = 0
        # Pinned keys are never evicted (live working set): the byte
        # budget is a soft cap while consumers are outstanding.
        self._pinned: set[RegionKey] = set()
        # Replication-aware eviction (PlacementPolicy knob): when set
        # (the Manager wires it to PlacementDirectory.replicated_
        # elsewhere), keys whose bytes exist on another worker — or are
        # re-creatable from the global tier — are evicted before sole
        # copies, so budget pressure sheds redundancy first.
        self.replicated: Optional[Callable[[RegionKey], bool]] = None
        self.replicated_evictions = 0

    # -- capacity ----------------------------------------------------------

    @property
    def used_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def over_watermark(self, fraction: float = 0.9) -> bool:
        if self.budget_bytes is None:
            return False
        with self._lock:
            return self._bytes > self.budget_bytes * fraction

    # -- storage -----------------------------------------------------------

    def put(
        self, key: RegionKey, value: Any, nbytes: int | None = None
    ) -> list[tuple[RegionKey, Any, int]]:
        """Insert/refresh ``key``; return entries evicted to make room."""
        nbytes = sizeof(value) if nbytes is None else nbytes
        evicted: list[tuple[RegionKey, Any, int]] = []
        with self._lock:
            if key in self._entries:
                _, old = self._entries.pop(key)
                self._bytes -= old
            self._write(key, value, nbytes)
            self._entries[key] = (self._retain(value), nbytes)
            self._bytes += nbytes
            self.stats.puts += 1
            self.stats.bytes_in += nbytes
            if self.budget_bytes is not None and self._bytes > self.budget_bytes:
                # LRU order with replicated-elsewhere keys first,
                # skipping the new entry and pinned keys.  The victim
                # scan (one ``replicated`` directory probe per entry)
                # only runs once actually over budget.
                for k, repl in self._victim_order(key):
                    if self._bytes <= self.budget_bytes:
                        break
                    v, n = self._entries.pop(k)
                    self._bytes -= n
                    self._erase(k)
                    self.stats.evictions += 1
                    self.stats.bytes_out += n
                    if repl:
                        self.replicated_evictions += 1
                    evicted.append((k, v, n))
        return evicted

    def _victim_order(self, protect: RegionKey):
        """Eviction candidates, oldest-first; with a ``replicated``
        predicate wired, redundant replicas go before sole copies.

        Lazy generator over a snapshot: when freeing the oldest one or
        two replicated entries suffices, only that many directory
        probes are paid (the full scan only happens when eviction must
        fall back to sole copies).
        """
        candidates = [
            k for k in self._entries if k != protect and k not in self._pinned
        ]
        if self.replicated is None:
            for k in candidates:
                yield k, False
            return
        sole: list[RegionKey] = []
        for k in candidates:
            try:
                repl = bool(self.replicated(k))
            except Exception:  # noqa: BLE001 - directory gone: plain LRU
                repl = False
            if repl:
                yield k, True
            else:
                sole.append(k)
        for k in sole:
            yield k, False

    def pin(self, key: RegionKey) -> None:
        with self._lock:
            self._pinned.add(key)

    def unpin(self, key: RegionKey) -> None:
        with self._lock:
            self._pinned.discard(key)

    def is_pinned(self, key: RegionKey) -> bool:
        with self._lock:
            return key in self._pinned

    def get(self, key: RegionKey) -> Any:
        with self._lock:
            self.stats.gets += 1
            if key not in self._entries:
                self.stats.misses += 1
                raise KeyError(key)
            self._entries.move_to_end(key)
            self.stats.hits += 1
            value, nbytes = self._entries[key]
            return self._read(key, value)

    def discard(self, key: RegionKey) -> bool:
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is None:
                return False
            self._bytes -= entry[1]
            self._erase(key)
            return True

    def nbytes_of(self, key: RegionKey) -> int:
        with self._lock:
            return self._entries[key][1]

    def lru_keys(self, n: int) -> list[RegionKey]:
        """Oldest ``n`` keys — demotion candidates for the StagingAgent."""
        with self._lock:
            return list(self._entries)[:n]

    def __contains__(self, key: RegionKey) -> bool:
        with self._lock:
            return key in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def keys(self) -> list[RegionKey]:
        with self._lock:
            return list(self._entries)

    # -- backend hooks (in-memory by default) ------------------------------

    def _retain(self, value: Any) -> Any:
        """What to keep referenced in RAM; backed tiers return None so
        spilling actually frees memory."""
        return value

    def _write(self, key: RegionKey, value: Any, nbytes: int) -> None:
        pass

    def _read(self, key: RegionKey, value: Any) -> Any:
        return value

    def _erase(self, key: RegionKey) -> None:
        pass


class HostTier(Tier):
    """Host-RAM LRU with a byte budget — the worker's staging heart."""

    name = "host"


class DeviceTier(Tier):
    """Adapter presenting a lane's :class:`DeviceMemory` as a tier.

    The wrapped memory stays the source of truth (the worker's locality
    scheduler reads ``resident_uids`` from it); the tier only adds byte
    accounting and the uniform put/get/evict protocol.  Slot-based LRU
    eviction is delegated to the DeviceMemory itself.
    """

    name = "device"

    def __init__(self, memory: Any, name: str | None = None):
        super().__init__(budget_bytes=None, name=name)
        self.memory = memory

    def put(
        self, key: RegionKey, value: Any, nbytes: int | None = None
    ) -> list[tuple[RegionKey, Any, int]]:
        nbytes = sizeof(value) if nbytes is None else nbytes
        with self._lock:
            before = self.memory.resident_uids()
            self.memory.put(key, value)
            after = self.memory.resident_uids()
            self.stats.puts += 1
            self.stats.bytes_in += nbytes
            self._entries[key] = (None, nbytes)  # bookkeeping only
            evicted = []
            for k in before - after:
                entry = self._entries.pop(k, (None, 0))
                self.stats.evictions += 1
                self.stats.bytes_out += entry[1]
                evicted.append((k, None, entry[1]))
            self._bytes = sum(n for _, n in self._entries.values())
        return evicted

    def get(self, key: RegionKey) -> Any:
        with self._lock:
            self.stats.gets += 1
            if key not in self.memory:
                self.stats.misses += 1
                raise KeyError(key)
            self.stats.hits += 1
            return self.memory.get(key)

    def discard(self, key: RegionKey) -> bool:
        with self._lock:
            self._entries.pop(key, None)
            store = getattr(self.memory, "_store", None)
            if store is not None and key in store:
                del store[key]
                return True
            return False

    def __contains__(self, key: RegionKey) -> bool:
        return key in self.memory


class DiskTier(Tier):
    """Spill directory: regions pickled to local disk, LRU by budget.

    Payloads are NOT kept referenced in RAM (``_retain`` returns None):
    spilling host->disk genuinely frees memory, and every ``get`` is a
    real read-back.  Entries the disk tier itself evicts are gone from
    this node — the store re-reads them from the global tier (or the
    runtime re-executes the chunk).
    """

    name = "disk"

    def __init__(self, directory: str, budget_bytes: Optional[int] = None):
        super().__init__(budget_bytes=budget_bytes)
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _retain(self, value: Any) -> Any:
        return None

    def _path(self, key: RegionKey) -> str:
        # Content-address of the *key*: stable across processes (unlike
        # hash()) and collision-resistant, so a spill directory can be
        # inspected or reused between runs.
        digest = hashlib.sha1(repr(key).encode()).hexdigest()[:24]
        return os.path.join(self.directory, f"region-{digest}.pkl")

    def _write(self, key: RegionKey, value: Any, nbytes: int) -> None:
        with open(self._path(key), "wb") as f:
            pickle.dump(value, f, protocol=pickle.HIGHEST_PROTOCOL)

    def _read(self, key: RegionKey, value: Any) -> Any:
        with open(self._path(key), "rb") as f:
            return pickle.load(f)

    def _erase(self, key: RegionKey) -> None:
        try:
            os.remove(self._path(key))
        except OSError:
            pass


class GlobalTier(Tier):
    """Cluster-global store (models the shared parallel filesystem).

    One instance is shared by every worker's RegionStore in-process; on
    a real deployment this is the Lustre/GPFS-backed object store and
    the tier is a thin client.  Unbounded by default — it is the tier
    of last resort, so dropping from it would lose data.
    """

    name = "global"


def drain(entries: Iterable[tuple[RegionKey, Any, int]]) -> int:
    """Sum the byte sizes of evicted-entry tuples (helper for stats)."""
    return sum(n for _, _, n in entries)
