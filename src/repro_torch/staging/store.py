"""Content-addressed hierarchical region store.

A *region* is any named blob the runtime moves around: an operation
instance's output, a staged input batch, a tile read from the global
store.  Regions are addressed by structured keys —

* ``("op", uid)``      — output of operation instance ``uid``;
* ``("chunk", cid)``   — materialized input chunk ``cid``;
* ``("blob", digest)`` — true content address (see :func:`content_key`).

The store stacks :mod:`~repro.staging.tiers` fastest-first and provides
the two primitives everything else builds on:

* ``put`` into a chosen tier, demoting evicted entries down the stack;
* ``get`` searching top-down, optionally *promoting* the hit so the
  next access is faster (the paper's reuse-conscious hierarchy).
"""

from __future__ import annotations

import hashlib
import pickle
import threading
from typing import Any, Callable, Optional, Sequence

from .tiers import RegionKey, Tier, sizeof

__all__ = ["RegionStore", "op_key", "chunk_key", "content_key"]


def op_key(uid: int) -> RegionKey:
    """Key for the output of operation instance ``uid``."""
    return ("op", uid)


def chunk_key(chunk_id: int) -> RegionKey:
    """Key for a materialized input data chunk."""
    return ("chunk", chunk_id)


def content_key(value: Any) -> RegionKey:
    """True content address: sha1 over the pickled payload."""
    digest = hashlib.sha1(
        pickle.dumps(value, protocol=pickle.HIGHEST_PROTOCOL)
    ).hexdigest()
    return ("blob", digest)


class RegionStore:
    """Ordered stack of tiers with promote/demote movement."""

    def __init__(self, tiers: Sequence[Tier], *, demote: bool = True,
                 registry=None):
        from ..telemetry.metrics import MetricsRegistry

        if not tiers:
            raise ValueError("RegionStore needs at least one tier")
        names = [t.name for t in tiers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tier names: {names}")
        self.tiers = list(tiers)
        self.demote = demote
        self._lock = threading.RLock()
        # Movement counters (cluster benchmarks read these) — int-like
        # cells in the shared metrics registry.
        self.registry = registry or MetricsRegistry()
        self.promotions = self.registry.counter("store.promotions")
        self.demotions = self.registry.counter("store.demotions")
        self.promoted_bytes = self.registry.counter("store.promoted_bytes")
        self.demoted_bytes = self.registry.counter("store.demoted_bytes")
        # Regions destroyed because the bottom tier evicted them with
        # no deeper backstop — nonzero means tier budgets are too tight
        # for the unpinned working set (diagnostic, see stats()).
        self.dropped = self.registry.counter("store.dropped")
        # Fired when a region leaves this store entirely (fell off the
        # bottom tier).  The Manager wires it to PlacementDirectory.
        # evict so the directory's replica map — which feeds lease
        # placement and replication-aware eviction — never goes stale.
        self.on_drop: Optional[Callable[[RegionKey], None]] = None

    # -- tier lookup -------------------------------------------------------

    def tier(self, name: str) -> Tier:
        for t in self.tiers:
            if t.name == name:
                return t
        raise KeyError(f"no tier named {name!r}")

    def _tier_index(self, name: Optional[str]) -> int:
        if name is None:
            return 0
        for i, t in enumerate(self.tiers):
            if t.name == name:
                return i
        raise KeyError(f"no tier named {name!r}")

    # -- storage -----------------------------------------------------------

    def put(
        self,
        key: RegionKey,
        value: Any,
        *,
        tier: Optional[str] = None,
        nbytes: Optional[int] = None,
    ) -> int:
        """Store ``key`` in ``tier`` (default: fastest); returns nbytes.

        Entries the target tier evicts cascade down the stack (RAM spills
        to disk, disk drops — the global tier is never evicted into from
        a drop whose payload is gone).
        """
        nbytes = sizeof(value) if nbytes is None else nbytes
        with self._lock:
            i = self._tier_index(tier)
            evicted = self.tiers[i].put(key, value, nbytes)
            self._demote_from(i, evicted)
        return nbytes

    def _demote_from(self, i: int, evicted: list) -> None:
        if not self.demote:
            return
        nxt = i + 1
        if nxt >= len(self.tiers):
            for k, v, _ in evicted:
                if v is None:
                    continue
                self.dropped += 1
                if self.on_drop is not None:
                    try:
                        self.on_drop(k)
                    except Exception:  # noqa: BLE001 - directory gone
                        pass
            return
        for k, v, n in evicted:
            if v is None:
                # Payload already gone (device memory / disk drop): the
                # region survives only where another tier holds it.
                continue
            self.demotions += 1
            self.demoted_bytes += n
            deeper = self.tiers[nxt].put(k, v, n)
            self._demote_from(nxt, deeper)

    def get(
        self, key: RegionKey, *, promote: bool = False, default: Any = None
    ) -> Any:
        """Top-down search; with ``promote`` the hit moves to the top tier."""
        with self._lock:
            for i, t in enumerate(self.tiers):
                try:
                    value = t.get(key)
                except KeyError:
                    continue
                if promote and i > 0:
                    self.promotions += 1
                    n = t.nbytes_of(key) if key in t else sizeof(value)
                    self.promoted_bytes += n
                    evicted = self.tiers[0].put(key, value, n)
                    self._demote_from(0, evicted)
                return value
            return default

    def where(self, key: RegionKey) -> Optional[str]:
        """Name of the fastest tier holding ``key`` (None if absent)."""
        with self._lock:
            for t in self.tiers:
                if key in t:
                    return t.name
            return None

    def nbytes_of(self, key: RegionKey) -> int:
        with self._lock:
            for t in self.tiers:
                if key in t:
                    return t.nbytes_of(key)
            raise KeyError(key)

    def discard(self, key: RegionKey) -> None:
        with self._lock:
            for t in self.tiers:
                t.discard(key)

    def pin(self, key: RegionKey) -> None:
        """Exempt ``key`` from eviction in every tier (live working set)."""
        with self._lock:
            for t in self.tiers:
                t.pin(key)

    def unpin(self, key: RegionKey) -> None:
        with self._lock:
            for t in self.tiers:
                t.unpin(key)

    def __contains__(self, key: RegionKey) -> bool:
        return self.where(key) is not None

    # -- maintenance (StagingAgent hooks) ----------------------------------

    def demote_excess(self, watermark: float = 0.9, batch: int = 8) -> int:
        """Push LRU entries of over-watermark tiers one level down.

        Called by the StagingAgent off the critical path.  The slow part
        — writing into the deeper tier (disk pickling) — runs *outside*
        the store-wide lock so lanes never stall behind a spill; the
        brief window where a moving key is in neither tier is handled by
        callers treating a miss as an eviction (Manager re-pull).
        """
        moved = 0
        for i, t in enumerate(self.tiers[:-1]):
            if not t.over_watermark(watermark):
                continue
            for k in t.lru_keys(batch):
                if t.is_pinned(k):
                    continue
                with self._lock:
                    try:
                        v = t.get(k)
                        n = t.nbytes_of(k)
                    except KeyError:
                        continue
                    t.discard(k)
                if v is None:
                    continue
                evicted = self.tiers[i + 1].put(k, v, n)
                with self._lock:
                    self.demotions += 1
                    self.demoted_bytes += n
                    self._demote_from(i + 1, evicted)
                moved += 1
        return moved

    def stats(self) -> dict[str, dict[str, int]]:
        out = {}
        for t in self.tiers:
            d = t.stats.as_dict()
            d["replicated_evictions"] = t.replicated_evictions
            out[t.name] = d
        out["store"] = {
            "promotions": int(self.promotions),
            "demotions": int(self.demotions),
            "promoted_bytes": int(self.promoted_bytes),
            "demoted_bytes": int(self.demoted_bytes),
            "dropped": int(self.dropped),
        }
        return out
