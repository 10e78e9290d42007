"""Per-worker staging agent: async promote/demote + batched prefetch.

The paper overlaps data movement with computation (§IV-D, upload /
process / download pipeline).  The StagingAgent generalizes that from
one accelerator lane to the whole storage hierarchy of a worker:

* **prefetch** — the worker enqueues the input keys of stage instances
  it has *leased but not started*; the agent pulls any that are missing
  from the fetch source (global tier / remote worker) into the host
  tier on a background thread, so lanes find them RAM-resident;
* **batched pulls** — queued keys are coalesced and fetched through
  ``fetch_batch`` as one transport round-trip (mirroring micro-batched
  dispatch: amortize the per-call latency over the batch); per-key
  ``fetch`` remains the fallback when no batch source is wired;
* **direct dial (coordinator bypass)** — with ``resolve``/``dial``
  wired, missing keys are resolved to sibling holders through a cached
  directory lookup and the region bytes are pulled worker-to-worker;
  the Manager relay (``fetch``/``fetch_batch``) remains the fallback
  when the holder is unknown, stale, or dead.  The holder cache is
  invalidation-correct: ``invalidate_holder`` (driven by the Manager's
  ``region_drop`` broadcast) guarantees a direct dial never targets a
  holder that spilled the region without at worst one wasted dial;
* **expected pushes** — the Manager may predict that a sibling will
  *push* a key here (predictive push of sink outputs); ``expect_push``
  defers the pull for a grace period so the push and the pull don't
  race the same bytes across the wire, with the pull re-arming as the
  backstop when the push never lands;
* **promote** — a requested key sitting in a slow tier (disk) is moved
  up ahead of use;
* **demote** — when the host tier crosses its high-water mark, LRU
  regions spill one level down off the critical path, so lane threads
  rarely block on synchronous eviction.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Optional, Sequence

from .store import RegionStore
from .tiers import RegionKey, sizeof

__all__ = ["StagingAgent"]

FetchFn = Callable[[RegionKey], Any]
#: Batched pull: ordered keys in, same-length ordered values out
#: (None per miss); returning None means "no batch source, fall back".
FetchBatchFn = Callable[[Sequence[RegionKey]], Optional[Sequence[Any]]]
#: Holder lookup for the direct data plane: ordered keys in, same-length
#: ``(worker_id, bus_address)`` (or None per unknown key) out; returning
#: None means the lookup itself failed (coordinator unreachable).
ResolveFn = Callable[[Sequence[RegionKey]], Optional[Sequence[Any]]]
#: Peer dial: ``dial(holder, keys)`` pulls the keys straight from the
#: sibling ``holder = (worker_id, address)``; None = holder unreachable.
DialFn = Callable[[Any, Sequence[RegionKey]], Optional[Sequence[Any]]]


class StagingAgent:
    def __init__(
        self,
        store: RegionStore,
        *,
        worker_id: int = 0,
        fetch: Optional[FetchFn] = None,
        fetch_batch: Optional[FetchBatchFn] = None,
        resolve: Optional[ResolveFn] = None,
        dial: Optional[DialFn] = None,
        max_batch: int = 16,
        on_staged: Optional[Callable[[RegionKey, int], None]] = None,
        watermark: float = 0.9,
        interval: float = 0.002,
        push_grace: float = 0.25,
        registry=None,
    ) -> None:
        from ..telemetry.metrics import MetricsRegistry

        self.store = store
        self.worker_id = worker_id
        self.fetch = fetch
        self.fetch_batch = fetch_batch
        # Coordinator-bypass data plane (wired by a transport
        # WorkerClient): resolve holders, dial the sibling directly.
        self.resolve = resolve
        self.dial = dial
        self.push_grace = push_grace
        self.max_batch = max(int(max_batch), 1)
        self.on_staged = on_staged  # e.g. PlacementDirectory.record
        self.watermark = watermark
        # Idle wake-up only matters when some tier can actually demote;
        # with all tiers unbounded, poll rarely (requests still wake the
        # thread immediately via the queue).
        bounded = any(t.budget_bytes is not None for t in store.tiers)
        self.interval = interval if bounded else max(interval, 0.25)
        self._requests: "queue.Queue[Optional[RegionKey]]" = queue.Queue()
        self._inflight: set[RegionKey] = set()
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        # Directory cache for the direct path: key -> (worker_id, addr).
        # Entries die on region_drop/eviction notifies (invalidate_*) or
        # when a dial comes back empty/dead — never silently trusted.
        self._holders: dict[RegionKey, tuple] = {}
        # Keys a sibling was predicted to push here: key -> deadline.
        # The pull is deferred until the deadline so push and pull don't
        # move the same bytes twice; overdue keys re-enter the queue.
        self._deferred: dict[RegionKey, float] = {}
        # Counters read by benchmarks / tests — int-like cells in the
        # shared metrics registry (`stats()` stays the thin int view).
        self.registry = registry or MetricsRegistry()
        c = lambda name: self.registry.counter(f"staging.{name}")  # noqa: E731
        self.prefetched = c("prefetched")
        self.prefetched_bytes = c("prefetched_bytes")
        self.already_resident = c("already_resident")
        self.fetch_misses = c("fetch_misses")
        self.demote_moves = c("demote_moves")
        self.fetch_calls = c("fetch_calls")      # round-trips actually paid
        self.batched_keys = c("batched_keys")    # keys on a coalesced pull
        self.fetch_errors = c("fetch_errors")    # pulls that raised
        self.direct_keys = c("direct_keys")      # keys served worker-to-worker
        self.direct_bytes = c("direct_bytes")
        self.direct_misses = c("direct_misses")  # stale holder: region gone
        self.relay_keys = c("relay_keys")        # fell back to the Manager
        self.relay_bytes = c("relay_bytes")
        self.holder_invalidations = c("holder_invalidations")
        self.pushes_expected = c("pushes_expected")
        self.pushes_landed = c("pushes_landed")  # pushes arrived in time

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop = False
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"staging-agent-{self.worker_id}",
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop = True
        self._requests.put(None)
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    # -- worker API --------------------------------------------------------

    def request_prefetch(self, keys) -> None:
        """Ask for ``keys`` to be host-resident soon (idempotent)."""
        with self._lock:
            for key in keys:
                if key in self._inflight:
                    continue
                self._inflight.add(key)
                self._requests.put(key)

    def stage_now(self, key: RegionKey) -> bool:
        """Synchronous fallback: a lane needs ``key`` immediately."""
        return self._stage(key)

    def expect_push(self, keys) -> None:
        """A sibling is predicted to push ``keys`` here: defer their
        pull for ``push_grace`` seconds so the push and the prefetch
        don't race the same bytes.  Overdue keys pull normally — the
        grace period bounds the stall when a push is lost."""
        deadline = time.monotonic() + self.push_grace
        n = 0
        with self._lock:
            for key in keys:
                if key in self._inflight:
                    continue
                self._inflight.add(key)
                self._deferred[key] = deadline
                n += 1
        self.pushes_expected += n

    def invalidate_holder(
        self, key: RegionKey, worker_id: Optional[int] = None
    ) -> None:
        """Region ``key`` left ``worker_id``'s tiers (drop/eviction
        notify): forget the cached holder so a direct dial never fetches
        from a sibling that spilled the region."""
        with self._lock:
            h = self._holders.get(key)
            if h is not None and (worker_id is None or h[0] == worker_id):
                del self._holders[key]
                self.holder_invalidations += 1

    def invalidate_worker(self, worker_id: int) -> None:
        """Worker died/left: every cached holder entry naming it is gone."""
        with self._lock:
            stale = [
                k for k, h in self._holders.items() if h[0] == worker_id
            ]
            for k in stale:
                del self._holders[k]
            self.holder_invalidations += len(stale)

    # -- internals ---------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop:
            # With pushes pending, poll fast enough that an overdue
            # (lost) push degrades to a pull within ~one grace period.
            timeout = self.interval
            if self._deferred:
                timeout = min(timeout, max(self.push_grace / 4.0, 0.01))
            try:
                key = self._requests.get(timeout=timeout)
            except queue.Empty:
                self._check_deferred()
                self.demote_moves += self.store.demote_excess(self.watermark)
                continue
            if key is None:
                return
            # Coalesce whatever else is already queued into one batch:
            # one transport round-trip serves every key waiting now.
            keys = [key]
            while len(keys) < self.max_batch:
                try:
                    nxt = self._requests.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    self._stop = True
                    break
                keys.append(nxt)
            try:
                self._stage_batch(keys)
            except Exception:  # noqa: BLE001 - transport hiccup, not fatal
                # A fetch source over a bus raises on timeouts/restarts
                # (e.g. Manager failover).  The prefetch thread must
                # survive: the keys count as misses and the lanes'
                # synchronous re-pull path remains the backstop.
                self.fetch_errors += 1
                self.fetch_misses += len(keys)
            finally:
                with self._lock:
                    for k in keys:
                        self._inflight.discard(k)
            self._check_deferred()

    def _check_deferred(self) -> None:
        """Resolve expected pushes: landed keys leave the inflight set,
        overdue keys re-enter the queue as ordinary pulls."""
        if not self._deferred:
            return
        now = time.monotonic()
        due: list[RegionKey] = []
        with self._lock:
            for k, deadline in list(self._deferred.items()):
                if self.store.where(k) is not None:
                    del self._deferred[k]
                    self._inflight.discard(k)
                    self.pushes_landed += 1
                elif now >= deadline:
                    del self._deferred[k]
                    due.append(k)  # stays inflight: queued for a pull
        for k in due:
            self._requests.put(k)

    def _local_hit(self, key: RegionKey) -> bool:
        """Serve ``key`` from a local tier if present (promote slow hits)."""
        where = self.store.where(key)
        if where is None:
            return False
        if where == self.store.tiers[0].name:
            self.already_resident += 1
        else:
            # Promote from a slow tier ahead of use.
            self.store.get(key, promote=True)
            self.prefetched += 1
        # on_staged fires on *every* success path: a region found in
        # a lower tier (e.g. the shared global store) is just as
        # newly-available to the consumer as a fetched one.
        if self.on_staged is not None:
            self.on_staged(key, 0)
        return True

    def _land(self, key: RegionKey, value: Any) -> int:
        nbytes = sizeof(value)
        self.store.put(key, value, tier=self.store.tiers[0].name, nbytes=nbytes)
        self.prefetched += 1
        self.prefetched_bytes += nbytes
        if self.on_staged is not None:
            self.on_staged(key, nbytes)
        return nbytes

    def _stage_batch(self, keys: list[RegionKey]) -> None:
        missing = [k for k in keys if not self._local_hit(k)]
        if not missing:
            return
        if self.dial is not None:
            # Coordinator bypass: pull straight from sibling holders;
            # whatever stays unresolved falls through to the relay.
            missing = self._direct_stage(missing)
            if not missing:
                return
        values = None
        if self.fetch_batch is not None:
            values = self.fetch_batch(missing)
            if values is not None:
                self.fetch_calls += 1
                self.batched_keys += len(missing)
        if values is not None:
            for k, v in zip(missing, values):
                if v is None:
                    self.fetch_misses += 1
                else:
                    self.relay_keys += 1
                    self.relay_bytes += self._land(k, v)
            return
        for k in missing:  # no batch source wired: per-key round-trips
            self._fetch_one(k)

    def _direct_stage(self, missing: list[RegionKey]) -> list[RegionKey]:
        """Worker-to-worker pull of ``missing``; returns the keys the
        direct path could not serve (unknown/stale/dead holder)."""
        holders: dict[RegionKey, tuple] = {}
        with self._lock:
            for k in missing:
                h = self._holders.get(k)
                if h is not None:
                    holders[k] = h
        unknown = [k for k in missing if k not in holders]
        if unknown and self.resolve is not None:
            try:
                resolved = self.resolve(unknown)
            except Exception:  # noqa: BLE001 - coordinator unreachable
                resolved = None
                self.fetch_errors += 1
            if resolved is not None:
                with self._lock:
                    for k, h in zip(unknown, resolved):
                        if h is not None:
                            h = (h[0], h[1])
                            holders[k] = h
                            self._holders[k] = h
        leftover = [k for k in missing if k not in holders]
        groups: dict[tuple, list[RegionKey]] = {}
        for k in missing:
            if k in holders:
                groups.setdefault(holders[k], []).append(k)
        for holder, hkeys in groups.items():
            try:
                values = self.dial(holder, hkeys)
            except Exception:  # noqa: BLE001 - peer dropped mid-pull
                values = None
                self.fetch_errors += 1
            if values is None:  # dead holder: forget it, use the relay
                self._forget_holder(holder[0], hkeys)
                leftover.extend(hkeys)
                continue
            self.fetch_calls += 1
            if len(hkeys) > 1:
                self.batched_keys += len(hkeys)
            for k, v in zip(hkeys, values):
                if v is None:
                    # Stale holder (spilled between notify and dial).
                    self.direct_misses += 1
                    self._forget_holder(holder[0], [k])
                    leftover.append(k)
                else:
                    self.direct_keys += 1
                    self.direct_bytes += self._land(k, v)
        return leftover

    def _forget_holder(self, worker_id: int, keys) -> None:
        with self._lock:
            for k in keys:
                h = self._holders.get(k)
                if h is not None and h[0] == worker_id:
                    del self._holders[k]

    def _stage(self, key: RegionKey) -> bool:
        if self._local_hit(key):
            return True
        if self.dial is not None and not self._direct_stage([key]):
            return True
        return self._fetch_one(key)

    def _fetch_one(self, key: RegionKey) -> bool:
        if self.fetch is None:
            self.fetch_misses += 1
            return False
        self.fetch_calls += 1
        value = self.fetch(key)
        if value is None:
            self.fetch_misses += 1
            return False
        self.relay_keys += 1
        self.relay_bytes += self._land(key, value)
        return True

    def stats(self) -> dict[str, int]:
        # Thin view over the registry cells, coerced to plain ints:
        # this dict rides the `get_stats` RPC.
        return {
            "prefetched": int(self.prefetched),
            "prefetched_bytes": int(self.prefetched_bytes),
            "already_resident": int(self.already_resident),
            "fetch_misses": int(self.fetch_misses),
            "demote_moves": int(self.demote_moves),
            "fetch_calls": int(self.fetch_calls),
            "batched_keys": int(self.batched_keys),
            "fetch_errors": int(self.fetch_errors),
            "direct_keys": int(self.direct_keys),
            "direct_bytes": int(self.direct_bytes),
            "direct_misses": int(self.direct_misses),
            "relay_keys": int(self.relay_keys),
            "relay_bytes": int(self.relay_bytes),
            "holder_invalidations": int(self.holder_invalidations),
            "pushes_expected": int(self.pushes_expected),
            "pushes_landed": int(self.pushes_landed),
        }
