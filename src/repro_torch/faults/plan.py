"""Seeded, declarative fault schedule.

A :class:`FaultPlan` owns one ``random.Random`` and every probabilistic
decision (drop this notify? corrupt this payload?) draws from it under a
lock, so a given seed reproduces the same fault schedule for the same
message sequence.  Time-triggered faults (kills, partitions) are
expressed relative to :meth:`start`, which the harness calls when the
run under test begins.

The plan is pure policy: it never touches a socket or a thread.  The
enforcement points are :class:`repro.faults.bus.FaultyBus` (wire
faults), :meth:`op_hook` (worker faults via the generic
``WorkerRuntime.on_op_start`` seam), and :meth:`wrap_fetch` /
:meth:`wrap_dial` (staging-layer faults via the agent's pluggable
callables).
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

try:  # pragma: no cover - numpy is present in the toolchain image
    import numpy as np
except Exception:  # pragma: no cover
    np = None  # type: ignore[assignment]
import torch

# Methods that carry CRC-sealed region bytes; corruption only ever
# targets these, so every injected flip is one the integrity layer is
# contractually able to catch (the singular ``pull_region`` relay path
# is unsealed and deliberately out of scope).
DATA_METHODS = frozenset({"push_region", "pull_regions"})


@dataclass
class _Kill:
    match: str
    at: float
    fired: bool = False


@dataclass
class _Partition:
    match: str
    t_start: float
    t_end: float


@dataclass
class FaultPlan:
    """Declarative fault schedule driven by one seeded RNG.

    Rates are independent per-message probabilities in ``[0, 1]``.
    ``immune`` methods are never faulted (used to keep e.g. the
    shutdown path deterministic in tests).
    """

    seed: int = 0
    drop_notify: float = 0.0
    dup_notify: float = 0.0
    delay_notify: float = 0.0
    delay_s: float = 0.005
    fail_call: float = 0.0
    corrupt_rate: float = 0.0
    immune: frozenset = frozenset({"stop", "shutdown"})

    _rng: random.Random = field(init=False, repr=False)
    _lock: threading.Lock = field(init=False, repr=False)
    _t0: Optional[float] = field(default=None, init=False, repr=False)
    _kills: list = field(default_factory=list, init=False, repr=False)
    _partitions: list = field(default_factory=list, init=False, repr=False)

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()

    # -- schedule -----------------------------------------------------
    def start(self) -> "FaultPlan":
        """Mark the epoch for time-triggered faults (idempotent)."""
        with self._lock:
            if self._t0 is None:
                self._t0 = time.monotonic()
        return self

    def now(self) -> float:
        with self._lock:
            return 0.0 if self._t0 is None else time.monotonic() - self._t0

    def kill_at(self, name_match: str, t: float) -> "FaultPlan":
        """Kill (close) any peer whose name contains ``name_match`` at t."""
        self._kills.append(_Kill(name_match, t))
        return self

    def partition(self, name_match: str, t_start: float,
                  t_end: float = float("inf")) -> "FaultPlan":
        """Blackhole peers whose name contains ``name_match`` in [t_start, t_end)."""
        self._partitions.append(_Partition(name_match, t_start, t_end))
        return self

    # -- queries (called by FaultyPeer on every message) --------------
    def kill_due(self, peer_name: str) -> bool:
        """True exactly once per matching kill whose time has come."""
        if not self._kills:
            return False
        now = self.now()
        with self._lock:
            for k in self._kills:
                if not k.fired and k.match in peer_name and now >= k.at:
                    k.fired = True
                    return True
        return False

    def partitioned(self, peer_name: str) -> bool:
        if not self._partitions:
            return False
        now = self.now()
        return any(p.match in peer_name and p.t_start <= now < p.t_end
                   for p in self._partitions)

    def _roll(self, rate: float) -> bool:
        if rate <= 0.0:
            return False
        with self._lock:
            return self._rng.random() < rate

    def should_drop(self, method: str) -> bool:
        return method not in self.immune and self._roll(self.drop_notify)

    def should_dup(self, method: str) -> bool:
        return method not in self.immune and self._roll(self.dup_notify)

    def delay_for(self, method: str) -> float:
        if method in self.immune or not self._roll(self.delay_notify):
            return 0.0
        with self._lock:
            return self.delay_s * (0.5 + self._rng.random())

    def should_fail_call(self, method: str) -> bool:
        return method not in self.immune and self._roll(self.fail_call)

    # -- corruption ---------------------------------------------------
    def maybe_corrupt(self, method: str, obj: Any) -> Any:
        """With probability ``corrupt_rate``, flip a byte in the first
        ndarray found inside ``obj`` (on a copy).  Only data-plane
        methods are eligible, so CRC-sealed payloads are corrupted
        *after* sealing — exactly the in-transit corruption the
        integrity layer exists to catch."""
        if method not in DATA_METHODS or not self._roll(self.corrupt_rate):
            return obj
        corrupted, out = _corrupt_first_array(obj, self._rng, self._lock)
        return out if corrupted else obj

    # -- time-windowed degradation (gray failures) --------------------
    def slow_window_factor(self, slow_between: Optional[tuple]) -> float:
        """Multiplier for a ``slow_between=(t0, t1, factor)`` window.

        Returns ``factor`` while ``t0 <= now < t1`` (relative to
        :meth:`start`), else 1.0 — a gray failure that onsets at
        ``t0`` and *heals* at ``t1``, unlike a crash.
        """
        if slow_between is None:
            return 1.0
        t0, t1, factor = slow_between
        return float(factor) if t0 <= self.now() < t1 else 1.0

    # -- worker / staging seams ---------------------------------------
    def op_hook(self, *, poison_chunks: tuple = (), crash_worker_at_op: Optional[dict] = None,
                slow_factor: float = 0.0, slow_between: Optional[tuple] = None,
                slow_workers: Optional[tuple] = None) -> Callable[[Any], None]:
        """Build an ``on_op_start`` callback for ``WorkerRuntime``.

        ``poison_chunks``: chunk ids whose ops always raise (a
        deterministically-poisonous input).  ``crash_worker_at_op``:
        ``{worker_id: op_count}`` — kill that worker runtime after it
        has started that many ops.  ``slow_factor``: sleep this many
        seconds before every op (slow-lane).  ``slow_between``:
        ``(t0, t1, factor)`` — inside the window the per-op sleep is
        ``slow_factor * factor`` (a gray failure that onsets and
        heals), restricted to ``slow_workers`` worker ids when given
        (None = every worker).
        """
        poison = set(poison_chunks)
        crash = dict(crash_worker_at_op or {})
        slow_ids = None if slow_workers is None else set(slow_workers)
        counts: dict = {}
        lock = threading.Lock()

        def hook(runtime: Any, oi: Any) -> None:
            delay = slow_factor
            if slow_between is not None and (
                slow_ids is None
                or getattr(runtime, "worker_id", None) in slow_ids
            ):
                delay *= self.slow_window_factor(slow_between)
            if delay > 0.0:
                time.sleep(delay)
            chunk = getattr(getattr(oi, "stage_instance", None), "chunk", None)
            cid = getattr(chunk, "chunk_id", None)
            if cid in poison:
                raise RuntimeError(f"poison chunk {cid!r}")
            wid = getattr(runtime, "worker_id", None)
            if wid in crash:
                with lock:
                    counts[wid] = counts.get(wid, 0) + 1
                    due = counts[wid] >= crash[wid]
                if due:
                    runtime.kill()
                    raise RuntimeError(f"injected crash on worker {wid}")

        return hook

    def wrap_fetch(self, fetch: Callable, *, error_rate: float = 0.0,
                   slow_between: Optional[tuple] = None) -> Callable:
        """Staging seam: wrap an agent ``fetch``/``fetch_batch`` callable
        with injected read errors (e.g. a failing disk tier) and/or
        time-windowed degradation: ``slow_between=(t0, t1, factor)``
        sleeps ``delay_s * factor`` per fetch inside the window (a
        degraded-then-healed storage path)."""

        def faulty_fetch(*args: Any, **kwargs: Any) -> Any:
            if slow_between is not None:
                factor = self.slow_window_factor(slow_between)
                if factor > 1.0:
                    time.sleep(self.delay_s * factor)
            if self._roll(error_rate):
                raise IOError("injected staging read error")
            return fetch(*args, **kwargs)

        return faulty_fetch

    def wrap_dial(self, dial: Callable) -> Callable:
        """Staging seam: corrupt region bytes returned by a direct dial."""

        def faulty_dial(holder: Any, keys: Any) -> Any:
            out = dial(holder, keys)
            if out is None:
                return out
            return [self.maybe_corrupt("pull_regions", v) for v in out]

        return faulty_dial


def _corrupt_first_array(obj: Any, rng: random.Random,
                         lock: threading.Lock) -> tuple:
    """Return (corrupted?, copy-of-obj-with-one-flipped-byte)."""
    if np is not None and isinstance(obj, np.ndarray) and obj.size:
        flat = np.ascontiguousarray(obj).copy()
        raw = flat.view(np.uint8).reshape(-1)
        with lock:
            idx = rng.randrange(raw.size)
        raw[idx] ^= 0xFF
        return True, flat.reshape(obj.shape)
    if isinstance(obj, torch.Tensor) and obj.numel():
        # A clone, so the sender's own tensor stays intact; one byte of
        # its uint8 view flipped (CRC-sealed tensors are CPU or CUDA).
        flat = obj.detach().clone().contiguous()
        raw = flat.reshape(-1).view(torch.uint8)
        with lock:
            idx = rng.randrange(raw.numel())
        raw[idx] ^= 0xFF
        return True, flat
    if isinstance(obj, (tuple, list)):
        items = list(obj)
        for i, item in enumerate(items):
            done, new = _corrupt_first_array(item, rng, lock)
            if done:
                items[i] = new
                return True, type(obj)(items) if isinstance(obj, tuple) else items
        return False, obj
    if isinstance(obj, dict):
        for k, v in obj.items():
            done, new = _corrupt_first_array(v, rng, lock)
            if done:
                out = dict(obj)
                out[k] = new
                return True, out
        return False, obj
    return False, obj
