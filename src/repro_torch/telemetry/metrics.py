"""Typed, thread-safe metrics shared by every subsystem's ``stats()``.

Design constraints, in order:

1. **Drop-in for the ad-hoc counters they replace.**  Seven subsystems
   kept plain-int attributes (``self.recovered_leases += 1``) that
   tests and benchmarks read directly (``assert mgr.recovered_leases
   >= 1``).  :class:`Counter`/:class:`Gauge` are therefore *int-like*:
   in-place ``+=``/``-=`` mutate the shared cell, and comparisons,
   arithmetic, ``int()``/``float()``/``bool()`` all behave like the
   integer they hold — existing call sites compile unchanged.
2. **Wire safety.**  Metric objects never cross the bus; every
   ``stats()`` view and :meth:`MetricsRegistry.snapshot` coerces to
   plain ``int``/``float`` so any codec can carry them.
3. **Cheap.**  An increment is one lock acquire + one integer add;
   the overhead guard in ``tests/test_telemetry.py`` and the ≤2%
   budget in ``BENCH_PR8.json`` keep it honest.

No label dimensions: components that need per-instance metrics (one
worker vs another) hold per-instance *registries* — the Manager-side
aggregation (``get_stats``) namespaces them by worker id instead.
"""

from __future__ import annotations

import threading
from typing import Any, Iterable, Optional, Union

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]

Number = Union[int, float]


class _Cell:
    """Shared numeric base for Counter/Gauge: int-like, lock-guarded."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str, value: Number = 0) -> None:
        self.name = name
        self._value = value
        self._lock = threading.Lock()

    # -- mutation ------------------------------------------------------
    def inc(self, delta: Number = 1) -> None:
        with self._lock:
            self._value += delta

    def set(self, value: Number) -> None:
        with self._lock:
            self._value = value

    @property
    def value(self) -> Number:
        return self._value

    # -- int-like protocol (drop-in for the plain attributes) ----------
    def __iadd__(self, other: Number) -> "_Cell":
        self.inc(other)
        return self

    def __isub__(self, other: Number) -> "_Cell":
        self.inc(-other)
        return self

    def __int__(self) -> int:
        return int(self._value)

    def __index__(self) -> int:
        return int(self._value)

    def __float__(self) -> float:
        return float(self._value)

    def __bool__(self) -> bool:
        return bool(self._value)

    @staticmethod
    def _raw(other: Any) -> Any:
        return other._value if isinstance(other, _Cell) else other

    def __eq__(self, other: Any) -> bool:
        return self._value == self._raw(other)

    def __ne__(self, other: Any) -> bool:
        return self._value != self._raw(other)

    def __lt__(self, other: Any) -> bool:
        return self._value < self._raw(other)

    def __le__(self, other: Any) -> bool:
        return self._value <= self._raw(other)

    def __gt__(self, other: Any) -> bool:
        return self._value > self._raw(other)

    def __ge__(self, other: Any) -> bool:
        return self._value >= self._raw(other)

    def __hash__(self) -> int:
        return hash(self.name)

    def __add__(self, other: Any) -> Number:
        return self._value + self._raw(other)

    __radd__ = __add__

    def __sub__(self, other: Any) -> Number:
        return self._value - self._raw(other)

    def __rsub__(self, other: Any) -> Number:
        return self._raw(other) - self._value

    def __mul__(self, other: Any) -> Number:
        return self._value * self._raw(other)

    __rmul__ = __mul__

    def __truediv__(self, other: Any) -> float:
        return self._value / self._raw(other)

    def __rtruediv__(self, other: Any) -> float:
        return self._raw(other) / self._value

    def __floordiv__(self, other: Any) -> Number:
        return self._value // self._raw(other)

    def __neg__(self) -> Number:
        return -self._value

    def __abs__(self) -> Number:
        return abs(self._value)

    def __format__(self, spec: str) -> str:
        return format(self._value, spec)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.name!r}, {self._value!r})"


class Counter(_Cell):
    """Monotonically *intended* counter (not enforced: a few legacy
    sites decrement transient in-flight tallies; those are gauges in
    spirit and migrate over time)."""


class Gauge(_Cell):
    """A settable level (queue depth, in-flight bytes)."""


class Histogram:
    """Fixed-bucket histogram with count/sum/min/max.

    Buckets are upper bounds (ascending); an observation lands in the
    first bucket whose bound is >= the value, else overflow.
    """

    __slots__ = ("name", "bounds", "buckets", "count", "sum", "min", "max",
                 "_lock")

    DEFAULT_BOUNDS = (
        0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0,
    )

    def __init__(self, name: str,
                 bounds: Optional[Iterable[float]] = None) -> None:
        self.name = name
        self.bounds = tuple(bounds) if bounds is not None else self.DEFAULT_BOUNDS
        self.buckets = [0] * (len(self.bounds) + 1)  # +1 overflow
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self.count += 1
            self.sum += value
            if self.min is None or value < self.min:
                self.min = value
            if self.max is None or value > self.max:
                self.max = value
            for i, bound in enumerate(self.bounds):
                if value <= bound:
                    self.buckets[i] += 1
                    return
            self.buckets[-1] += 1

    def percentile(self, q: float) -> Optional[float]:
        """Bucket-interpolated quantile ``q`` in ``[0, 1]``.

        Within a bucket the mass is assumed uniform between its lower
        and upper bound (the first bucket interpolates from ``min``);
        the open overflow bucket reports ``max`` — conservative in the
        direction control loops care about (never under-reports the
        tail).  None until anything has been observed.
        """
        with self._lock:
            if self.count == 0:
                return None
            q = min(max(q, 0.0), 1.0)
            target = q * self.count
            seen = 0.0
            for i, n in enumerate(self.buckets):
                if n == 0:
                    continue
                if seen + n >= target:
                    if i >= len(self.bounds):
                        return float(self.max)
                    hi = self.bounds[i]
                    lo = (
                        self.bounds[i - 1]
                        if i > 0
                        else min(self.min or 0.0, hi)
                    )
                    frac = (target - seen) / n
                    return float(lo + (hi - lo) * frac)
                seen += n
            return float(self.max)

    def snapshot(self) -> dict[str, Any]:
        with self._lock:
            return {
                "count": self.count,
                "sum": self.sum,
                "min": self.min,
                "max": self.max,
                "mean": (self.sum / self.count) if self.count else 0.0,
                "bounds": list(self.bounds),
                "buckets": list(self.buckets),
            }

    def __repr__(self) -> str:
        return f"Histogram({self.name!r}, n={self.count})"


class MetricsRegistry:
    """Get-or-create home for a component family's metrics.

    One registry per process role (one in the Manager process, one per
    worker process shared by runtime/agent/store/bus/client); metric
    names are dotted ``subsystem.metric`` paths.  ``snapshot()`` is the
    wire-safe flattening used by the ``get_stats`` RPC.
    """

    def __init__(self, service: str = "repro") -> None:
        self.service = service
        self._lock = threading.Lock()
        self._metrics: dict[str, Any] = {}

    def _get_or_create(self, name: str, factory, kind) -> Any:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, kind):
                    raise TypeError(
                        f"metric {name!r} already registered as "
                        f"{type(existing).__name__}"
                    )
                return existing
            metric = factory()
            self._metrics[name] = metric
            return metric

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, lambda: Counter(name), Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, lambda: Gauge(name), Gauge)

    def histogram(self, name: str,
                  bounds: Optional[Iterable[float]] = None) -> Histogram:
        return self._get_or_create(
            name, lambda: Histogram(name, bounds), Histogram
        )

    def get(self, name: str) -> Optional[Any]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> dict[str, Any]:
        """Wire-safe flat dict: counters/gauges as plain numbers,
        histograms as their summary dicts."""
        with self._lock:
            metrics = dict(self._metrics)
        out: dict[str, Any] = {}
        for name in sorted(metrics):
            m = metrics[name]
            if isinstance(m, Histogram):
                out[name] = m.snapshot()
            else:
                v = m.value
                out[name] = int(v) if isinstance(v, int) else float(v)
        return out
