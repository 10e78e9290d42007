"""What a driver hands back from one run, and what the metric readers
read: the window, each unit of the traffic's start and completion on
the driver's clock, the program's counters at the window's two ends,
its spans, the device trace of a traced run, and the kind's own record
(``Run.own``: what only one kind of configuration has, which only its
driver and its readers know)."""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any

from .trace import DeviceTrace

__all__ = ["Item", "Run", "Sample", "nearest_rank"]


def nearest_rank(values: list[float], pct: float) -> float:
    """The ``pct`` percentile of ``values`` by nearest rank: the value
    with ``ceil(pct/100 * n)`` values at or below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return ordered[max(math.ceil(pct / 100.0 * len(ordered)), 1) - 1]


@dataclass
class Item:
    """One unit of the traffic, on the driver's clock: when the program
    took it up (None until then) and when its result was complete."""

    key: int
    start: float | None = None
    done: float | None = None


@dataclass
class Sample:
    """One completed unit that the run compares: the inputs that the
    harness made for it (what the reference is given) and what the
    program produced (what the comparison judges)."""

    key: int
    inputs: Any
    got: Any


@dataclass
class Run:
    t_open: float                        # driver's clock at the window's opening
    t_close: float                       # at its closing
    wall_open: float                     # time.time at the opening
    setup_s: float
    items: dict[int, Item]
    counters_open: dict[str, float]
    counters_close: dict[str, float]
    peak_bytes: int                      # max_memory_allocated over the span the driver states
    window_peak_bytes: int               # max_memory_allocated over the whole window
    spans: list[dict] = field(default_factory=list)
    device: DeviceTrace | None = None
    errors: list[str] = field(default_factory=list)
    own: Any = None                      # the kind's own record

    @property
    def seconds(self) -> float:
        """The window's length."""
        return self.t_close - self.t_open

    def done(self) -> list[Item]:
        """Units completed inside the window."""
        return [t for t in self.items.values()
                if t.done is not None and self.t_open < t.done <= self.t_close]

    def wall(self, t: float) -> float:
        """A time on the driver's clock as a wall-clock (``time.time``)
        time, the clock of the spans and the device trace."""
        return self.wall_open + (t - self.t_open)

    def done_between(self, wall_start: float, wall_end: float) -> int:
        """Units completed between two wall-clock instants."""
        lo = self.t_open + (wall_start - self.wall_open)
        hi = self.t_open + (wall_end - self.wall_open)
        return sum(1 for t in self.items.values() if t.done is not None and lo < t.done <= hi)

    def counter_delta(self, key: str) -> float:
        return self.counters_close[key] - self.counters_open[key]
