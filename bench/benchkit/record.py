"""What a driver hands back from one run, and what the metric readers
read: the window, every tile's times on the harness's clock, the
program's counters at the window's two ends, its spans and the device
trace of a traced run."""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from .trace import DeviceTrace

__all__ = ["Run", "TileTimes", "nearest_rank"]


def nearest_rank(values: list[float], pct: float) -> float:
    """The ``pct`` percentile of ``values`` by nearest rank: the value
    with ``ceil(pct/100 * n)`` values at or below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return ordered[max(math.ceil(pct / 100.0 * len(ordered)), 1) - 1]


@dataclass
class TileTimes:
    """One tile's times on ``time.perf_counter``: the lease of its
    first stage and the completion of its last (None until then)."""

    chunk: int
    leased: float | None = None
    done: float | None = None


@dataclass
class Run:
    t_open: float                        # perf_counter at the window's opening
    t_close: float                       # perf_counter at its closing
    wall_open: float                     # time.time at the opening
    setup_s: float
    tiles: dict[int, TileTimes]
    counters_open: dict[str, float]
    counters_close: dict[str, float]
    peak_bytes: int                      # max_memory_allocated, window open to the driver's PEAK_TILES-th tile
    window_peak_bytes: int               # max_memory_allocated over the whole window
    tile_shape: tuple[int, int]
    stage_ops: dict[str, list[str]]      # stage name -> its op names
    spans: list[dict] = field(default_factory=list)
    op_chunks: dict[int, int] = field(default_factory=dict)  # op instance uid -> its tile
    device: DeviceTrace | None = None
    errors: list[str] = field(default_factory=list)

    @property
    def seconds(self) -> float:
        """The window's length."""
        return self.t_close - self.t_open

    def done(self) -> list[TileTimes]:
        """Tiles whose last stage completed inside the window."""
        return [t for t in self.tiles.values()
                if t.done is not None and self.t_open < t.done <= self.t_close]

    def done_between(self, wall_start: float, wall_end: float) -> int:
        """Tiles completed between two wall-clock instants."""
        lo = self.t_open + (wall_start - self.wall_open)
        hi = self.t_open + (wall_end - self.wall_open)
        return sum(1 for t in self.tiles.values() if t.done is not None and lo < t.done <= hi)

    def counter_delta(self, key: str) -> float:
        return self.counters_close[key] - self.counters_open[key]

    def stage_span_seconds(self, stage: str) -> float:
        """Seconds of the ``op:*`` spans of ``stage``'s ops on the tiles
        completed inside the window (found by the op's uid, not by the
        span's wall-clock start, which a step of the host's clock moves)."""
        names = {f"op:{op}" for op in self.stage_ops[stage]}
        done = {t.chunk for t in self.done()}
        return sum(s["dur"] for s in self.spans if s["name"] in names
                   and self.op_chunks.get(s["args"].get("uid")) in done)
