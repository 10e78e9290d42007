"""What the readers of the program's spans share, whatever the kind
(``sync``, ``gc``, ``lane:between``, ``op:<name>``: see the port's
``telemetry/lanes.py``): the device's busy time inside a host interval,
and the device's idle time named by the innermost span the host was in.

The program's spans and the device trace are on one clock (``ts`` on
``time.time``, the profiler's events converted to it), which
``bench/tests/test_bench_trace_metrics.py`` holds to 0.2 ms on the card.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from itertools import accumulate

from .trace import DeviceTrace, gaps

__all__ = ["Busy", "idle_by_span"]


class Busy:
    """The union of the device's intervals in the traced window, for the
    seconds of it inside a host interval."""

    def __init__(self, trace: DeviceTrace) -> None:
        merged: list[list[float]] = []
        for s, e in sorted(trace.clipped()):
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.starts = [s for s, _ in merged]
        self.ends = [e for _, e in merged]
        self._before = [0.0, *accumulate(e - s for s, e in merged)]

    def within(self, lo: float, hi: float) -> float:
        i = bisect_right(self.ends, lo)     # the first interval ending after lo
        j = bisect_left(self.starts, hi)    # those starting before hi
        if i >= j:
            return 0.0
        return (self._before[j] - self._before[i] - max(0.0, lo - self.starts[i])
                - max(0.0, self.ends[j - 1] - hi))


#: The host spans an idle gap is named by, the innermost (shortest) first.
HOST_SPANS = ("gc", "sync", "lane:between")


def idle_by_span(trace: DeviceTrace, spans: list[dict]) -> dict[str, float]:
    """The device's idle seconds in the traced window, each instant named
    by the innermost program span the host was in then: ``gc``, ``sync``
    (by ``args.site``), an ``op:<name>`` outside those, ``lane:between``,
    or ``no span``. The values sum to the window's idle seconds."""
    marks = []  # (time, +1 open / -1 close, length, label)
    for s in spans:
        name = s["name"]
        if name == "sync":
            label = f"sync:{s['args'].get('site')}"
        elif name in HOST_SPANS or name.startswith("op:"):
            label = name
        else:
            continue
        if s["dur"] > 0:
            marks += [(s["ts"], 1, s["dur"], label), (s["ts"] + s["dur"], -1, s["dur"], label)]
    marks.sort(key=lambda m: (m[0], m[1]))
    out: dict[str, float] = {}
    idle = gaps(trace.clipped(), trace.start, trace.end)
    active: list[tuple[float, str]] = []
    k, t = 0, trace.start
    # Sweep the marks and the gaps together: between two marks the set
    # of open spans is fixed, and its shortest names the time.
    for g0, g1 in idle:
        while True:
            while k < len(marks) and marks[k][0] <= max(t, g0):
                _, step, length, label = marks[k]
                if step > 0:
                    active.append((length, label))
                else:
                    active.remove((length, label))
                k += 1
            t = max(t, g0)
            nxt = min(marks[k][0] if k < len(marks) else g1, g1)
            label = min(active)[1] if active else "no span"
            out[label] = out.get(label, 0.0) + nxt - t
            t = nxt
            if t >= g1:
                break
    return out
