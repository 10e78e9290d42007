"""The device trace of a traced run: capture with ``torch.profiler``
(device activity only), and the arithmetic the readers share.

The profiler's raw (kineto) events are read without building its
per-event Python tree: a traced window holds hundreds of thousands of
small kernels and copies. Their times are on the host's wall clock
(``time.time``), as are the program's spans, so a gap on the device can
be named by what the host was running then.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

__all__ = ["DeviceEvent", "DeviceTrace", "Profiler", "breakdown", "gaps", "union_seconds"]


@dataclass(frozen=True)
class DeviceEvent:
    name: str
    start: float   # wall-clock seconds
    dur: float     # seconds

    @property
    def end(self) -> float:
        return self.start + self.dur

    @property
    def kind(self) -> str:
        """``memcpy``, ``memset`` or ``kernel``."""
        if self.name.startswith("Memcpy"):
            return "memcpy"
        if self.name.startswith("Memset"):
            return "memset"
        return "kernel"


@dataclass
class DeviceTrace:
    start: float                 # wall-clock seconds
    end: float
    events: list[DeviceEvent] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def clipped(self) -> list[tuple[float, float]]:
        """Each event's interval, clipped to the traced window."""
        return [(max(e.start, self.start), min(e.end, self.end)) for e in self.events
                if e.end > self.start and e.start < self.end]


def union_seconds(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: list[tuple[float, float]], start: float, end: float) -> list[tuple[float, float]]:
    """The stretches of ``[start, end]`` that no interval covers."""
    out, t = [], start
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(s, e) for s, e in out if e > s]


def _host_label(t: float, spans: list[dict]) -> str:
    for sp in spans:
        if sp["ts"] <= t < sp["ts"] + sp["dur"]:
            return sp["name"]
    return "host between ops"


def breakdown(trace: DeviceTrace, spans: list[dict], top: int = 10) -> dict:
    """The device operations that took the most time (summed by name),
    and the longest idle gaps, each named by the program's span that
    the host was in at the gap's middle."""
    by_name: dict[str, float] = {}
    for e in trace.events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.dur
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps(trace.clipped(), trace.start, trace.end), key=lambda g: g[0] - g[1])[:top]
    op_spans = [s for s in spans if s["name"].startswith("op:")]
    return {
        "device_ops": [[name, secs] for name, secs in ops],
        "idle_gaps": [[_host_label((s + e) / 2, op_spans), e - s] for s, e in idle],
    }


class Profiler:
    """``torch.profiler`` over device activity, started and stopped by
    hand; :meth:`stop` returns the :class:`DeviceTrace`."""

    def __init__(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._start = self._t0 = 0.0

    def start(self) -> None:
        self._prof.start()
        self._start, self._t0 = time.time(), time.perf_counter()

    def stop(self) -> DeviceTrace:
        """The trace; its window's length is taken on the monotonic clock,
        so that a step of the host's wall clock does not stretch it."""
        import torch

        length = time.perf_counter() - self._t0
        torch.cuda.synchronize()
        self._prof.stop()
        return DeviceTrace(self._start, self._start + length, _device_events(self._prof))


def _device_events(prof) -> list[DeviceEvent]:
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        out.append(DeviceEvent(e.name(), e.start_ns() / 1e9, e.duration_ns() / 1e9))
    return out
