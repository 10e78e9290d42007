"""Chrome trace-event export: spans → a JSON file Perfetto opens.

The span dicts produced by :class:`repro.telemetry.tracing.Tracer`
(and the simulator mirror) map onto complete events (``"ph": "X"``) in
the Chrome trace-event format:

* ``pid`` ← the span's ``service`` (one process row per cluster role),
* ``tid`` ← the span's ``tid`` (lane / thread grouping inside a row),
* ``ts``/``dur`` ← microseconds (the format's unit),
* trace/span/parent ids ride in ``args`` so a flow can be followed.

Open the result at https://ui.perfetto.dev (or ``chrome://tracing``).
"""

from __future__ import annotations

import json
from typing import Any, Iterable, Optional

__all__ = ["to_chrome_events", "export_chrome_trace"]


def to_chrome_events(
    spans: Iterable[dict[str, Any]],
    *,
    t0: Optional[float] = None,
) -> list[dict[str, Any]]:
    """Convert span dicts to Chrome trace events.

    ``t0`` rebases timestamps (defaults to the earliest span) so the
    timeline starts near zero instead of at the unix epoch — Perfetto
    renders either, but a rebased view is navigable.
    """
    spans = [s for s in spans if s]
    if not spans:
        return []
    base = min(s.get("ts", 0.0) for s in spans) if t0 is None else t0
    events: list[dict[str, Any]] = []
    for s in spans:
        args = dict(s.get("args") or {})
        args["trace"] = s.get("trace")
        args["span"] = s.get("span")
        if s.get("parent"):
            args["parent"] = s["parent"]
        events.append(
            {
                "name": s.get("name", "?"),
                "cat": s.get("cat", "op"),
                "ph": "X",
                "ts": (s.get("ts", 0.0) - base) * 1e6,
                "dur": max(s.get("dur", 0.0), 0.0) * 1e6,
                "pid": s.get("service", "repro"),
                "tid": s.get("tid", "main"),
                "args": args,
            }
        )
    events.sort(key=lambda e: e["ts"])
    return events


def export_chrome_trace(
    spans: Iterable[dict[str, Any]],
    path: str,
    *,
    metadata: Optional[dict[str, Any]] = None,
) -> dict[str, Any]:
    """Write ``spans`` to ``path`` as a Chrome trace-event JSON object;
    returns the document (also useful for in-memory assertions)."""
    doc: dict[str, Any] = {
        "traceEvents": to_chrome_events(spans),
        "displayTimeUnit": "ms",
    }
    if metadata:
        doc["otherData"] = dict(metadata)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, separators=(",", ":"), default=str)
    return doc
