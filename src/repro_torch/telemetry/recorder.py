"""Flight recorder: a bounded ring of recent events, dumped on failure.

Each node (Manager process, every worker process, the simulator) can
hold one :class:`FlightRecorder`.  Instrumented sites append small
events (``note``); an attached :class:`~repro.telemetry.tracing.Tracer`
feeds every finished span in as well.  The ring is bounded
(``capacity`` events, oldest evicted), so the recorder costs O(1)
memory no matter how long the process runs.

On a trigger — worker crash (``WorkerRuntime.kill``), chunk quarantine
(Manager), deadline miss (``RequestGateway``) — ``dump()`` snapshots
the ring plus a reason/detail header into an in-memory postmortem
record and, when ``dump_dir`` is set, a JSON artifact
``flight-<service>-<seq>.json``.  Chaos tests assert on these instead
of doing log archaeology.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Optional

__all__ = ["FlightRecorder"]


class FlightRecorder:
    def __init__(
        self,
        service: str = "repro",
        *,
        capacity: int = 512,
        dump_dir: Optional[str] = None,
        max_dumps: int = 16,
    ) -> None:
        self.service = service
        self.capacity = int(capacity)
        self.dump_dir = dump_dir
        self.max_dumps = int(max_dumps)
        self._lock = threading.Lock()
        self._ring: deque[dict[str, Any]] = deque(maxlen=self.capacity)
        self.dumps: list[dict[str, Any]] = []
        self.events_noted = 0
        self._seq = 0

    def note(self, kind: str, **fields: Any) -> None:
        """Append one event to the ring.  ``fields`` must be wire-safe
        (they are JSON-dumped on trigger)."""
        event = {"kind": kind, "t": time.time()}
        event.update(fields)
        with self._lock:
            self._ring.append(event)
            self.events_noted += 1

    def dump(self, reason: str, detail: Optional[dict[str, Any]] = None) -> dict[str, Any]:
        """Snapshot the ring into a postmortem record (and a JSON file
        when ``dump_dir`` is configured).  Returns the record."""
        with self._lock:
            self._seq += 1
            record = {
                "reason": reason,
                "service": self.service,
                "t": time.time(),
                "seq": self._seq,
                "detail": dict(detail) if detail else {},
                "events": list(self._ring),
            }
            if len(self.dumps) < self.max_dumps:
                self.dumps.append(record)
        if self.dump_dir:
            try:
                os.makedirs(self.dump_dir, exist_ok=True)
                path = os.path.join(
                    self.dump_dir,
                    f"flight-{self.service}-{record['seq']:04d}.json",
                )
                with open(path, "w", encoding="utf-8") as f:
                    json.dump(record, f, separators=(",", ":"), default=str)
            except OSError:
                pass  # postmortem must never take the process down
        return record

    def events(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "events_noted": self.events_noted,
                "events_buffered": len(self._ring),
                "dumps": len(self.dumps),
            }
