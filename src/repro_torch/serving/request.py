"""Serving request objects: what a tenant submits and what it gets back.

A :class:`ServeRequest` tracks one tile/pipeline request through the
gateway: admission (or shed), weighted-fair queueing, dispatch into
the Manager as a freshly instantiated pipeline replica, and
completion.  Latency is measured arrival-to-done (queueing included —
that is the number a serving SLO is written against), and the
request's absolute deadline is inherited by every stage instance of
its pipeline so the Manager's EDF tier and the per-node scheduler can
order work by urgency end to end.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Optional

__all__ = ["ServeRequest", "QUEUED", "RUNNING", "DONE", "SHED", "FAILED"]

QUEUED = "queued"
RUNNING = "running"
DONE = "done"
SHED = "shed"
#: Terminal failure: the request's pipeline was quarantined (poison
#: chunk / attempt budget exhausted) — it will never complete, and the
#: tenant gets a verdict instead of a hang.
FAILED = "failed"


@dataclass
class ServeRequest:
    """One admitted (or shed) request.

    ``deadline`` is absolute on the gateway's clock; ``cost`` is the
    estimated service time in seconds (the WFQ charge and the
    admission estimated-work unit).
    """

    req_id: int
    tenant: str
    chunk: Any
    arrival: float
    cost: float = 1.0
    deadline: Optional[float] = None
    state: str = QUEUED
    t_dispatch: Optional[float] = None
    t_done: Optional[float] = None
    #: terminal stage instances still outstanding (gateway internal).
    remaining: int = 0
    #: uids of the stage instances backing this request.
    stage_uids: tuple[int, ...] = ()
    #: terminal error detail (FAILED requests only).
    error: Optional[str] = None
    #: root trace context (telemetry.SpanContext) when tracing is on —
    #: every stage/op/region span of this request chains under it.
    trace: Any = None
    _done_event: threading.Event = field(
        default_factory=threading.Event, repr=False
    )

    @property
    def accepted(self) -> bool:
        return self.state != SHED

    @property
    def latency(self) -> Optional[float]:
        """Arrival-to-completion seconds (None while in flight)."""
        if self.t_done is None:
            return None
        return self.t_done - self.arrival

    @property
    def tardiness(self) -> Optional[float]:
        """Seconds past the deadline (0 when met; None = no verdict)."""
        if self.deadline is None or self.t_done is None:
            return None
        return max(0.0, self.t_done - self.deadline)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the request completes (or was shed)."""
        if self.state == SHED:
            return True
        return self._done_event.wait(timeout)
