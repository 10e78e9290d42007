"""MessageBus abstraction: typed request/reply + one-way notify.

The control plane of the runtime — lease dispatch, completion
notifications, heartbeats, region pulls, placement metadata — crosses
a :class:`MessageBus`.  Two backends implement it:

* :class:`~repro.transport.inproc.InprocBus` — endpoints in the same
  process, handlers invoked directly (zero-copy, the seed behavior);
* :class:`~repro.transport.socketbus.SocketBus` — real multiprocess
  peers over TCP, length-prefixed codec frames, batched message
  coalescing per peer.

The contract both provide:

* **typed messages** — ``call`` (request/reply, blocking) and
  ``notify`` (one-way, fire-and-forget), dispatched by method name to
  handlers registered at ``serve``/``connect`` time;
* **per-peer ordered delivery** — messages sent to one peer are
  handled in send order (replies are matched out-of-band so a blocked
  handler can never deadlock an in-flight call);
* **symmetric peers** — either side of a connection may call the
  other; a server learns of new peers via ``on_connect``.

Handlers have signature ``handler(peer, payload) -> result``; the
result travels back as the reply (requests only).
"""

from __future__ import annotations

import threading
from abc import ABC, abstractmethod
from typing import Any, Callable, Optional

__all__ = [
    "BusError",
    "BusClosedError",
    "BusTimeoutError",
    "RemoteError",
    "Handler",
    "Peer",
    "MessageBus",
]

Handler = Callable[["Peer", Any], Any]

#: Message kinds on the wire.  ``seg`` carries one chunk of a large
#: message that was split so bulk region payloads cannot head-of-line
#: block control traffic sharing the connection.
REQ, REP, ERR, NTF, SEG = "req", "rep", "err", "ntf", "seg"


class BusError(RuntimeError):
    """Base class for transport failures."""


class BusClosedError(BusError):
    """The peer/connection is gone; the message cannot be delivered."""


class BusTimeoutError(BusError):
    """No reply within the call's timeout."""


class RemoteError(BusError):
    """The remote handler raised; carries the remote traceback string."""


class Peer(ABC):
    """One end of a connection: the handle used to message the other end."""

    name: str = "peer"

    @abstractmethod
    def call(self, method: str, payload: Any = None, *, timeout: float = 30.0) -> Any:
        """Request/reply: block until the remote handler's result arrives."""

    @abstractmethod
    def notify(self, method: str, payload: Any = None) -> None:
        """One-way message; delivery is ordered with other sends to this peer."""

    @abstractmethod
    def close(self) -> None: ...

    @property
    @abstractmethod
    def alive(self) -> bool: ...


class MessageBus(ABC):
    """Factory/owner of peers for one transport backend."""

    def __init__(self, registry: Optional[Any] = None) -> None:
        from ..telemetry.metrics import MetricsRegistry

        self._lock = threading.Lock()
        # Aggregate traffic counters served from the shared metrics
        # registry (int-like cells: existing `bus.messages_sent += 1`
        # sites and comparisons work unchanged; benchmarks and tests
        # read these).
        self.registry = registry or MetricsRegistry()
        self.messages_sent = self.registry.counter("bus.messages_sent")
        self.frames_sent = self.registry.counter("bus.frames_sent")

    @abstractmethod
    def serve(
        self,
        handlers: dict[str, Handler],
        *,
        on_connect: Optional[Callable[[Peer], None]] = None,
        on_disconnect: Optional[Callable[[Peer], None]] = None,
    ) -> str:
        """Start serving; returns the address peers connect to."""

    @abstractmethod
    def connect(
        self, address: str, handlers: Optional[dict[str, Handler]] = None
    ) -> Peer:
        """Connect to a served address; ``handlers`` serve the reverse
        direction (the server calling us)."""

    @abstractmethod
    def close(self) -> None:
        """Tear down the listener and every peer this bus created."""

    def coalesce_ratio(self) -> float:
        """Messages per frame actually sent (1.0 = no batching)."""
        return int(self.messages_sent) / max(int(self.frames_sent), 1)

    def stats(self) -> dict[str, Any]:
        """Aggregate transport counters; backends extend with their own
        (e.g. per-peer send failures on :class:`SocketBus`).  Values
        are coerced to plain ints: this dict crosses the wire."""
        return {
            "messages_sent": int(self.messages_sent),
            "frames_sent": int(self.frames_sent),
        }
