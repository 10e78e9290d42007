"""In-process MessageBus backend: direct handler invocation, zero-copy.

This is the seed deployment mode made explicit: Manager and Workers in
one process, the "wire" a plain function call.  Payloads are passed by
reference (no codec round-trip), ``call`` runs the remote handler in
the caller's thread, and ordering is trivial.  Running the control
plane through :class:`InprocBus` rather than direct method calls keeps
the code path identical to :class:`~repro.transport.socketbus.SocketBus`
so the same Manager/Worker wiring works unchanged on either backend.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Callable, Optional

from .bus import BusClosedError, BusError, Handler, MessageBus, Peer, RemoteError

__all__ = ["InprocBus"]


class _InprocPeer(Peer):
    """One side of a linked pair; ``other`` is the opposite side."""

    def __init__(self, name: str, handlers: dict[str, Handler], bus: "InprocBus"):
        self.name = name
        self.handlers = dict(handlers)
        self.bus = bus
        self.other: Optional["_InprocPeer"] = None
        self._closed = False

    def call(self, method: str, payload: Any = None, *, timeout: float = 30.0) -> Any:
        other = self._other_or_raise(method)
        handler = other.handlers.get(method)
        if handler is None:
            raise KeyError(f"peer {other.name!r} has no handler {method!r}")
        with self.bus._lock:
            self.bus.messages_sent += 1
            self.bus.frames_sent += 1
        # The handler sees *us* through the other side's view of the link.
        # Handler failures surface as RemoteError on every backend: code
        # written against InprocBus keeps working over SocketBus.
        try:
            return handler(other, payload)
        except BusError:
            raise
        except BaseException as exc:  # noqa: BLE001 - mirrored to caller
            raise RemoteError(f"{type(exc).__name__}: {exc}") from exc

    def notify(self, method: str, payload: Any = None) -> None:
        # Backend parity with SocketBus: a notify is fire-and-forget, so
        # handler failures never surface to the sender (the dispatcher
        # drops them there; we drop them here).  Closed-peer errors
        # still raise, exactly like the socket enqueue would.
        try:
            self.call(method, payload)
        except BusClosedError:
            raise
        except (BusError, KeyError):
            pass  # handler error / no handler: dropped, as on the socket

    def close(self) -> None:
        self._closed = True
        other = self.other
        if other is not None and not other._closed:
            other._closed = True
            if other.on_disconnect is not None:
                other.on_disconnect(other)

    on_disconnect: Optional[Callable[[Peer], None]] = None

    @property
    def alive(self) -> bool:
        return not self._closed

    def _other_or_raise(self, method: str) -> "_InprocPeer":
        if self._closed or self.other is None or self.other._closed:
            raise BusClosedError(f"peer {self.name!r} closed ({method!r})")
        return self.other


class InprocBus(MessageBus):
    _addr_counter = itertools.count()
    _registry: dict[str, tuple[dict, Optional[Callable], Optional[Callable]]] = {}
    _registry_lock = threading.Lock()

    def __init__(self, registry=None) -> None:
        super().__init__(registry)
        self._peers: list[_InprocPeer] = []
        # One bus may serve several endpoints (e.g. a WorkerClient's
        # control connection plus its worker-to-worker data plane).
        self._addresses: list[str] = []

    def serve(self, handlers, *, on_connect=None, on_disconnect=None) -> str:
        address = f"inproc://{next(self._addr_counter)}"
        with self._registry_lock:
            self._registry[address] = (dict(handlers), on_connect, on_disconnect)
        self._addresses.append(address)
        return address

    def connect(self, address: str, handlers=None) -> Peer:
        with self._registry_lock:
            entry = self._registry.get(address)
        if entry is None:
            raise BusClosedError(f"no inproc endpoint at {address!r}")
        srv_handlers, on_connect, on_disconnect = entry
        client = _InprocPeer(f"{address}#client", handlers or {}, self)
        server = _InprocPeer(f"{address}#server", srv_handlers, self)
        client.other, server.other = server, client
        server.on_disconnect = on_disconnect
        self._peers += [client, server]
        if on_connect is not None:
            on_connect(server)
        return client

    def close(self) -> None:
        for peer in self._peers:
            peer.close()
        with self._registry_lock:
            for address in self._addresses:
                self._registry.pop(address, None)
