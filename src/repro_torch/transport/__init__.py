"""The bus contract of the port (a byte-identical copy of the JAX
package's ``transport/bus.py``). The codec, the in-process and socket
buses and the endpoints are not part of this package yet."""

from .bus import (
    BusClosedError,
    BusError,
    BusTimeoutError,
    MessageBus,
    Peer,
    RemoteError,
)

__all__ = [
    "BusClosedError",
    "BusError",
    "BusTimeoutError",
    "MessageBus",
    "Peer",
    "RemoteError",
]
