"""TCP MessageBus backend: multiprocess peers, framed codec, coalescing.

One TCP connection per peer pair, used full-duplex; either side may
``call`` or ``notify`` the other.  On the wire a *frame* is::

    [4-byte big-endian length][codec bytes of a tuple of messages]

and each message is ``(kind, msg_id, method, payload)`` with kind one
of ``req``/``rep``/``err``/``ntf``/``seg``.

Three threads per peer:

* **sender** — drains the outgoing queue and packs *everything queued*
  into one frame: per-peer batched message coalescing.  Under control-
  plane bursts (heartbeats, completion notifies, region drops) many
  messages ride one syscall/frame; ``MessageBus.coalesce_ratio``
  reports the amortization actually achieved.
* **receiver** — reads frames; replies resolve pending calls directly
  (never queued behind handlers, so a blocked handler cannot deadlock
  an in-flight call), requests/notifies go to the dispatch queue.
* **dispatcher** — runs handlers one at a time in arrival order:
  per-peer ordered delivery.

Large messages (region payloads on the worker-to-worker data plane,
push bytes) are *segmented*: the message is encoded once, split into
``max_frame_bytes`` chunks riding ``seg`` messages through a separate
bulk queue, and reassembled by the receiver.  The sender always ships
every queued control message plus at most ~one frame's worth of bulk
chunks per frame, so a multi-megabyte region transfer cannot
head-of-line block a heartbeat or a lease dispatch sharing the
connection.  The price is that a *bulk* message may be overtaken by a
control message enqueued after it (ordering still holds among control
messages and among the chunks of one bulk message).
"""

from __future__ import annotations

import socket
import struct
import threading
import traceback
from collections import deque
from typing import Any, Callable, Optional

from .bus import (
    ERR,
    NTF,
    REP,
    REQ,
    SEG,
    BusClosedError,
    BusTimeoutError,
    Handler,
    MessageBus,
    Peer,
    RemoteError,
)
from .codec import WireCodec, default_codec
from ..staging.tiers import sizeof as _sizeof

__all__ = ["SocketBus", "SocketPeer"]

_LEN = struct.Struct(">I")


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return bytes(buf)


class _PendingCall:
    __slots__ = ("event", "result", "error")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None


class SocketPeer(Peer):
    def __init__(
        self,
        sock: socket.socket,
        handlers: dict[str, Handler],
        bus: "SocketBus",
        name: str,
    ) -> None:
        self.name = name
        self.bus = bus
        self.handlers = dict(handlers)
        self.codec = bus.codec
        self.on_disconnect: Optional[Callable[[Peer], None]] = None
        self._sock = sock
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._send_lock = threading.Lock()
        self._send_ready = threading.Condition(self._send_lock)
        self._outgoing: deque[tuple] = deque()
        self._pending: dict[int, _PendingCall] = {}
        self._msg_id = 0
        self._closed = False
        self._dispatch: deque[tuple] = deque()
        self._dispatch_ready = threading.Condition(threading.Lock())
        # Streamed/chunked path for large messages: pre-encoded chunks
        # waiting to ride frames (control messages always jump ahead).
        self.max_frame_bytes = bus.max_frame_bytes
        self._bulk: deque[tuple] = deque()
        self._seg_id = 0
        self._reassembly: dict[int, bytearray] = {}  # receiver thread only
        # Per-peer traffic counters.
        self.sent_messages = 0
        self.sent_frames = 0
        self.sent_segments = 0
        self.recv_messages = 0
        self.recv_frames = 0
        self.recv_segments = 0
        # Delivery-failure counters: ``notify`` enqueues and forgets, so
        # without these a dead peer's lost sends vanish silently.
        # ``send_errors`` counts failed socket sends (whole frames);
        # ``dropped_notifies`` counts NTF messages that were queued but
        # never made it onto the wire (failed frame + teardown leftovers).
        self.send_errors = 0
        self.dropped_notifies = 0
        self._threads = [
            threading.Thread(target=fn, daemon=True, name=f"{name}-{tag}")
            for tag, fn in (
                ("send", self._sender_loop),
                ("recv", self._receiver_loop),
                ("dispatch", self._dispatcher_loop),
            )
        ]
        for t in self._threads:
            t.start()

    # -- public API --------------------------------------------------------

    def call(self, method: str, payload: Any = None, *, timeout: float = 30.0) -> Any:
        pending = _PendingCall()
        with self._send_lock:
            if self._closed:
                raise BusClosedError(f"{self.name}: closed ({method!r})")
            self._msg_id += 1
            msg_id = self._msg_id
            self._pending[msg_id] = pending
            self._enqueue_locked((REQ, msg_id, method, payload))
        try:
            if not pending.event.wait(timeout=timeout):
                raise BusTimeoutError(f"{self.name}: no reply to {method!r}")
        finally:
            with self._send_lock:
                self._pending.pop(msg_id, None)
        if pending.error is not None:
            raise pending.error
        return pending.result

    def notify(self, method: str, payload: Any = None) -> None:
        with self._send_lock:
            if self._closed:
                raise BusClosedError(f"{self.name}: closed ({method!r})")
            self._msg_id += 1
            self._enqueue_locked((NTF, self._msg_id, method, payload))

    def close(self) -> None:
        self._teardown(notify_disconnect=False)

    @property
    def alive(self) -> bool:
        return not self._closed

    # -- internals ---------------------------------------------------------

    def _teardown(self, notify_disconnect: bool = True) -> None:
        with self._send_lock:
            if self._closed:
                return
            self._closed = True
            # Queued-but-never-sent notifies die here: count them so
            # chaos tests and operators can assert on delivery failure.
            self.dropped_notifies += sum(
                1 for m in self._outgoing if m[0] == NTF
            )
            self._outgoing.clear()
            err = BusClosedError(f"{self.name}: connection closed")
            for pending in self._pending.values():
                pending.error = err
                pending.event.set()
            self._pending.clear()
            self._send_ready.notify_all()
        with self._dispatch_ready:
            self._dispatch_ready.notify_all()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        if notify_disconnect and self.on_disconnect is not None:
            try:
                self.on_disconnect(self)
            except Exception:  # noqa: BLE001 - teardown must not raise
                pass

    def _enqueue_locked(self, msg: tuple) -> None:
        """Queue a message for the sender (``_send_lock`` held).

        Large payloads take the chunked path: the message is encoded
        once, split into ``max_frame_bytes`` segments, and queued on the
        bulk deque — control messages enqueued later still overtake the
        remaining chunks, so region bytes never head-of-line block a
        heartbeat or a lease riding the same connection.
        """
        self.sent_messages += 1
        with self.bus._lock:
            self.bus.messages_sent += 1
        limit = self.max_frame_bytes
        if limit and _sizeof(msg[3]) > limit:
            data = self.codec.encode(msg)
            if len(data) > limit:
                self._seg_id += 1
                sid = self._seg_id
                n = (len(data) + limit - 1) // limit
                for i in range(n):
                    chunk = data[i * limit:(i + 1) * limit]
                    self._bulk.append((SEG, sid, (i, n), chunk))
                self.sent_segments += n
                self._send_ready.notify()
                return
        self._outgoing.append(msg)
        self._send_ready.notify()

    def _sender_loop(self) -> None:
        while True:
            with self._send_lock:
                while (
                    not self._outgoing and not self._bulk and not self._closed
                ):
                    self._send_ready.wait(timeout=0.25)
                if self._closed:
                    return
                # Coalesce: every control message queued right now rides
                # one frame, plus at most ~one frame's worth of bulk
                # segments (so later control messages can interleave
                # between the chunks of a large region transfer).
                batch = list(self._outgoing)
                self._outgoing.clear()
                budget = self.max_frame_bytes or None
                while self._bulk:
                    seg = self._bulk.popleft()
                    batch.append(seg)
                    if budget is not None:
                        budget -= len(seg[3])
                        if budget <= 0:
                            break
            try:
                data = self.codec.encode(tuple(batch))
                with self._send_lock:
                    self.sent_frames += 1
                with self.bus._lock:
                    self.bus.frames_sent += 1
                self._sock.sendall(_LEN.pack(len(data)) + data)
            except (OSError, ConnectionError):
                with self._send_lock:
                    self.send_errors += 1
                    # The frame that failed carried these notifies; the
                    # teardown below accounts whatever is still queued.
                    self.dropped_notifies += sum(
                        1 for m in batch if m[0] == NTF
                    )
                self._teardown()
                return

    def _receiver_loop(self) -> None:
        while not self._closed:
            try:
                header = _read_exact(self._sock, _LEN.size)
                (length,) = _LEN.unpack(header)
                frame = self.codec.decode(_read_exact(self._sock, length))
            except (OSError, ConnectionError, EOFError):
                self._teardown()
                return
            self.recv_frames += 1
            for msg in frame:
                self._handle_message(msg)

    def _handle_message(self, msg: tuple) -> None:
        kind, msg_id = msg[0], msg[1]
        if kind == SEG:
            # Chunk of a segmented message: reassemble (chunks of one
            # message arrive in order on this connection), then handle
            # the decoded inner message as if it arrived whole.  Only
            # the reassembled logical message counts toward
            # recv_messages, mirroring the sender's accounting.
            self.recv_segments += 1
            idx, total = msg[2]
            buf = self._reassembly.setdefault(msg_id, bytearray())
            buf += msg[3]
            if idx + 1 >= total:
                del self._reassembly[msg_id]
                self._handle_message(self.codec.decode(bytes(buf)))
            return
        self.recv_messages += 1
        if kind in (REP, ERR):
            with self._send_lock:
                pending = self._pending.get(msg_id)
            if pending is not None:
                if kind == ERR:
                    pending.error = RemoteError(str(msg[3]))
                else:
                    pending.result = msg[3]
                pending.event.set()
        else:  # REQ / NTF: ordered dispatch off the receiver thread
            with self._dispatch_ready:
                self._dispatch.append(msg)
                self._dispatch_ready.notify()

    def _dispatcher_loop(self) -> None:
        while True:
            with self._dispatch_ready:
                while not self._dispatch and not self._closed:
                    self._dispatch_ready.wait(timeout=0.25)
                if self._closed and not self._dispatch:
                    return
                kind, msg_id, method, payload = self._dispatch.popleft()
            handler = self.handlers.get(method)
            try:
                if handler is None:
                    raise KeyError(f"no handler for {method!r}")
                result = handler(self, payload)
                if kind == REQ:
                    self._reply(REP, msg_id, method, result)
            except BaseException as exc:  # noqa: BLE001 - sent to caller
                if kind == REQ:
                    detail = "".join(
                        traceback.format_exception_only(type(exc), exc)
                    ).strip()
                    try:
                        self._reply(ERR, msg_id, method, detail)
                    except BusClosedError:
                        return

    def _reply(self, kind: str, msg_id: int, method: str, payload: Any) -> None:
        with self._send_lock:
            if self._closed:
                raise BusClosedError(f"{self.name}: closed (reply {method!r})")
            self._enqueue_locked((kind, msg_id, method, payload))


class SocketBus(MessageBus):
    def __init__(
        self,
        host: str = "127.0.0.1",
        codec: Optional[WireCodec] = None,
        *,
        max_frame_bytes: int = 1 << 20,
        registry=None,
    ) -> None:
        super().__init__(registry)
        self.host = host
        self.codec = codec or default_codec()
        # Messages whose encoded size exceeds this ride the chunked bulk
        # path (0 disables segmentation: everything coalesces as before).
        self.max_frame_bytes = int(max_frame_bytes)
        self._listener: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._peers: list[SocketPeer] = []
        self._closed = False

    def serve(self, handlers, *, on_connect=None, on_disconnect=None) -> str:
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind((self.host, 0))
        listener.listen(64)
        self._listener = listener
        port = listener.getsockname()[1]
        address = f"tcp://{self.host}:{port}"

        def accept_loop() -> None:
            n = 0
            while not self._closed:
                try:
                    sock, addr = listener.accept()
                except OSError:
                    return
                n += 1
                peer = SocketPeer(sock, handlers, self, f"{address}<-{addr[1]}")
                peer.on_disconnect = on_disconnect
                with self._lock:
                    self._peers.append(peer)
                if on_connect is not None:
                    on_connect(peer)

        self._accept_thread = threading.Thread(
            target=accept_loop, daemon=True, name=f"bus-accept-{port}"
        )
        self._accept_thread.start()
        return address

    def connect(self, address: str, handlers=None) -> Peer:
        host, port = address.removeprefix("tcp://").rsplit(":", 1)
        sock = socket.create_connection((host, int(port)), timeout=30.0)
        sock.settimeout(None)
        peer = SocketPeer(sock, handlers or {}, self, f"->{address}")
        with self._lock:
            self._peers.append(peer)
        return peer

    def stats(self) -> dict[str, Any]:
        """Aggregate + per-peer delivery counters.  ``send_errors`` /
        ``dropped_notifies`` surface fire-and-forget losses that would
        otherwise vanish silently with the dead peer."""
        out = super().stats()
        with self._lock:
            peers = list(self._peers)
        out["send_errors"] = sum(p.send_errors for p in peers)
        out["dropped_notifies"] = sum(p.dropped_notifies for p in peers)
        out["peers"] = {
            p.name: {
                "sent_messages": p.sent_messages,
                "recv_messages": p.recv_messages,
                "send_errors": p.send_errors,
                "dropped_notifies": p.dropped_notifies,
            }
            for p in peers
        }
        return out

    def close(self) -> None:
        self._closed = True
        if self._listener is not None:
            # On Linux, close() alone does not wake a thread blocked in
            # accept(), and that thread's loop holds the handlers (a
            # ManagerEndpoint and its Manager, with every stage output):
            # shutdown() makes accept() fail, so the loop returns.
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._listener.close()
            except OSError:
                pass
            if self._accept_thread not in (None, threading.current_thread()):
                self._accept_thread.join(timeout=5.0)
        with self._lock:
            peers = list(self._peers)
        for peer in peers:
            peer.close()
