"""``FaultyBus`` — a fault-injecting decorator over any ``MessageBus``.

Every peer the inner bus hands out (client side from ``connect``,
server side inside handler/``on_connect``/``on_disconnect`` callbacks)
is wrapped in a :class:`FaultyPeer`, so all traffic in both directions
passes through the :class:`~repro.faults.plan.FaultPlan`'s decisions:

* notifies may be dropped, duplicated, or delayed (reordering emerges
  from independent random delays on an ordered channel);
* calls may fail fast with ``BusTimeoutError``;
* data-plane payloads may be corrupted (after CRC sealing — exactly
  the in-transit corruption the integrity layer must catch);
* peers matching a scheduled kill are closed, emulating process death;
* partitioned peers blackhole notifies and time out calls.

Wrapping is identity-stable (one ``FaultyPeer`` per inner peer) because
endpoints key routing tables by peer object identity and compare with
``is`` on disconnect.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Optional

from .plan import FaultPlan
from ..transport.bus import BusTimeoutError, Handler, MessageBus, Peer


class FaultyPeer(Peer):
    """Peer wrapper applying a :class:`FaultPlan` to outbound traffic."""

    def __init__(self, inner: Peer, plan: FaultPlan, bus: "FaultyBus") -> None:
        self._inner = inner
        self._plan = plan
        self._bus = bus

    @property
    def name(self) -> str:  # type: ignore[override]
        return self._inner.name

    @property
    def alive(self) -> bool:
        return self._inner.alive

    def close(self) -> None:
        self._inner.close()

    def _pre_send(self, method: str) -> bool:
        """Common kill/partition gate.  Returns True if send may proceed."""
        plan = self._plan
        if plan.kill_due(self.name):
            self._bus.injected_kills += 1
            self._inner.close()
        if not self._inner.alive:
            # Let the inner peer raise its own BusClosedError on call;
            # notifies to a closed peer are silently dropped (matching
            # the fire-and-forget contract).
            return True
        if plan.partitioned(self.name):
            return False
        return True

    def call(self, method: str, payload: Any = None, *, timeout: float = 30.0) -> Any:
        plan = self._plan
        if not self._pre_send(method):
            self._bus.injected_call_failures += 1
            raise BusTimeoutError(f"{self.name}: partitioned (injected)")
        if plan.should_fail_call(method):
            self._bus.injected_call_failures += 1
            raise BusTimeoutError(f"{self.name}: no reply to {method!r} (injected)")
        sent = plan.maybe_corrupt(method, payload)
        if sent is not payload:
            self._bus.corrupted += 1
        result = self._inner.call(method, sent, timeout=timeout)
        out = plan.maybe_corrupt(method, result)
        if out is not result:
            self._bus.corrupted += 1
        return out

    def notify(self, method: str, payload: Any = None) -> None:
        plan = self._plan
        if not self._pre_send(method):
            self._bus.injected_drops += 1
            return
        if plan.should_drop(method):
            self._bus.injected_drops += 1
            return
        sent = plan.maybe_corrupt(method, payload)
        if sent is not payload:
            self._bus.corrupted += 1
        copies = 1
        if plan.should_dup(method):
            self._bus.injected_dups += 1
            copies = 2
        delay = plan.delay_for(method)
        if delay > 0.0:
            self._bus.injected_delays += 1
            t = threading.Timer(delay, self._late_notify, (method, sent, copies))
            t.daemon = True
            t.start()
            return
        self._late_notify(method, sent, copies)

    def _late_notify(self, method: str, payload: Any, copies: int) -> None:
        for _ in range(copies):
            try:
                self._inner.notify(method, payload)
            except Exception:
                # Delivery failure after injection is the inner bus's
                # problem; notify is fire-and-forget either way.
                return


class FaultyBus(MessageBus):
    """Decorator bus: same contract as the inner bus, plus injected faults."""

    def __init__(self, inner: MessageBus, plan: FaultPlan) -> None:
        # Deliberately not calling MessageBus.__init__: the traffic
        # counters delegate to the inner bus (see properties below).
        self._inner_bus = inner
        self.plan = plan
        self._wrap_lock = threading.Lock()
        self._wrapped: dict[int, FaultyPeer] = {}
        self.injected_drops = 0
        self.injected_dups = 0
        self.injected_delays = 0
        self.injected_call_failures = 0
        self.injected_kills = 0
        self.corrupted = 0

    # -- counter delegation ------------------------------------------
    @property
    def messages_sent(self) -> int:  # type: ignore[override]
        return self._inner_bus.messages_sent

    @property
    def frames_sent(self) -> int:  # type: ignore[override]
        return self._inner_bus.frames_sent

    # -- peer wrapping ------------------------------------------------
    def _wrap(self, peer: Peer) -> FaultyPeer:
        if isinstance(peer, FaultyPeer):
            return peer
        with self._wrap_lock:
            got = self._wrapped.get(id(peer))
            if got is None:
                got = FaultyPeer(peer, self.plan, self)
                self._wrapped[id(peer)] = got
            return got

    def _wrap_handlers(
        self, handlers: Optional[dict[str, Handler]]
    ) -> Optional[dict[str, Handler]]:
        if handlers is None:
            return None

        def bind(h: Handler) -> Handler:
            return lambda peer, payload: h(self._wrap(peer), payload)

        return {m: bind(h) for m, h in handlers.items()}

    def _wrap_cb(
        self, cb: Optional[Callable[[Peer], None]]
    ) -> Optional[Callable[[Peer], None]]:
        if cb is None:
            return None
        return lambda peer: cb(self._wrap(peer))

    # -- MessageBus contract ------------------------------------------
    def serve(
        self,
        handlers: dict[str, Handler],
        *,
        on_connect: Optional[Callable[[Peer], None]] = None,
        on_disconnect: Optional[Callable[[Peer], None]] = None,
    ) -> str:
        return self._inner_bus.serve(
            self._wrap_handlers(handlers),
            on_connect=self._wrap_cb(on_connect),
            on_disconnect=self._wrap_cb(on_disconnect),
        )

    def connect(
        self, address: str, handlers: Optional[dict[str, Handler]] = None
    ) -> Peer:
        return self._wrap(self._inner_bus.connect(address, self._wrap_handlers(handlers)))

    def close(self) -> None:
        self._inner_bus.close()

    def stats(self) -> dict[str, Any]:
        out = self._inner_bus.stats()
        out.update(
            injected_drops=self.injected_drops,
            injected_dups=self.injected_dups,
            injected_delays=self.injected_delays,
            injected_call_failures=self.injected_call_failures,
            injected_kills=self.injected_kills,
            corrupted=self.corrupted,
        )
        return out
