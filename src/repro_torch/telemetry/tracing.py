"""Distributed tracing: span context over the bus, sampled per trace.

A :class:`SpanContext` (``trace_id``, ``span_id``, sampled flag) rides
a thread-local; :class:`TracingBus` — a decorator over any
``MessageBus``, identity-stable like ``repro.faults.FaultyBus`` —
injects it into call/notify payloads as a ``{"__trace__": ..., "p":
payload}`` envelope and re-establishes it around the remote handler,
so one request's timeline stitches across processes.

Sampling is decided **once**, at the trace root
(:meth:`Tracer.start_trace`), and the decision travels in the
envelope: either every hop of a request records spans or none does,
which is what makes a sampled timeline complete end to end.

Spans are plain wire-safe dicts (see :data:`SPAN_KEYS`) collected in a
bounded per-process buffer; ``ts`` is wall-clock (``time.time``) so
spans from different machines line up on one Perfetto timeline, while
durations are measured with ``time.perf_counter`` so a wall-clock step
cannot corrupt them.

Data-plane methods carrying region bytes (:data:`UNTRACED_METHODS`)
are never enveloped: wrapping a multi-megabyte ndarray payload in a
dict would defeat ``SocketBus``'s size-based segmentation and CRC
sealing.  Their timelines come from the runtime's own ``region:*``
spans instead.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional

from ..transport.bus import Handler, MessageBus, Peer

__all__ = [
    "SpanContext",
    "Tracer",
    "TracingBus",
    "TracingPeer",
    "current_context",
    "set_context",
    "use_context",
    "UNTRACED_METHODS",
    "SPAN_KEYS",
]

# Methods whose payloads carry raw region bytes (or CRC-sealed frames):
# enveloping them would break segmentation sizing and sealing, so the
# context stops at the control plane and the runtime emits ``region:*``
# spans for the data plane itself.
UNTRACED_METHODS = frozenset(
    {"push_region", "pull_region", "pull_regions", "forward_inputs",
     "provide_input"}
)

# The span schema shared by the real tracer and the simulator mirror.
SPAN_KEYS = ("name", "cat", "trace", "span", "parent", "service", "ts",
             "dur", "tid", "args")

_ENVELOPE = "__trace__"

_tls = threading.local()


def current_context() -> Optional["SpanContext"]:
    return getattr(_tls, "ctx", None)


def set_context(ctx: Optional["SpanContext"]) -> Optional["SpanContext"]:
    """Install ``ctx`` as the calling thread's context; returns the
    previous one so callers can restore it."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    return prev


class use_context:
    """Install ``ctx`` for the duration of a ``with`` block.  A slotted
    class rather than a generator contextmanager: this sits on the
    per-request submit path, where the generator machinery's ~2us is
    measurable against the <=2% telemetry overhead budget."""

    __slots__ = ("_ctx", "_prev")

    def __init__(self, ctx: Optional["SpanContext"]) -> None:
        self._ctx = ctx

    def __enter__(self) -> None:
        self._prev = set_context(self._ctx)

    def __exit__(self, *exc: object) -> None:
        set_context(self._prev)


@dataclass(frozen=True)
class SpanContext:
    """Identity of one node in a trace tree, as carried on the wire."""

    trace_id: str
    span_id: str
    sampled: bool = True

    def to_wire(self) -> dict[str, Any]:
        return {"t": self.trace_id, "s": self.span_id}

    @classmethod
    def from_wire(cls, env: Any) -> Optional["SpanContext"]:
        if not isinstance(env, dict):
            return None
        t, s = env.get("t"), env.get("s")
        if not isinstance(t, str) or not isinstance(s, str):
            return None
        # Only sampled contexts are ever put on the wire.
        return cls(t, s, True)


def _new_id(rng: random.Random) -> str:
    return f"{rng.getrandbits(64):016x}"


# Shared identity for every unsampled trace (see Tracer.start_trace).
_UNSAMPLED = SpanContext("0" * 16, "0" * 16, False)


class Tracer:
    """Per-process span factory + bounded buffer.

    ``service`` names the process role (``manager``, ``worker3``,
    ``sim``) and becomes the Chrome-trace ``pid`` row.  ``sample_rate``
    applies only to :meth:`start_trace` — contexts arriving from the
    wire were already sampled upstream.  Finished spans optionally feed
    an attached :class:`~repro.telemetry.recorder.FlightRecorder` so a
    postmortem dump carries the most recent timeline.
    """

    def __init__(
        self,
        service: str = "repro",
        *,
        sample_rate: float = 1.0,
        capacity: int = 8192,
        recorder: Optional[Any] = None,
        seed: Optional[int] = None,
    ) -> None:
        self.service = service
        self.sample_rate = float(sample_rate)
        self.recorder = recorder
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._spans: deque[dict[str, Any]] = deque(maxlen=capacity)
        self.spans_recorded = 0
        self.traces_started = 0
        self.traces_sampled = 0

    # -- context management -------------------------------------------
    def start_trace(self) -> SpanContext:
        """Root a new trace; the sampling decision made here travels
        with the context to every downstream hop."""
        with self._lock:
            self.traces_started += 1
            if self._rng.random() >= self.sample_rate:
                # Unsampled traces never record and never cross the
                # wire, so they share one anonymous identity — no id
                # generation on the 90%-unsampled fast path.
                return _UNSAMPLED
            self.traces_sampled += 1
            return SpanContext(_new_id(self._rng), _new_id(self._rng), True)

    def child(self, parent: SpanContext) -> SpanContext:
        if not parent.sampled:
            return parent  # nothing downstream records: no id needed
        with self._lock:
            return SpanContext(parent.trace_id, _new_id(self._rng), True)

    # -- span recording -----------------------------------------------
    def record_span(
        self,
        name: str,
        *,
        ctx: SpanContext,
        parent: Optional[str] = None,
        cat: str = "op",
        ts: Optional[float] = None,
        dur: float = 0.0,
        tid: str = "main",
        args: Optional[dict[str, Any]] = None,
    ) -> Optional[dict[str, Any]]:
        """Record one completed span with explicit timing.  ``ts`` is a
        wall-clock epoch second (defaults to now); ``dur`` is seconds.
        Unsampled contexts record nothing."""
        if ctx is None or not ctx.sampled:
            return None
        span = {
            "name": name,
            "cat": cat,
            "trace": ctx.trace_id,
            "span": ctx.span_id,
            "parent": parent,
            "service": self.service,
            "ts": time.time() if ts is None else ts,
            "dur": float(dur),
            "tid": tid,
            "args": dict(args) if args else {},
        }
        with self._lock:
            self._spans.append(span)
            self.spans_recorded += 1
        if self.recorder is not None:
            self.recorder.note("span", **span)
        return span

    @contextmanager
    def span(
        self,
        name: str,
        *,
        cat: str = "op",
        tid: str = "main",
        args: Optional[dict[str, Any]] = None,
        ctx: Optional[SpanContext] = None,
    ) -> Iterator[Optional[SpanContext]]:
        """Open a span under ``ctx`` (default: the thread's current
        context), making the new span the current context for the body
        so nested spans / outbound RPCs chain off it.  No-op (yields
        None) when there is no sampled context."""
        parent = ctx if ctx is not None else current_context()
        if parent is None or not parent.sampled:
            yield None
            return
        child = self.child(parent)
        ts = time.time()
        t0 = time.perf_counter()
        prev = set_context(child)
        try:
            yield child
        finally:
            set_context(prev)
            self.record_span(
                name,
                ctx=child,
                parent=parent.span_id,
                cat=cat,
                ts=ts,
                dur=time.perf_counter() - t0,
                tid=tid,
                args=args,
            )

    # -- inspection ----------------------------------------------------
    def spans(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "spans_recorded": self.spans_recorded,
                "spans_buffered": len(self._spans),
                "traces_started": self.traces_started,
                "traces_sampled": self.traces_sampled,
            }


def _extract(payload: Any) -> tuple[Optional[SpanContext], Any]:
    """Split a possibly-enveloped payload into (context, inner payload)."""
    if isinstance(payload, dict) and _ENVELOPE in payload:
        ctx = SpanContext.from_wire(payload[_ENVELOPE])
        return ctx, payload.get("p")
    return None, payload


class TracingPeer(Peer):
    """Peer wrapper injecting the current trace context into outbound
    control-plane messages."""

    def __init__(self, inner: Peer, bus: "TracingBus") -> None:
        self._inner = inner
        self._bus = bus

    @property
    def name(self) -> str:  # type: ignore[override]
        return self._inner.name

    @property
    def alive(self) -> bool:
        return self._inner.alive

    def close(self) -> None:
        self._inner.close()

    def _envelope(self, method: str, payload: Any) -> tuple[Any, Optional[SpanContext]]:
        ctx = current_context()
        if (
            ctx is None
            or not ctx.sampled
            or method in UNTRACED_METHODS
            or (isinstance(payload, dict) and _ENVELOPE in payload)
        ):
            return payload, None
        child = self._bus.tracer.child(ctx)
        return {_ENVELOPE: child.to_wire(), "p": payload}, ctx

    def call(self, method: str, payload: Any = None, *, timeout: float = 30.0) -> Any:
        sent, parent = self._envelope(method, payload)
        if parent is None:
            return self._inner.call(method, sent, timeout=timeout)
        child = SpanContext.from_wire(sent[_ENVELOPE])
        ts = time.time()
        t0 = time.perf_counter()
        try:
            return self._inner.call(method, sent, timeout=timeout)
        finally:
            # The client-side view of the round trip; the server records
            # its own handler span under the same span id, so the gap
            # between the two is the wire + queueing time.
            self._bus.tracer.record_span(
                f"call:{method}",
                ctx=child,
                parent=parent.span_id,
                cat="rpc",
                ts=ts,
                dur=time.perf_counter() - t0,
                tid="bus",
            )

    def notify(self, method: str, payload: Any = None) -> None:
        sent, _ = self._envelope(method, payload)
        self._inner.notify(method, sent)


class TracingBus(MessageBus):
    """Decorator bus carrying trace context across the wire.

    Same identity-stable wrapping discipline as ``FaultyBus``: one
    :class:`TracingPeer` per inner peer, both directions, because
    endpoints key routing tables by peer identity.  Handlers see
    un-enveloped payloads; while a handler for an enveloped message
    runs, the sender's context is installed on the dispatcher thread
    (with a ``handle:<method>`` span around it), so any work — or any
    further RPC — the handler triggers inherits the trace.
    """

    def __init__(self, inner: MessageBus, tracer: Tracer) -> None:
        # Deliberately not calling MessageBus.__init__: the traffic
        # counters delegate to the inner bus (see properties below).
        self._inner_bus = inner
        self.tracer = tracer
        self._wrap_lock = threading.Lock()
        self._wrapped: dict[int, TracingPeer] = {}

    # -- counter delegation ------------------------------------------
    @property
    def messages_sent(self):  # type: ignore[override]
        return self._inner_bus.messages_sent

    @property
    def frames_sent(self):  # type: ignore[override]
        return self._inner_bus.frames_sent

    @property
    def registry(self):
        return self._inner_bus.registry

    # -- peer wrapping ------------------------------------------------
    def _wrap(self, peer: Peer) -> TracingPeer:
        if isinstance(peer, TracingPeer):
            return peer
        with self._wrap_lock:
            got = self._wrapped.get(id(peer))
            if got is None:
                got = TracingPeer(peer, self)
                self._wrapped[id(peer)] = got
            return got

    def _wrap_handlers(
        self, handlers: Optional[dict[str, Handler]]
    ) -> Optional[dict[str, Handler]]:
        if handlers is None:
            return None

        def bind(method: str, h: Handler) -> Handler:
            def handle(peer: Peer, payload: Any) -> Any:
                ctx, inner = _extract(payload)
                wrapped = self._wrap(peer)
                if ctx is None:
                    return h(wrapped, inner)
                with use_context(ctx):
                    with self.tracer.span(
                        f"handle:{method}", cat="rpc", tid="bus"
                    ):
                        return h(wrapped, inner)

            return handle

        return {m: bind(m, h) for m, h in handlers.items()}

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
        return self._wrap(
            self._inner_bus.connect(address, self._wrap_handlers(handlers))
        )

    def close(self) -> None:
        self._inner_bus.close()

    def stats(self) -> dict[str, Any]:
        out = self._inner_bus.stats()
        out.update(self.tracer.stats())
        return out
