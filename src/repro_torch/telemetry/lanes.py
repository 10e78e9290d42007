"""Tracing inside a worker's lanes: where an op waits, what the lane does
between ops, and the interpreter's collection pauses.

A ``WorkerRuntime`` with a tracer builds one :class:`LaneTrace`; without
one it builds none and pays nothing. Every span goes to that runtime's
``Tracer`` in its schema (``SPAN_KEYS``): ``ts`` on ``time.time``,
``dur`` on ``time.perf_counter``, as the Worker's ``op:*`` spans, and
``args.chunk`` the tile where the span belongs to one.

* ``wait:op`` -- an op instance ready in the worker's queue, from its
  push on the ``ReadyScheduler`` until a lane took it.
* ``lane:between`` -- a lane from an op's end to its next op's start:
  the commit, the Manager's completion callback and dispatch, the pop.
  Its args name the op that ended, with what that op noted
  (:meth:`OpTrace.note`: the card's allocator counts across it).
* ``sync`` (``args.site``) -- a blocking device-to-host read inside an
  op, recorded by the application through :meth:`OpTrace.span`.
* ``gc`` (``args.generation``) -- a collection of the interpreter,
  which holds every thread; it belongs to no tile.
* ``wait:lease`` (``args.stage``) -- a stage instance in the Manager's
  pending queue until its lease (:func:`mark_pending`,
  :func:`record_lease_wait`).
* ``release`` (``args.bytes``) -- a worker dropping the outputs of a
  finished chunk, and the tensor bytes they held (:func:`record_release`,
  ``WorkerRuntime.release_ops``).

No name begins with ``op:``: what reads the ``op:*`` spans reads the
Worker's own. Spans belong to a sampled stage context, as the Worker's.
"""

from __future__ import annotations

import gc
import threading
import time
import uuid
from typing import Any, Optional

from .tracing import SpanContext, current_context

__all__ = ["LaneTrace", "OpTrace", "current_op", "mark_pending", "record_lease_wait",
           "record_release"]

#: Collections held back for the tracer at most (see ``LaneTrace._on_gc``).
GC_BACKLOG = 4096

_tls = threading.local()


def current_op() -> Optional["OpTrace"]:
    """The traced op the calling thread is running, or None."""
    return getattr(_tls, "op", None)


class OpTrace:
    """The op a lane runs, for spans recorded from inside it."""

    __slots__ = ("tracer", "ctx", "uid", "chunk", "name", "tid", "notes")

    def __init__(self, tracer, ctx: SpanContext, oi, tid: str) -> None:
        self.tracer, self.ctx, self.tid = tracer, ctx, tid
        self.uid, self.chunk, self.name = oi.uid, oi.chunk.chunk_id, oi.op.name
        self.notes: dict[str, Any] = {}

    def args(self) -> dict[str, Any]:
        return {"chunk": self.chunk, "uid": self.uid, "op": self.name, **self.notes}

    def note(self, **values: Any) -> None:
        """Values of this op carried on its ``lane:between`` span."""
        self.notes.update(values)

    def span(self, name: str, ts: float, dur: float, **args: Any) -> None:
        _record(self.tracer, self.ctx, name, ts, dur, self.tid,
                {"chunk": self.chunk, "uid": self.uid, **args})


def _record(tracer, ctx: SpanContext, name: str, ts: float, dur: float, tid: str,
            args: dict[str, Any]) -> None:
    tracer.record_span(name, ctx=tracer.child(ctx), parent=ctx.span_id, cat="lane",
                       ts=ts, dur=dur, tid=tid, args=args)


class LaneTrace:
    """The lane spans of one traced ``WorkerRuntime``.

    The runtime calls :meth:`started` on a lane's thread when the lane
    has taken its ops, :meth:`ended` when they returned, and
    :meth:`close` at ``stop()``. The ready time comes from the
    scheduler's ``push``, wrapped here.
    """

    def __init__(self, rt) -> None:
        self.tracer = rt.tracer
        self._lane = threading.local()      # per lane thread: the last op's end
        push = rt.scheduler.push

        def stamped(oi) -> None:
            oi._ready_at = (time.time(), time.perf_counter())  # type: ignore[attr-defined]
            push(oi)

        rt.scheduler.push = stamped
        self._gc_ctx = SpanContext(uuid.uuid4().hex[:16], "0" * 16, True)
        self._gc_start: Optional[tuple[float, float]] = None
        self._gc_done: list[tuple[float, float, int]] = []
        gc.callbacks.append(self._on_gc)

    def started(self, lane, ois: list) -> None:
        now_p = time.perf_counter()
        tid = f"{lane.spec.kind}{lane.spec.index}"
        for oi in ois:
            ctx, ready = getattr(oi, "_trace_ctx", None), getattr(oi, "_ready_at", None)
            if ctx is not None and ready is not None:
                _record(self.tracer, ctx, "wait:op", ready[0], now_p - ready[1], tid,
                        {"chunk": oi.chunk.chunk_id, "uid": oi.uid, "op": oi.op.name})
        last, self._lane.last = getattr(self._lane, "last", None), None
        if last is not None:
            op, end_w, end_p = last
            _record(self.tracer, op.ctx, "lane:between", end_w, now_p - end_p, tid, op.args())
        ctx = getattr(ois[0], "_trace_ctx", None)
        _tls.op = OpTrace(self.tracer, ctx, ois[0], tid) if ctx is not None else None
        self._flush_gc()

    def ended(self, end_w: float, end_p: float) -> None:
        op, _tls.op = current_op(), None
        self._lane.last = (op, end_w, end_p) if op is not None else None

    def close(self) -> None:
        """Stop watching the collector; record what it did until now."""
        if self._on_gc in gc.callbacks:
            gc.callbacks.remove(self._on_gc)
        self._flush_gc()

    # A collection can start on any thread at any allocation, also while
    # that thread holds the tracer's lock: the callback only notes the
    # times, and a lane records them at its next op.
    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_start = (time.time(), time.perf_counter())
        elif self._gc_start is not None and len(self._gc_done) < GC_BACKLOG:
            ts, t0 = self._gc_start
            self._gc_done.append((ts, time.perf_counter() - t0, info["generation"]))
            self._gc_start = None

    def _flush_gc(self) -> None:
        if not self._gc_done:
            return
        done, self._gc_done = self._gc_done, []
        for ts, dur, generation in done:
            _record(self.tracer, self._gc_ctx, "gc", ts, dur, "gc", {"generation": generation})


def mark_pending(si) -> None:
    """A stage instance enters the Manager's pending queue."""
    si._pending_at = (time.time(), time.perf_counter())


def record_lease_wait(tracer, ctx: Optional[SpanContext], si, worker: int) -> None:
    """The ``wait:lease`` span of a stage instance the Manager leases now."""
    since = getattr(si, "_pending_at", None)
    if ctx is None or not ctx.sampled or since is None:
        return
    _record(tracer, ctx, "wait:lease", since[0], time.perf_counter() - since[1], "manager",
            {"chunk": si.chunk.chunk_id, "stage": si.stage.name, "uid": si.uid,
             "worker": worker})


def record_release(tracer, ts: float, dur: float, chunk: Any, nbytes: int) -> None:
    """The ``release`` span of a worker dropping a finished chunk's
    outputs, in the context of the stage whose completion finished it."""
    ctx = current_context()
    if ctx is None or not ctx.sampled:
        return
    _record(tracer, ctx, "release", ts, dur, "release", {"chunk": chunk, "bytes": nbytes})
