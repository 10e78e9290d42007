"""Manager/Worker control-plane endpoints over a MessageBus.

The Manager no longer has to be handed :class:`WorkerRuntime` objects
directly: a :class:`ManagerEndpoint` serves its RPCs
(register / lease / complete / heartbeat / region-pull) on any
:class:`~repro.transport.bus.MessageBus`, and a
:class:`WorkerClient` bridges a WorkerRuntime — in this process or in
another OS process — onto the same bus.  On the Manager's side each
connected worker appears as a :class:`WorkerProxy` that quacks like
the WorkerRuntime subset the Manager uses, so ``core/manager.py``
needs no backend-specific code.

RPC surface
-----------

worker -> manager: ``register_worker`` (carries the worker's data-plane
address), ``heartbeat`` (notify), ``stage_complete`` (notify),
``fetch_region`` / ``fetch_regions`` (region pull *relayed through the
coordinator* — fallback only), ``resolve_regions`` (request — holder
lookup for the direct data plane: metadata out, bytes never through
the Manager), ``region_staged`` (notify — a pushed replica landed,
journal it), ``region_drop`` (notify — keeps the placement directory
honest), ``deregister_worker``.

manager -> worker: ``submit_stage`` (notify), ``cancel_stage``
(notify), ``provide_input`` (notify), ``forward_inputs`` (request —
one batched round-trip replaces a per-dependency mark/provide chat),
``pull_region`` (request — failover refetch), ``push_request``
(notify — predictive push: this worker holds a region the predicted
next holder is missing; ship it over the data plane, racing ahead of
the lease dispatch), ``region_invalidate`` (notify — stale-holder
cache invalidation), ``get_stats`` (request), ``stop``.

worker <-> worker (the coordinator-bypass data plane, served by every
:class:`WorkerClient` on its own bus address): ``pull_region`` /
``pull_regions`` (sibling region pull — bulk bytes skip the Manager)
and ``push_region`` (notify — predictive push of sink outputs into the
target's host tier ahead of its lease).

For multiprocess deployments :func:`spawn_worker` launches
:func:`worker_main` in a fresh OS process (spawn context, so jax/BLAS
thread state is never forked mid-flight) from a picklable
:class:`WorkerSpec` naming a module-level registry factory.
"""

from __future__ import annotations

import importlib
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from .bus import BusClosedError, BusError, BusTimeoutError, MessageBus, Peer
from ..faults.integrity import seal as _seal, unseal as _unseal
from ..faults.retry import RetryPolicy
from ..staging.journal import decode_key as _as_key
from ..staging.tiers import sizeof as _sizeof

__all__ = [
    "ManagerEndpoint",
    "ServingClient",
    "WorkerProxy",
    "WorkerClient",
    "WorkerSpec",
    "spawn_worker",
    "worker_main",
]


class ServingClient:
    """Remote tenant's handle on a serving Manager endpoint.

    Streams tile requests over the bus (``submit_request``) and polls
    their fate (``request_status``) — the out-of-process face of
    :class:`repro.serving.RequestGateway`.
    """

    def __init__(
        self, bus: "MessageBus", address: str, *, timeout: float = 10.0
    ) -> None:
        self.peer = bus.connect(address, {})
        self.timeout = timeout

    def submit(
        self,
        chunk_id: int,
        tenant: str = "default",
        deadline_ms: Optional[float] = None,
        cost_s: Optional[float] = None,
    ) -> dict:
        return self.peer.call(
            "submit_request",
            {
                "chunk_id": int(chunk_id),
                "tenant": tenant,
                "deadline_ms": deadline_ms,
                "cost_s": cost_s,
            },
            timeout=self.timeout,
        )

    def status(self, req_id: int) -> dict:
        return self.peer.call("request_status", int(req_id), timeout=self.timeout)

    def close(self) -> None:
        self.peer.close()


class _ProxyStore:
    """Minimal stand-in for a remote worker's RegionStore.

    The Manager only touches ``on_drop`` (wired to the directory) and
    ``tier("host")`` (replication-aware eviction — served remotely by
    the worker's own store, so the proxy declines).
    """

    def __init__(self) -> None:
        self.on_drop: Optional[Callable[[Any], None]] = None

    def tier(self, name: str):
        raise KeyError(name)

    def stats(self) -> dict:
        return {}


class WorkerProxy:
    """The Manager-side face of a bus-connected worker."""

    def __init__(
        self,
        worker_id: int,
        peer: Peer,
        *,
        has_agent: bool,
        data_address: Any = None,
        rpc_timeout: float = 10.0,
    ) -> None:
        self.worker_id = worker_id
        self.peer = peer
        # Tight per-call budget (ManagerConfig.rpc_timeout): a hung
        # worker must surface as BusTimeoutError fast, not hold the
        # Manager's dispatch path for the bus default 30s.
        self.rpc_timeout = rpc_timeout
        # Manager checks ``getattr(rt, "agent", None) is not None`` to
        # pick push vs agent-pull input forwarding.
        self.agent = True if has_agent else None
        # Bus address siblings dial for region bytes (None = this worker
        # serves no data plane; everything relays through the Manager).
        self.data_address = data_address
        self.store = _ProxyStore()
        # Assigned by Manager.register_worker; the endpoint routes
        # incoming notifies through these.
        self.on_stage_complete: Optional[Callable] = None
        self.on_stage_failed: Optional[Callable] = None
        self.on_heartbeat: Optional[Callable] = None
        self.fetch_region: Optional[Callable] = None   # unused remotely
        self.fetch_regions: Optional[Callable] = None  # (worker pulls via bus)
        self._dead = False

    @property
    def alive(self) -> bool:
        return not self._dead and self.peer.alive

    def mark_dead(self) -> None:
        self._dead = True

    # -- WorkerRuntime protocol (Manager-facing subset) --------------------

    def submit_stage(self, si) -> None:
        self._send("submit_stage", si)

    def cancel_stage(self, si_uid: int) -> None:
        self._send("cancel_stage", si_uid)

    def provide_input(self, uid: int, value: Any) -> None:
        self._send("provide_input", (uid, value))

    def mark_staged_input(self, uid: int) -> bool:
        staged = self.forward_inputs([(uid, None, False)])
        return uid in staged

    def forward_inputs(self, items) -> set[int]:
        """One batched round-trip: mark already-staged inputs, push the
        rest.  Returns the uids that were already staged remotely."""
        try:
            return set(
                self.peer.call(
                    "forward_inputs", tuple(items), timeout=self.rpc_timeout
                )
            )
        except BusTimeoutError:
            return set()  # slow, not dead: inputs re-pull via the agent
        except BusError:
            self._dead = True
            return set()

    def pull_region(self, key: Any) -> Any:
        try:
            # Short timeout: a region pull may run on the Manager's
            # dispatch path, so a hung holder must fail fast.
            return self.peer.call("pull_region", key, timeout=self.rpc_timeout)
        except BusTimeoutError:
            return None  # slow, not dead: the heartbeat monitor decides
        except BusError:
            self._dead = True
            return None

    def invalidate_region(self, key: Any, worker_id: int) -> None:
        """Stale-holder broadcast: ``worker_id`` dropped ``key``; the
        worker behind this proxy must purge its directory cache."""
        self._send("region_invalidate", (key, worker_id))

    def push_region_to(self, key: Any, address: Any) -> None:
        """Predictive push by a non-completing holder: this worker holds
        ``key`` and should push it to the sibling at ``address`` (the
        predicted next holder) — metadata from the Manager, bytes
        worker-to-worker."""
        self._send("push_request", (key, address))

    def stats(self) -> dict:
        """Remote runtime + transport counters (benchmarks/tests)."""
        try:
            return dict(self.peer.call("get_stats", timeout=self.rpc_timeout))
        except BusError:
            return {}

    def trace(self) -> dict:
        """Remote telemetry: buffered spans + flight-recorder dumps."""
        try:
            return dict(self.peer.call("get_trace", timeout=self.rpc_timeout))
        except BusError:
            return {}

    def shutdown(self, timeout: float = 5.0) -> None:
        try:
            self.peer.call("stop", timeout=timeout)
        except BusError:
            pass
        self.peer.close()

    def _send(self, method: str, payload: Any) -> None:
        try:
            self.peer.notify(method, payload)
        except BusError:
            self._dead = True


class ManagerEndpoint:
    """Serves a Manager's control plane on a MessageBus."""

    def __init__(self, manager, bus: MessageBus, gateway=None) -> None:
        self.manager = manager
        self.bus = bus
        # Optional serving front end (repro.serving.RequestGateway):
        # when attached, clients can stream tile requests over the bus
        # (submit_request / request_status) instead of calling the
        # gateway in-process.
        self.gateway = gateway
        self.proxies: dict[int, WorkerProxy] = {}
        self._peer_worker: dict[Peer, int] = {}
        self._lock = threading.Lock()
        self._registered = threading.Condition(self._lock)
        # Region payloads served through the coordinator (the relay
        # fallback).  ~0 on the happy path: the data plane dials
        # siblings directly and only metadata crosses this endpoint.
        # Registered into the Manager's metrics registry when it has
        # one, so cluster snapshots include the relay traffic.
        metrics = getattr(manager, "metrics", None)
        if metrics is not None:
            self.relay_regions = metrics.counter("endpoint.relay_regions")
            self.relay_bytes = metrics.counter("endpoint.relay_bytes")
        else:
            self.relay_regions = 0
            self.relay_bytes = 0
        # key -> worker ids that resolved it: only THEIR holder caches
        # can name it, so region_drop invalidations go to them alone
        # (not an O(workers) broadcast per drop).  Entries die with the
        # invalidation; a re-resolve re-registers.
        self._resolvers: dict[Any, set[int]] = {}
        self.address = bus.serve(
            {
                "register_worker": self._h_register,
                "deregister_worker": self._h_deregister,
                "heartbeat": self._h_heartbeat,
                "stage_complete": self._h_stage_complete,
                "stage_failed": self._h_stage_failed,
                "fetch_region": self._h_fetch_region,
                "fetch_regions": self._h_fetch_regions,
                "resolve_regions": self._h_resolve_regions,
                "region_staged": self._h_region_staged,
                "region_drop": self._h_region_drop,
                "submit_request": self._h_submit_request,
                "request_status": self._h_request_status,
                "get_stats": self._h_get_stats,
                "get_trace": self._h_get_trace,
            },
            on_disconnect=self._on_disconnect,
        )

    def attach_gateway(self, gateway) -> None:
        """Late-bind the serving gateway (it needs the Manager first)."""
        self.gateway = gateway

    # -- lifecycle ---------------------------------------------------------

    def wait_workers(self, n: int, timeout: float = 60.0) -> bool:
        """Block until ``n`` workers registered (process startup barrier)."""
        deadline = time.monotonic() + timeout
        with self._registered:
            while len(self.proxies) < n:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._registered.wait(timeout=remaining)
        return True

    def shutdown_workers(self) -> None:
        with self._lock:
            proxies = list(self.proxies.values())
        for proxy in proxies:
            proxy.shutdown()

    def close(self) -> None:
        self.shutdown_workers()
        self.bus.close()

    # -- handlers (worker -> manager) --------------------------------------

    def _h_register(self, peer: Peer, payload: Any):
        wid = int(payload["worker_id"])
        proxy = WorkerProxy(
            wid,
            peer,
            has_agent=bool(payload.get("has_agent")),
            data_address=payload.get("address"),
            rpc_timeout=getattr(self.manager.cfg, "rpc_timeout", 10.0),
        )
        with self._registered:
            # A relaunched worker reuses its id: forget the dead peer's
            # mapping so its (possibly lagging) disconnect can never be
            # misattributed to this fresh registration.
            for old_peer, old_wid in list(self._peer_worker.items()):
                if old_wid == wid and old_peer is not peer:
                    del self._peer_worker[old_peer]
            self.proxies[wid] = proxy
            self._peer_worker[peer] = wid
            self._registered.notify_all()
        self.manager.register_worker(
            proxy, address=proxy.data_address, rack=payload.get("rack")
        )
        return {
            "ok": True,
            "window": self.manager.cfg.window,
            # Workers adopt the Manager's RPC budget for their own
            # worker->manager calls: one knob governs the control plane.
            "rpc_timeout": getattr(self.manager.cfg, "rpc_timeout", 10.0),
        }

    def _h_deregister(self, peer: Peer, payload: Any):
        wid = int(payload)
        with self._lock:
            self.proxies.pop(wid, None)
        self.manager.deregister_worker(wid)
        return True

    def _h_heartbeat(self, peer: Peer, payload: Any) -> None:
        proxy = self._proxy_of(peer)
        if proxy is not None and proxy.on_heartbeat is not None:
            proxy.on_heartbeat(proxy.worker_id)

    def _h_stage_complete(self, peer: Peer, payload: Any) -> None:
        """Completion ingest (notify).  Predictive-push routing happens
        inside the Manager: push_request notifies to the holders go out
        before the dependent leases are dispatched, so the pushed bytes
        race ahead of the lease round-trip."""
        proxy = self._proxy_of(peer)
        if proxy is None or proxy.on_stage_complete is None:
            return
        uid, outputs = int(payload[0]), dict(payload[1])
        exec_s = (
            float(payload[2])
            if len(payload) > 2 and payload[2] is not None
            else None
        )
        si = self.manager.cw.stage_instances.get(uid)
        if si is not None:
            proxy.on_stage_complete(si, outputs, exec_s)
        return True  # workers retry this call until acknowledged

    def _h_stage_failed(self, peer: Peer, payload: Any):
        """Failure ingest: a healthy worker reports a lease whose op
        raised.  Retried (idempotent per stage+worker) — losing this
        message would leave the lease wedged until a heartbeat reap."""
        proxy = self._proxy_of(peer)
        if proxy is None or proxy.on_stage_failed is None:
            return True
        uid, error = int(payload[0]), str(payload[1])
        proxy.on_stage_failed(uid, error)
        return True

    # -- handlers (serving clients -> gateway) ------------------------------

    def _h_submit_request(self, peer: Peer, payload: Any):
        """Streamed request ingestion over the bus.  Payload names a
        tile (``chunk_id``) plus tenant/deadline; a DataChunk is built
        here so remote clients never serialize payload objects.  The
        reply is the admission verdict — a shed request is the 429."""
        if self.gateway is None:
            return {"ok": False, "error": "no gateway attached"}
        from ..core.workflow import DataChunk

        req = self.gateway.submit(
            str(payload.get("tenant", "default")),
            DataChunk(int(payload["chunk_id"])),
            deadline_ms=payload.get("deadline_ms"),
            cost_s=payload.get("cost_s"),
        )
        return {"ok": True, "req_id": req.req_id, "accepted": req.accepted}

    def _h_request_status(self, peer: Peer, payload: Any):
        if self.gateway is None:
            return {"ok": False, "error": "no gateway attached"}
        req = self.gateway.request(int(payload))
        if req is None:
            return {"ok": False, "error": "unknown request"}
        return {
            "ok": True,
            "req_id": req.req_id,
            "state": req.state,
            "tenant": req.tenant,
            "latency": req.latency,
            # Terminal failure verdict (quarantined pipeline): the
            # tenant polls this instead of waiting forever.
            "error": req.error,
        }

    # -- handlers (observability) --------------------------------------------

    def _h_get_stats(self, peer: Peer, payload: Any):
        """Cluster-wide stats aggregation, one round-trip: the Manager's
        registry view, this endpoint's relay counters, the bus, and —
        unless ``{"workers": False}`` — every live worker's own
        ``get_stats``.  Per-worker failures degrade to ``{}`` so one
        hung worker cannot take the whole snapshot down."""
        out: dict[str, Any] = {}
        if hasattr(self.manager, "stats"):
            out["manager"] = self.manager.stats()
        metrics = getattr(self.manager, "metrics", None)
        if metrics is not None:
            out["metrics"] = metrics.snapshot()
        out["endpoint"] = {
            "relay_regions": int(self.relay_regions),
            "relay_bytes": int(self.relay_bytes),
        }
        out["bus"] = self.bus.stats()
        if not (isinstance(payload, dict) and payload.get("workers") is False):
            with self._lock:
                proxies = list(self.proxies.items())
            out["workers"] = {
                wid: proxy.stats()
                for wid, proxy in proxies
                if proxy.alive
            }
        return out

    def _h_get_trace(self, peer: Peer, payload: Any):
        """Cluster-wide trace collection: manager-side spans and dumps
        plus every live worker's buffered spans and flight-recorder
        dumps, stitched by trace id on the caller's side."""
        spans: list = []
        dumps: list = []
        tracer = getattr(self.manager, "tracer", None)
        if tracer is not None:
            spans.extend(tracer.spans())
        recorder = getattr(self.manager, "recorder", None)
        if recorder is not None:
            dumps.extend(recorder.dumps)
        with self._lock:
            proxies = list(self.proxies.items())
        for wid, proxy in proxies:
            if not proxy.alive:
                continue
            t = proxy.trace()
            spans.extend(t.get("spans", ()))
            dumps.extend(t.get("dumps", ()))
        return {"spans": spans, "dumps": dumps}

    def _h_fetch_region(self, peer: Peer, payload: Any):
        value = self.manager._fetch_region(_as_key(payload))  # noqa: SLF001
        if value is not None:
            self.relay_regions += 1
            self.relay_bytes += _sizeof(value)
        return value

    def _h_fetch_regions(self, peer: Peer, payload: Any):
        keys = [_as_key(k) for k in payload]
        values = tuple(self.manager._fetch_regions(keys))  # noqa: SLF001
        for value in values:
            if value is not None:
                self.relay_regions += 1
                self.relay_bytes += _sizeof(value)
        return values

    def _h_resolve_regions(self, peer: Peer, payload: Any):
        proxy = self._proxy_of(peer)
        exclude = proxy.worker_id if proxy is not None else None
        keys = [_as_key(k) for k in payload]
        resolved = self.manager.resolve_regions(keys, exclude=exclude)
        if proxy is not None:
            with self._lock:
                for key, holder in zip(keys, resolved):
                    if holder is not None:
                        self._resolvers.setdefault(key, set()).add(
                            proxy.worker_id
                        )
        return tuple(resolved)

    def _h_region_staged(self, peer: Peer, payload: Any) -> None:
        proxy = self._proxy_of(peer)
        if proxy is None:
            return
        key, nbytes = payload
        self.manager.region_staged(proxy.worker_id, _as_key(key), int(nbytes))

    def _h_region_drop(self, peer: Peer, payload: Any) -> None:
        proxy = self._proxy_of(peer)
        if proxy is None:
            return
        key = _as_key(payload)
        if proxy.store.on_drop is not None:
            proxy.store.on_drop(key)
        # Stale-holder invalidation: only workers that resolved this key
        # can have it cached — tell exactly those to forget the replica
        # before their next direct dial targets a holder that spilled
        # it.  (Their caches drop the entry, so the registration dies
        # with the notify; a later re-resolve re-registers.)
        with self._lock:
            wids = self._resolvers.pop(key, ())
            targets = [
                self.proxies[wid]
                for wid in wids
                if wid != proxy.worker_id
                and wid in self.proxies
                and self.proxies[wid].alive
            ]
        for p in targets:
            p.invalidate_region(key, proxy.worker_id)

    def _proxy_of(self, peer: Peer) -> Optional[WorkerProxy]:
        with self._lock:
            wid = self._peer_worker.get(peer)
            return self.proxies.get(wid) if wid is not None else None

    def _on_disconnect(self, peer: Peer) -> None:
        """Connection drop = the worker process died: the heartbeat
        monitor reaps it exactly like a thread-worker crash."""
        with self._lock:
            wid = self._peer_worker.pop(peer, None)
            proxy = self.proxies.get(wid) if wid is not None else None
        # Guard against a stale drop outliving a re-registration: only
        # the proxy bound to THIS connection may be declared dead.
        if proxy is not None and proxy.peer is peer:
            proxy.mark_dead()


class WorkerClient:
    """Bridges a local WorkerRuntime onto a Manager's bus endpoint.

    Beyond the control plane, the client serves this worker's side of
    the *data plane*: a second bus address siblings dial directly for
    region bytes (``pull_region(s)``) and predictive pushes
    (``push_region``) — the coordinator routes metadata, never bulk
    payloads, on the happy path.
    """

    def __init__(
        self,
        runtime,
        bus: MessageBus,
        address: str,
        *,
        data_plane: bool = True,
        push_grace: Optional[float] = None,
        rack: Any = None,
    ) -> None:
        self.runtime = runtime
        self.bus = bus
        # Network topology identity (rack / leaf switch) announced at
        # registration: the Manager's placement scoring can then prefer
        # same-rack replicas (PlacementPolicy.rack_affinity).
        self.rack = rack
        self._stop = threading.Event()
        # Sibling peer cache: data-plane address -> dialed Peer.
        self._siblings: dict[Any, Peer] = {}
        self._sibling_lock = threading.Lock()
        # Data-plane traffic counters (benchmarks/tests).  Registered
        # into the runtime's MetricsRegistry when it has one so a single
        # ``get_stats`` snapshot carries them; plain ints otherwise.
        metrics = getattr(runtime, "metrics", None)
        if metrics is not None:
            c = lambda name: metrics.counter(f"transport.{name}")
        else:
            c = lambda name: 0
        self.pushes = c("pushes")
        self.pushed_bytes = c("pushed_bytes")
        self.push_ingests = c("push_ingests")
        self.served_regions = c("served_regions")
        self.served_bytes = c("served_bytes")
        # Payload integrity: region bytes rejected by the CRC envelope
        # (re-fetched from an alternate holder via the stale-holder path).
        self.crc_rejects = c("crc_rejects")
        self.push_crc_rejects = c("push_crc_rejects")
        # Control-plane hardening: completion/failure reports are calls
        # retried under this policy (the Manager dedups on stage uid), so
        # one lost frame cannot wedge a lease forever.  Rebuilt after
        # registration with the Manager's rpc_timeout.
        self.rpc_timeout = 10.0
        self.retry = RetryPolicy(attempts=4, base_delay=0.05, timeout=self.rpc_timeout)
        self.data_address: Optional[str] = None
        if data_plane:
            self.data_address = bus.serve(
                {
                    "pull_region": self._h_peer_pull,
                    "pull_regions": self._h_peer_pull_batch,
                    "push_region": self._h_peer_push,
                }
            )
        # Pushes run off a dedicated thread: the lane thread that
        # completed the stage must not serialize megabytes of encode +
        # send before starting its next op (async data copy, §IV-D).
        self._push_queue: "queue.Queue[Optional[tuple]]" = queue.Queue()
        self._push_thread = threading.Thread(
            target=self._push_loop,
            daemon=True,
            name=f"push-{runtime.worker_id}",
        )
        self._push_thread.start()
        self.peer = bus.connect(
            address,
            {
                "submit_stage": self._h_submit,
                "cancel_stage": self._h_cancel,
                "provide_input": self._h_provide,
                "forward_inputs": self._h_forward,
                "pull_region": self._h_pull,
                "push_request": self._h_push_request,
                "region_invalidate": self._h_invalidate,
                "get_stats": self._h_stats,
                "get_trace": self._h_trace,
                "stop": self._h_stop,
            },
        )
        # Outbound control plane: runtime hooks -> bus messages.
        runtime.on_stage_complete = self._stage_complete
        runtime.on_stage_failed = self._stage_failed
        runtime.on_heartbeat = lambda wid: self._notify("heartbeat", wid)
        runtime.fetch_region = self._fetch_region
        runtime.fetch_regions = self._fetch_regions
        runtime.store.on_drop = lambda key: self._notify("region_drop", key)
        # Data plane: the staging agent resolves holders through the
        # Manager's directory (cached) and dials siblings directly.
        if self.data_address is not None and runtime.agent is not None:
            runtime.agent.resolve = self._resolve_holders
            runtime.agent.dial = self._dial_fetch
            if push_grace is not None:
                runtime.agent.push_grace = push_grace
        reply = self.retry.call(
            self.peer,
            "register_worker",
            {
                "worker_id": runtime.worker_id,
                "has_agent": runtime.agent is not None,
                "address": self.data_address,
                "rack": rack,
            },
        )
        self.window = int(reply.get("window", 0)) if reply else 0
        if reply and reply.get("rpc_timeout"):
            self.rpc_timeout = float(reply["rpc_timeout"])
            self.retry = RetryPolicy(
                attempts=4, base_delay=0.05, timeout=self.rpc_timeout
            )

    # -- runtime -> manager ------------------------------------------------

    def _stage_complete(
        self, si, outputs: dict[str, Any], exec_s: float | None = None
    ) -> None:
        # The Manager answers with push_request notifies (predictive
        # push) racing ahead of the dependent leases it dispatches.
        # Delivered as a *retried call*: a lost completion wedges the
        # lease until a heartbeat reap, so the worker re-sends until the
        # Manager acknowledges (idempotent — ``_stage_done`` dedups).
        # ``exec_s`` is the queue-free execution time, the Manager's
        # health-ratio numerator.
        self._acked("stage_complete", (si.uid, outputs, exec_s))

    def _stage_failed(self, si, error: str) -> None:
        self._acked("stage_failed", (si.uid, str(error)))

    def _acked(self, method: str, payload: Any) -> None:
        try:
            self.retry.call(self.peer, method, payload)
        except BusError:
            # Manager unreachable after the whole retry budget: the
            # heartbeat reap / failover re-registration recovers.
            pass

    def _push_loop(self) -> None:
        """Drain queued pushes off the critical path (lane threads only
        enqueue; this thread pays the encode + send)."""
        while True:
            item = self._push_queue.get()
            if item is None:
                return
            key, addr, value = item
            if value is None:
                value = self.runtime.pull_region(key)
            if value is None:
                continue  # already evicted here: target pulls instead
            peer = self._sibling(addr)
            if peer is None:
                continue
            try:
                # CRC-sealed: the receiver drops a corrupted push and
                # its pull backstop re-fetches from a clean holder.
                peer.notify(
                    "push_region",
                    (self.runtime.worker_id, key, _seal(value)),
                )
            except BusError:
                self._drop_sibling(addr)
                continue
            self.pushes += 1
            self.pushed_bytes += _sizeof(value)

    def _fetch_region(self, key):
        # Pull failures (Manager restarting, bus timeout) degrade to a
        # miss: the caller treats None as "not available yet" and the
        # Manager re-feeds or the agent retries on the next lease.
        try:
            return self.retry.call(self.peer, "fetch_region", key)
        except BusError:
            return None

    def _fetch_regions(self, keys):
        try:
            values = self.retry.call(self.peer, "fetch_regions", tuple(keys))
        except BusError:
            return [None for _ in keys]
        return list(values)

    def _notify(self, method: str, payload: Any) -> None:
        try:
            self.peer.notify(method, payload)
        except BusClosedError:
            pass  # manager gone; the runtime keeps draining locally

    # -- data plane: holder resolution + sibling dialing --------------------

    def _resolve_holders(self, keys) -> Optional[list]:
        try:
            out = self.retry.call(self.peer, "resolve_regions", tuple(keys))
        except BusError:
            return None  # coordinator unreachable: agent uses the relay
        return [tuple(h) if h is not None else None for h in out]

    def _dial_fetch(self, holder, keys) -> Optional[list]:
        """Pull ``keys`` straight from sibling ``holder=(wid, addr)``.

        One timeout retry, then give up: the agent's stale-holder path
        (forget holder, fall back to the coordinator relay) is the
        better second opinion than hammering a hung sibling.  Each
        payload crosses CRC-sealed; a corrupt region is dropped (counted)
        and the caller re-fetches it from an alternate holder."""
        _, addr = holder
        peer = self._sibling(addr)
        if peer is None:
            return None
        dial_retry = RetryPolicy(
            attempts=2, base_delay=0.02, timeout=self.rpc_timeout
        )
        try:
            values = list(dial_retry.call(peer, "pull_regions", tuple(keys)))
        except BusError:
            self._drop_sibling(addr)
            return None
        out = []
        for sealed in values:
            value, ok = _unseal(sealed)
            if not ok:
                self.crc_rejects += 1
                value = None  # stale-holder semantics: re-fetch elsewhere
            out.append(value)
        return out

    def _sibling(self, addr) -> Optional[Peer]:
        if addr is None or addr == self.data_address:
            return None
        with self._sibling_lock:
            peer = self._siblings.get(addr)
            if peer is not None and peer.alive:
                return peer
        try:
            peer = self.bus.connect(addr, {})
        except Exception:  # noqa: BLE001 - holder gone: caller falls back
            return None
        with self._sibling_lock:
            # Another thread (prefetch vs push) may have dialed the same
            # sibling concurrently: keep one connection, close the loser
            # (and any dead entry being replaced) so peers never leak.
            current = self._siblings.get(addr)
            if current is not None and current.alive:
                loser, peer = peer, current
            else:
                loser = current
                self._siblings[addr] = peer
        if loser is not None:
            loser.close()
        return peer

    def _drop_sibling(self, addr) -> None:
        with self._sibling_lock:
            peer = self._siblings.pop(addr, None)
        if peer is not None:
            peer.close()

    # -- data plane: serving siblings ---------------------------------------

    def _h_peer_pull(self, peer: Peer, payload: Any):
        value = self.runtime.pull_region(_as_key(payload))
        if value is not None:
            self.served_regions += 1
            self.served_bytes += _sizeof(value)
        return value

    def _h_peer_pull_batch(self, peer: Peer, payload: Any):
        values = [self.runtime.pull_region(_as_key(k)) for k in payload]
        out = []
        for value in values:
            if value is not None:
                self.served_regions += 1
                self.served_bytes += _sizeof(value)
                out.append(_seal(value))
            else:
                out.append(None)
        return tuple(out)

    def _h_peer_push(self, peer: Peer, payload: Any) -> None:
        src_wid, key, value = payload
        key = _as_key(key)
        value, ok = _unseal(value)
        if not ok:
            # Corrupted in transit: drop it — the target's expect_push
            # grace expires and the pull backstop re-fetches clean bytes.
            self.push_crc_rejects += 1
            return
        nbytes = self.runtime.ingest_push(key, value)
        if nbytes:
            self.push_ingests += 1
            # Confirm the replica so the directory journals it: after a
            # coordinator restart the pushed copy is still findable.
            self._notify("region_staged", (key, nbytes))

    # -- manager -> runtime ------------------------------------------------

    def _h_submit(self, peer: Peer, payload: Any) -> None:
        self.runtime.submit_stage(payload)

    def _h_cancel(self, peer: Peer, payload: Any) -> None:
        self.runtime.cancel_stage(int(payload))

    def _h_provide(self, peer: Peer, payload: Any) -> None:
        uid, value = payload
        self.runtime.provide_input(int(uid), value)

    def _h_forward(self, peer: Peer, payload: Any):
        items = [
            (
                int(item[0]),
                item[1],
                bool(item[2]),
                bool(item[3]) if len(item) > 3 else False,
            )
            for item in payload
        ]
        return tuple(self.runtime.forward_inputs(items))

    def _h_pull(self, peer: Peer, payload: Any):
        return self.runtime.pull_region(_as_key(payload))

    def _h_push_request(self, peer: Peer, payload: Any) -> None:
        """Manager-directed push: this worker holds the region; ship it
        to the predicted next holder's data plane."""
        key, addr = payload
        self._push_queue.put((_as_key(key), addr, None))

    def _h_invalidate(self, peer: Peer, payload: Any) -> None:
        key, wid = payload
        self.runtime.invalidate_region(_as_key(key), int(wid))

    def _h_stats(self, peer: Peer, payload: Any) -> dict:
        stats = dict(self.runtime.stats())
        stats["transport"] = {
            "pushes": int(self.pushes),
            "pushed_bytes": int(self.pushed_bytes),
            "push_ingests": int(self.push_ingests),
            "served_regions": int(self.served_regions),
            "served_bytes": int(self.served_bytes),
            "crc_rejects": int(self.crc_rejects),
            "push_crc_rejects": int(self.push_crc_rejects),
        }
        return stats

    def _h_trace(self, peer: Peer, payload: Any) -> dict:
        """This worker's buffered spans + flight-recorder dumps (the
        Manager's ``get_trace`` fans out here to stitch a cluster-wide
        timeline)."""
        out: dict[str, Any] = {"spans": [], "dumps": [], "stats": {}}
        tracer = getattr(self.runtime, "tracer", None)
        if tracer is not None:
            out["spans"] = tracer.spans()
            out["stats"] = tracer.stats()
        recorder = getattr(self.runtime, "recorder", None)
        if recorder is not None:
            out["dumps"] = list(recorder.dumps)
        return out

    def _h_stop(self, peer: Peer, payload: Any) -> bool:
        self._stop.set()
        return True

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the manager sends ``stop`` (worker-process main)."""
        return self._stop.wait(timeout=timeout)

    def close(self) -> None:
        self._stop.set()
        self._push_queue.put(None)
        self._push_thread.join(timeout=2.0)
        with self._sibling_lock:
            siblings = list(self._siblings.values())
            self._siblings.clear()
        for peer in siblings:
            peer.close()
        self.peer.close()


# --------------------------------------------------------------------------
# Multiprocess workers
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class WorkerSpec:
    """Picklable recipe for building a WorkerRuntime in a child process.

    ``registry`` is a ``"module:function"`` path to a zero-arg factory
    returning a VariantRegistry — a callable reference survives spawn
    only if importable by name.
    """

    worker_id: int
    registry: str                      # "package.module:factory"
    lanes: tuple[tuple[str, int], ...] = (("cpu", 0),)
    policy: str = "fcfs"
    chaining: bool = False
    micro_batch: int = 1
    batch_budget: Optional[float] = None  # adaptive micro-batch sizing
    staging: bool = True               # build a StagingConfig (prefetch agent)
    host_budget_bytes: Optional[int] = None
    data_plane: bool = True            # serve worker-to-worker transfers
    rack: Optional[int] = None         # topology identity (rack_affinity)
    #: >0 enables distributed tracing in the child: a Tracer seeded from
    #: this rate plus a TracingBus wrapper so sampled span contexts ride
    #: every control-plane envelope (fraction of traces kept, 0..1).
    trace_sample_rate: float = 0.0
    #: directory for flight-recorder crash/quarantine dumps (None = in
    #: memory only, retrievable over the bus via ``get_trace``).
    dump_dir: Optional[str] = None
    extra: dict[str, Any] = field(default_factory=dict)


def _resolve_factory(path: str) -> Callable[[], Any]:
    module, _, attr = path.partition(":")
    return getattr(importlib.import_module(module), attr)


def worker_main(address: str, spec: WorkerSpec) -> None:
    """Entry point of a spawned worker process: build, bridge, serve."""
    from ..core.worker import LaneSpec, WorkerRuntime
    from ..staging import StagingConfig

    registry = _resolve_factory(spec.registry)()
    staging = (
        StagingConfig(host_budget_bytes=spec.host_budget_bytes)
        if spec.staging
        else None
    )
    from ..telemetry.metrics import MetricsRegistry
    from ..telemetry.recorder import FlightRecorder
    from ..telemetry.tracing import Tracer, TracingBus

    metrics = MetricsRegistry(f"worker{spec.worker_id}")
    recorder = FlightRecorder(
        f"worker{spec.worker_id}", dump_dir=spec.dump_dir
    )
    tracer = (
        Tracer(
            f"worker{spec.worker_id}",
            sample_rate=spec.trace_sample_rate,
            recorder=recorder,
        )
        if spec.trace_sample_rate > 0.0
        else None
    )
    runtime = WorkerRuntime(
        spec.worker_id,
        lanes=tuple(LaneSpec(kind, idx) for kind, idx in spec.lanes),
        policy=spec.policy,
        chaining=spec.chaining,
        micro_batch=spec.micro_batch,
        batch_budget=spec.batch_budget,
        staging=staging,
        variant_registry=registry,
        registry=metrics,
        tracer=tracer,
        recorder=recorder,
        **spec.extra,
    )
    runtime.start()
    from .socketbus import SocketBus

    bus: MessageBus = SocketBus(registry=metrics)
    if tracer is not None:
        bus = TracingBus(bus, tracer)
    client = WorkerClient(
        runtime, bus, address, data_plane=spec.data_plane, rack=spec.rack
    )
    try:
        client.wait()
    finally:
        runtime.stop()
        client.close()
        bus.close()
        # A thread still inside a torch call when the interpreter
        # finalizes is ended as it re-takes the GIL, within C++ that
        # cannot unwind, and the process aborts: outlast every thread.
        deadline = time.monotonic() + 30.0
        for thread in threading.enumerate():
            if thread is not threading.current_thread():
                thread.join(timeout=max(0.0, deadline - time.monotonic()))


def spawn_worker(address: str, spec: WorkerSpec):
    """Launch ``worker_main`` in a fresh OS process (spawn context)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    proc = ctx.Process(
        target=worker_main,
        args=(address, spec),
        daemon=True,
        name=f"repro-worker-{spec.worker_id}",
    )
    proc.start()
    return proc
