"""Pluggable cluster transport: control plane and data plane on a bus.

The **control plane** — leases, completion notifies, heartbeats,
holder metadata — crosses a pluggable :class:`MessageBus` and always
routes through the coordinator.  The **data plane** — bulk region
bytes — is coordinator-bypassing: every :class:`WorkerClient` serves
a second bus address siblings dial directly (``pull_region(s)`` peer
pulls, ``push_region`` predictive pushes), and push traffic is
flow-controlled by the Manager's per-target in-flight byte cap whose
credits return on ``region_staged`` (see ``docs/architecture.md``).

Module map
----------

* :mod:`repro_torch.transport.bus`       — ``MessageBus``/``Peer``
  contract: typed request/reply (``call``) + one-way ``notify``,
  per-peer ordered delivery, handler tables.
* :mod:`repro_torch.transport.codec`     — wire codec registry: torch
  tensors (any device; decoded on the CPU) and numpy arrays as raw
  buffers, msgpack frames, a tensor-aware pickle fallback for graphs.
* :mod:`repro_torch.transport.inproc`    — ``InprocBus``: same-process
  endpoints, direct invocation, zero-copy (the default deployment).
* :mod:`repro_torch.transport.socketbus` — ``SocketBus``: multiprocess
  peers over TCP, length-prefixed frames, batched per-peer coalescing.
* :mod:`repro_torch.transport.endpoint`  — ``ManagerEndpoint`` (serves
  lease / complete / heartbeat / region-pull RPCs), ``WorkerClient``
  (bridges a WorkerRuntime onto the bus), ``WorkerProxy`` (the
  Manager-side face of a remote worker), ``spawn_worker``/``worker_main``
  (real OS-process workers).
* :mod:`repro_torch.transport.demo`      — module-level demo workload
  (CPU torch tensors) shared by multiprocess tests.

``bus``, ``inproc``, ``socketbus`` and ``endpoint`` are byte-identical
copies of the JAX package's modules; ``codec`` and ``demo`` are ports.

How it composes with the paper's runtime: §III-B's Manager/Worker
protocol is MPI messages; here the same protocol is expressed once
against the bus contract and deployed per-backend — in-process calls
where the seed ran, real sockets across OS processes — so control-
plane costs (round-trips, batching amortization) become measurable
instead of structurally free.
"""

from .bus import (
    BusClosedError,
    BusError,
    BusTimeoutError,
    MessageBus,
    Peer,
    RemoteError,
)
from .codec import Codec, WireCodec, default_codec
from .endpoint import (
    ManagerEndpoint,
    ServingClient,
    WorkerClient,
    WorkerProxy,
    WorkerSpec,
    spawn_worker,
    worker_main,
)
from .inproc import InprocBus
from .socketbus import SocketBus, SocketPeer

__all__ = [
    "BusClosedError",
    "BusError",
    "BusTimeoutError",
    "Codec",
    "InprocBus",
    "ManagerEndpoint",
    "MessageBus",
    "Peer",
    "RemoteError",
    "ServingClient",
    "SocketBus",
    "SocketPeer",
    "WireCodec",
    "WorkerClient",
    "WorkerProxy",
    "WorkerSpec",
    "default_codec",
    "spawn_worker",
    "worker_main",
]
