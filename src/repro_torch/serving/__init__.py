"""Online serving front end for the hierarchical-pipeline runtime.

The batch runtime (paper 1209.3332) takes one ConcreteWorkflow and
drains it; this package turns the same Manager/worker control plane
into a *service*: a continuous stream of tile/pipeline requests flows
through a :class:`~repro.serving.gateway.RequestGateway` that applies
admission control (shed beyond queue-depth / estimated-work caps),
per-tenant weighted fair queueing, and deadline stamping; stages
inherit the request deadline so the Manager's pending queue and every
worker's ready queue run an earliest-deadline-first tier above the
PATS speedup order.  Workers join and drain mid-stream (elastic
membership is a Manager primitive: leases re-queued, push reservations
released atomically).  :mod:`~repro.serving.workload` generates the
open-loop Poisson/Zipf traces both the threaded runtime and the
discrete-event simulator replay.
"""

from .gateway import GatewayConfig, GatewayStats, RequestGateway
from .request import DONE, FAILED, QUEUED, RUNNING, SHED, ServeRequest
from .workload import Arrival, WorkloadConfig, generate_arrivals, zipf_weights

__all__ = [
    "Arrival",
    "DONE",
    "FAILED",
    "GatewayConfig",
    "GatewayStats",
    "QUEUED",
    "RUNNING",
    "RequestGateway",
    "SHED",
    "ServeRequest",
    "WorkloadConfig",
    "generate_arrivals",
    "zipf_weights",
]
