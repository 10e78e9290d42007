"""Deterministic fault injection + hardening primitives.

``FaultPlan`` is a seeded, declarative fault schedule; ``FaultyBus``
wraps any :class:`repro.transport.MessageBus` and injects the plan's
faults on the wire (drop/delay/duplicate notifies, failed calls,
partitions, peer kills, payload corruption).  ``RetryPolicy`` is the
matching hardening primitive for control-plane RPCs, and
``integrity`` carries the CRC32 envelope used on region payloads.

No production code path branches on "testing": production components
expose generic seams (``WorkerRuntime.on_op_start``, pluggable
``StagingAgent.fetch``/``dial``, the bus decorator) and the harness
plugs fault behaviour into them from the outside.
"""

from .bus import FaultyBus, FaultyPeer
from .integrity import region_crc, seal, unseal
from .plan import FaultPlan
from .retry import RetryPolicy

__all__ = [
    "FaultPlan",
    "FaultyBus",
    "FaultyPeer",
    "RetryPolicy",
    "region_crc",
    "seal",
    "unseal",
]
