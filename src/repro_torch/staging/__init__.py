"""Hierarchical data staging: the runtime's storage **tiers** and the
cluster-level placement metadata the data plane routes by.

Regions move through a per-worker tier stack (device memory -> host
RAM -> scratch disk -> global store) driven by a background staging
agent; the Manager-side placement directory (holders + bus addresses
+ rack identity) turns those placements into locality- and rack-aware
lease dispatch, and the write-ahead journal makes that metadata
survive a coordinator restart.  Terminology (control plane / data
plane / tiers) matches ``docs/architecture.md``.

Module map
----------

* :mod:`repro.staging.tiers`     — pluggable storage tiers with LRU +
  byte budgets: ``DeviceTier`` (wraps a lane's ``DeviceMemory``),
  ``HostTier`` (RAM), ``DiskTier`` (local spill), ``GlobalTier``
  (shared cluster store / parallel filesystem model).
* :mod:`repro.staging.store`     — ``RegionStore``: content-addressed
  stack of tiers with promote/demote movement; keys via ``op_key`` /
  ``chunk_key`` / ``content_key``.
* :mod:`repro.staging.agent`     — ``StagingAgent``: per-worker
  background thread that prefetches the inputs of leased-but-unstarted
  stage instances and runs async promote/demote between tiers.
* :mod:`repro.staging.directory` — ``PlacementDirectory``: cluster-wide
  region -> {worker: bytes} metadata the Manager consults at dispatch.
* :mod:`repro.staging.policy`    — ``PlacementPolicy`` /
  ``select_lease``: the locality-aware lease-placement rule with a
  ``transfer_impact``-style tie-break mirroring ``core/scheduling.py``.
* :mod:`repro.staging.config`    — ``StagingConfig``: per-worker tier
  stack construction shared by Worker, Manager, and benchmarks.

How it composes with the paper's runtime: ``core/scheduling.py`` keeps
locality *within* a node (device-memory reuse, §IV-C); this package
lifts the same idea to the cluster — the Manager leases a dependent
stage instance to the worker already holding the largest fraction of
its input bytes, and each worker's StagingAgent hides the residual
transfers behind computation (§IV-D generalized to all tiers).
"""

from .agent import StagingAgent
from .config import StagingConfig
from .directory import PlacementDirectory
from .journal import DirectoryService, WriteAheadJournal
from .policy import PlacementPolicy, select_lease
from .store import RegionStore, chunk_key, content_key, op_key
from .tiers import (
    DeviceTier,
    DiskTier,
    GlobalTier,
    HostTier,
    Tier,
    TierStats,
    sizeof,
)

__all__ = [
    "DeviceTier",
    "DirectoryService",
    "DiskTier",
    "GlobalTier",
    "HostTier",
    "PlacementDirectory",
    "PlacementPolicy",
    "RegionStore",
    "StagingAgent",
    "StagingConfig",
    "Tier",
    "TierStats",
    "WriteAheadJournal",
    "chunk_key",
    "content_key",
    "op_key",
    "select_lease",
    "sizeof",
]
