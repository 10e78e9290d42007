"""Staging configuration shared by Worker, Manager, and benchmarks."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .policy import PlacementPolicy
from .store import RegionStore
from .tiers import DiskTier, GlobalTier, HostTier

__all__ = ["StagingConfig"]


@dataclass
class StagingConfig:
    """How one worker builds its storage hierarchy.

    The host tier always exists (it replaces the worker's ad-hoc output
    dict); disk and global tiers are optional.  One ``global_tier``
    instance shared across StagingConfigs models the cluster's shared
    store, letting StagingAgents prefetch remote outputs.
    """

    host_budget_bytes: Optional[int] = None   # None = unbounded RAM
    disk_dir: Optional[str] = None            # spill directory; None = off
    disk_budget_bytes: Optional[int] = None
    global_tier: Optional[GlobalTier] = None  # shared cluster store
    prefetch: bool = True                     # run the StagingAgent thread
    watermark: float = 0.9                    # host-tier demotion trigger
    policy: PlacementPolicy = field(default_factory=PlacementPolicy)

    def build_store(self, registry=None) -> RegionStore:
        tiers = [HostTier(self.host_budget_bytes)]
        if self.disk_dir is not None:
            tiers.append(DiskTier(self.disk_dir, self.disk_budget_bytes))
        if self.global_tier is not None:
            tiers.append(self.global_tier)
        return RegionStore(tiers, registry=registry)

    @classmethod
    def from_calibration(
        cls,
        node=None,
        *,
        window: int = 15,
        stage_output_mb: float = 48.0,
        ram_headroom: float = 0.5,
        disk_headroom: float = 0.8,
        disk_dir: Optional[str] = None,
        **kwargs,
    ) -> "StagingConfig":
        """Derive tier budgets from a calibrated node profile.

        The host tier gets ``ram_headroom`` of the node's RAM (the rest
        is application/OS working memory), but never less than the live
        working set the simulator's staging model implies — ``window``
        in-flight leases, each holding one input and one output region
        of ``stage_output_mb`` — so soft budgets stay soft (pins would
        otherwise defeat every byte of the budget).  The disk tier gets
        ``disk_headroom`` of the node's scratch space when a spill
        directory is provided.
        """
        from ..core import calibration as cal  # runtime import: no cycle

        node = node or cal.KEENELAND_NODE
        stage_bytes = int(stage_output_mb * 2**20)
        working_set = 2 * max(window, 1) * stage_bytes
        host_budget = max(
            int(node.host_ram_gb * 2**30 * ram_headroom), working_set
        )
        disk_budget = (
            int(node.scratch_disk_gb * 2**30 * disk_headroom)
            if disk_dir is not None
            else None
        )
        return cls(
            host_budget_bytes=host_budget,
            disk_dir=disk_dir,
            disk_budget_bytes=disk_budget,
            **kwargs,
        )
