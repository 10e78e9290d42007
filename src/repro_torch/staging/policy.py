"""Locality-aware lease placement policy (cluster-level DL).

Mirrors the within-node data-locality rule of ``core/scheduling.py`` at
the Manager level.  There, a resident dependent wins over the best
queued candidate iff ``S_d >= S_q * (1 - transferImpact)``; here, a
pending stage instance is diverted from demand-driven (FIFO) order to a
worker iff the *locality gain* — the extra fraction of its input bytes
already on that worker versus the FIFO head — exceeds the configured
``transfer_impact`` threshold.  With the default threshold of 0 any
positive gain diverts; a deployment whose interconnect is fast relative
to recompute can raise it toward 1 to recover pure demand-driven order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, Optional, Sequence

from .directory import PlacementDirectory
from .tiers import RegionKey

__all__ = ["PlacementPolicy", "select_lease"]


@dataclass(frozen=True)
class PlacementPolicy:
    """Knobs of cluster-level locality-aware lease placement."""

    locality: bool = True
    # Minimum locality-fraction gain over the FIFO head required to
    # divert from demand-driven order (0 = always prefer locality).
    transfer_impact: float = 0.0
    # Leave a remote-affine stage pending for its home worker when that
    # worker still has window slack (second pass is work-conserving).
    defer_remote: bool = True
    # Cap on how many pending instances to score per dispatch decision.
    scan_limit: int = 64
    # Rack-locality bonus: input bytes held by a same-rack sibling
    # (PlacementDirectory.set_rack identity) count at this weight on
    # top of the worker-local fraction — a same-rack pull crosses the
    # leaf switch only, never an oversubscribed uplink, so on a
    # fat-tree fabric it is nearly as good as local.  0 keeps the
    # rack-blind scoring.
    rack_affinity: float = 0.0
    # Replication-aware host-tier eviction: under budget pressure a
    # worker sheds regions the PlacementDirectory shows replicated on
    # another worker before any sole copy (the Manager wires each
    # worker's host tier to ``directory.replicated_elsewhere``).
    replication_aware_eviction: bool = True


def select_lease(
    pending: Sequence,
    worker_id: int,
    directory: PlacementDirectory,
    input_keys: Callable[[object], Iterable[RegionKey]],
    policy: PlacementPolicy,
    *,
    workers_with_slack: Optional[set[int]] = None,
    allow_defer: bool = True,
) -> Optional[int]:
    """Index into ``pending`` of the instance to lease to ``worker_id``.

    Returns None iff every scanned candidate is deferred to another
    worker that holds its data and still has window slack (the caller
    must then run a second, non-deferring pass for work conservation).
    """
    if not pending:
        return None
    if not policy.locality:
        return 0
    limit = min(len(pending), max(policy.scan_limit, 1))
    best_i, best_f = 0, -1.0
    head_f = 0.0
    for i in range(limit):
        keys = list(input_keys(pending[i]))
        f = (
            directory.placement_score(
                worker_id, keys, policy.rack_affinity
            )
            if keys
            else 0.0
        )
        if i == 0:
            head_f = f
        if f > best_f:
            best_i, best_f = i, f
    if best_f > head_f and best_f - head_f > policy.transfer_impact:
        return best_i
    # No candidate is better-placed here than the FIFO head.  If the
    # head's data lives on another worker that can still take it, defer.
    if (
        allow_defer
        and policy.defer_remote
        and workers_with_slack is not None
    ):
        for i in range(limit):
            keys = list(input_keys(pending[i]))
            if not keys:
                return i  # fresh work: no affinity anywhere
            best = directory.best_worker(keys)
            if best is None or best[1] <= 0.0:
                return i
            home, _ = best
            if home == worker_id or home not in workers_with_slack:
                return i
        return None  # everything scanned belongs to someone else
    return 0  # gain below threshold: demand-driven order wins
