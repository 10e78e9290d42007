"""Open-loop synthetic serving workload: Poisson arrivals, Zipf tiles.

Serving-side evaluation needs *offered load the system does not
control*: requests arrive on the clock's schedule whether or not the
cluster keeps up (open-loop), which is what exposes queueing collapse
at saturation — a closed loop would politely slow its offered load and
hide it.  Arrivals are Poisson per tenant (exponential inter-arrival
gaps at each tenant's offered rate) and each request targets a tile
drawn from a Zipf popularity distribution over ``n_tiles`` — hot tiles
dominate, mirroring map-viewer traffic over a whole-slide image where
the current viewport's tiles are requested by many users at once.

The same generator drives the threaded runtime (``benchmarks/serving``
replays the trace against a real Manager) and the discrete-event
simulator (``SimConfig.arrival_rate``), so measured and simulated
latency curves come from identical traces.
"""

from __future__ import annotations

import bisect
import itertools
import random
from dataclasses import dataclass, field
from typing import Mapping, Optional

__all__ = ["WorkloadConfig", "Arrival", "zipf_weights", "generate_arrivals"]


@dataclass(frozen=True)
class Arrival:
    """One open-loop request: at time ``t`` (seconds from stream
    start), ``tenant`` asks for ``tile``; optionally with a relative
    completion deadline."""

    t: float
    tenant: str
    tile: int
    deadline_s: Optional[float] = None


@dataclass
class WorkloadConfig:
    """Knobs of the synthetic request stream.

    ``arrival_rate`` is the offered rate in requests/second *per
    tenant* unless ``tenant_rates`` overrides a tenant explicitly —
    per-tenant rates keep fairness experiments symmetric (every tenant
    offers the same overload; the weighted-fair gateway decides who
    gets through).
    """

    arrival_rate: float = 50.0
    duration_s: float = 1.0
    #: tenant name -> WFQ weight (also the default arrival split).
    tenants: Mapping[str, float] = field(default_factory=lambda: {"t0": 1.0})
    #: optional per-tenant offered rate override (requests/second).
    tenant_rates: Optional[Mapping[str, float]] = None
    zipf_alpha: float = 1.1
    n_tiles: int = 64
    #: relative deadline applied to every request (None = best effort).
    deadline_ms: Optional[float] = None
    seed: int = 0


def zipf_weights(n: int, alpha: float) -> list[float]:
    """Normalized Zipf pmf over ranks ``0..n-1``: p(k) ∝ 1/(k+1)^alpha."""
    raw = [1.0 / float(k + 1) ** alpha for k in range(n)]
    total = sum(raw)
    return [w / total for w in raw]


def _zipf_sampler(n: int, alpha: float):
    cdf = list(itertools.accumulate(zipf_weights(n, alpha)))
    cdf[-1] = 1.0  # guard float drift at the top

    def sample(rng: random.Random) -> int:
        return bisect.bisect_left(cdf, rng.random())

    return sample


def generate_arrivals(cfg: WorkloadConfig) -> list[Arrival]:
    """The full trace, time-sorted.  Deterministic in ``cfg.seed``:
    each tenant's Poisson stream gets its own derived RNG, so adding a
    tenant never perturbs another tenant's arrivals."""
    sample_tile = _zipf_sampler(max(int(cfg.n_tiles), 1), cfg.zipf_alpha)
    deadline_s = (
        cfg.deadline_ms / 1000.0 if cfg.deadline_ms is not None else None
    )
    out: list[Arrival] = []
    for idx, tenant in enumerate(sorted(cfg.tenants)):
        rate = float(
            (cfg.tenant_rates or {}).get(tenant, cfg.arrival_rate)
        )
        if rate <= 0.0:
            continue
        # Independent derived stream per tenant (int seed: tuple
        # seeding is deprecated and hash-unstable across runs).
        rng = random.Random(cfg.seed * 1_000_003 + idx)
        t = 0.0
        while True:
            t += rng.expovariate(rate)
            if t >= cfg.duration_s:
                break
            out.append(
                Arrival(
                    t=t,
                    tenant=tenant,
                    tile=sample_tile(rng),
                    deadline_s=deadline_s,
                )
            )
    out.sort(key=lambda a: a.t)
    return out
