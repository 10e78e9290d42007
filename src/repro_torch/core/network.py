"""Per-link cluster network topology model (the simulator's data plane).

The seed simulator modeled the cluster interconnect as one scalar
bandwidth per node: every copy into a node serialized on that node's
ingress NIC and nothing else.  Real clusters are switched fabrics —
a transfer occupies its **source NIC**, any **shared switch uplinks**
on the path, and the **destination NIC**, in that order, and the
uplink tier is usually *oversubscribed* (a rack of ``r`` nodes shares
an uplink of ``r * link / oversubscription`` capacity).  Whether
locality-aware placement pays off depends exactly on that contention:
on a flat (non-blocking) network every placement is one hop, while on
a 4:1 fat-tree a rack-blind placement pays the shared uplink for
every cross-rack region and a rack-aware one bypasses it.

This module is the pluggable model behind
``SimConfig.network``:

* :class:`FlatNetwork` — single tier, non-blocking: each transfer
  serializes on the source egress NIC and the destination ingress NIC
  only.  With the source unknown (``src=None``) it degrades to the
  seed's destination-NIC-only model.
* :class:`FatTreeNetwork` — two-tier leaf/spine tree: nodes are
  grouped into racks of ``rack_size``; an intra-rack transfer stays on
  the leaf switch (NICs only), a cross-rack transfer additionally
  serializes on the source rack's up-link and the destination rack's
  down-link, each of capacity ``rack_size * link_gb_s /
  oversubscription``.  ``oversubscription=1`` is a full-bisection
  (non-blocking) tree; ``4`` is the classic cost-reduced 4:1 fabric.

Both models also carry the **coordinator NIC** used by the relay
route (data plane disabled): relayed bytes cross that single shared
link twice (in + out), which is the structural bottleneck the
worker-to-worker data plane removes (see ``docs/architecture.md``,
"data plane").

Every link keeps byte and busy-time accounting so results can report
where the wire time went (``SimResult.cross_rack_bytes`` /
``uplink_busy_s``).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Callable, Optional

__all__ = [
    "Link",
    "NetworkModel",
    "FlatNetwork",
    "FatTreeNetwork",
    "FluidFlow",
    "FluidNetwork",
    "build_network",
]

_GB = float(2**30)

# A flow whose remaining payload drops below this many bytes is
# complete (absorbs float drift from repeated rate * dt advances).
_EPS_BYTES = 0.5


@dataclass(eq=False)
class Link:
    """One serializing network resource (a NIC or a switch uplink).

    Transfers reserve the link back-to-back: a reservation starts at
    ``max(earliest, busy_until)`` and holds the link for
    ``nbytes / bandwidth`` seconds — the same store-and-forward rule
    the seed model applied to the single ingress NIC, now applied to
    every hop on the path.
    """

    name: str
    gb_s: float
    busy_until: float = 0.0
    busy_seconds: float = 0.0
    bytes_total: int = 0

    def reserve(self, earliest: float, nbytes: int) -> float:
        start = max(earliest, self.busy_until)
        dt = nbytes / (self.gb_s * _GB)
        self.busy_until = start + dt
        self.busy_seconds += dt
        self.bytes_total += int(nbytes)
        return self.busy_until


class NetworkModel:
    """Base contract + the flat (single-tier, non-blocking) fabric.

    ``transfer(src, dst, nbytes, earliest)`` returns the time the last
    byte lands on ``dst``, having serialized the transfer on every
    link of the path; ``relay`` is the coordinator route (bytes cross
    the coordinator NIC twice).  ``rack_of`` exposes topology identity
    to placement: ``None`` means this fabric has no racks.
    """

    kind = "flat"

    def __init__(
        self,
        n_nodes: int,
        link_gb_s: float,
        *,
        coordinator_gb_s: Optional[float] = None,
    ) -> None:
        self.n_nodes = int(n_nodes)
        self.link_gb_s = float(link_gb_s)
        self.ingress = [
            Link(f"nic-in{i}", link_gb_s) for i in range(self.n_nodes)
        ]
        self.egress = [
            Link(f"nic-out{i}", link_gb_s) for i in range(self.n_nodes)
        ]
        # The relay route's shared coordinator NIC (one link for the
        # whole cluster; carries every relayed byte twice).
        self.coordinator = Link(
            "coordinator-nic", coordinator_gb_s or link_gb_s
        )
        self.rack_local_bytes = 0
        self.cross_rack_bytes = 0

    # -- topology identity --------------------------------------------------

    def rack_of(self, node_id: int) -> Optional[int]:
        """Rack (leaf switch) of ``node_id``; None = no rack tier."""
        return None

    def same_rack(self, a: Optional[int], b: Optional[int]) -> bool:
        ra = self.rack_of(a) if a is not None else None
        rb = self.rack_of(b) if b is not None else None
        return ra is not None and ra == rb

    # -- path construction --------------------------------------------------

    def path(self, src: Optional[int], dst: int) -> list[Link]:
        """Links a ``src -> dst`` transfer serializes on, in order.

        ``src=None`` (holder unknown to the model) charges only the
        destination NIC — the seed behavior, kept as the conservative
        fallback.
        """
        if src is None:
            return [self.ingress[dst]]
        if src == dst:
            return []
        return [self.egress[src], self.ingress[dst]]

    # -- transfers ----------------------------------------------------------

    def transfer(
        self, src: Optional[int], dst: int, nbytes: int, earliest: float
    ) -> float:
        """Direct (worker-to-worker) transfer; returns completion time."""
        links = self.path(src, dst)
        if not links:
            return earliest
        t = earliest
        for link in links:
            t = link.reserve(t, nbytes)
        self.account_rack(src, dst, nbytes)
        return t

    def account_rack(
        self, src: Optional[int], dst: int, nbytes: int
    ) -> None:
        """Book ``nbytes`` as rack-local or cross-rack traffic.

        Rack accounting only exists on fabrics WITH a rack tier: a
        flat network has no uplinks, so calling its traffic
        "cross-rack" would make flat-vs-fat-tree rows incomparable.
        Shared by the store-and-forward reservation path and the
        fluid-flow engine so both engines report comparable bytes.
        """
        if src is not None and self.rack_of(dst) is not None:
            if self.same_rack(src, dst):
                self.rack_local_bytes += int(nbytes)
            else:
                self.cross_rack_bytes += int(nbytes)

    def relay(
        self, src: Optional[int], dst: int, nbytes: int, earliest: float
    ) -> float:
        """Coordinator-relay transfer: the bytes leave the source NIC,
        cross the coordinator's single shared NIC twice (in + out), and
        land through the destination NIC."""
        t = earliest
        if src is not None and src != dst:
            t = self.egress[src].reserve(t, nbytes)
        t = self.coordinator.reserve(t, 2 * nbytes)
        return self.ingress[dst].reserve(t, nbytes)

    # -- accounting ---------------------------------------------------------

    def uplink_busy_s(self) -> float:
        return 0.0

    def nic_busy_s(self) -> float:
        """Total busy time across every node NIC (ingress + egress)."""
        return sum(l.busy_seconds for l in self.ingress) + sum(
            l.busy_seconds for l in self.egress
        )

    def n_uplinks(self) -> int:
        """Uplink-tier link count (0 = no rack tier)."""
        return 0

    def stats(self) -> dict[str, float]:
        return {
            "rack_local_bytes": float(self.rack_local_bytes),
            "cross_rack_bytes": float(self.cross_rack_bytes),
            "uplink_busy_s": self.uplink_busy_s(),
            "coordinator_bytes": float(self.coordinator.bytes_total),
        }


class FlatNetwork(NetworkModel):
    """Single-tier non-blocking fabric (explicit alias of the base)."""


class FatTreeNetwork(NetworkModel):
    """Two-tier fat-tree: racks of ``rack_size`` nodes behind shared
    uplinks of ``rack_size * link_gb_s / oversubscription`` capacity.

    Intra-rack transfers never touch the uplink tier — that asymmetry
    is what a rack-locality placement bonus exploits.
    """

    kind = "fat_tree"

    def __init__(
        self,
        n_nodes: int,
        link_gb_s: float,
        *,
        rack_size: int = 4,
        oversubscription: float = 4.0,
        coordinator_gb_s: Optional[float] = None,
    ) -> None:
        super().__init__(
            n_nodes, link_gb_s, coordinator_gb_s=coordinator_gb_s
        )
        self.rack_size = max(int(rack_size), 1)
        self.oversubscription = max(float(oversubscription), 1e-9)
        n_racks = (self.n_nodes + self.rack_size - 1) // self.rack_size
        up_gb_s = link_gb_s * self.rack_size / self.oversubscription
        self.uplinks_up = [
            Link(f"rack{r}-up", up_gb_s) for r in range(n_racks)
        ]
        self.uplinks_down = [
            Link(f"rack{r}-down", up_gb_s) for r in range(n_racks)
        ]

    def rack_of(self, node_id: int) -> Optional[int]:
        return int(node_id) // self.rack_size

    def path(self, src: Optional[int], dst: int) -> list[Link]:
        if src is None:
            return [self.ingress[dst]]
        if src == dst:
            return []
        links = [self.egress[src]]
        if not self.same_rack(src, dst):
            links.append(self.uplinks_up[self.rack_of(src)])
            links.append(self.uplinks_down[self.rack_of(dst)])
        links.append(self.ingress[dst])
        return links

    def uplink_busy_s(self) -> float:
        return sum(
            l.busy_seconds for l in self.uplinks_up + self.uplinks_down
        )

    def n_uplinks(self) -> int:
        return len(self.uplinks_up) + len(self.uplinks_down)


class FluidFlow:
    """One in-flight transfer under the fluid-flow (progressive-filling)
    model: ``nbytes`` of payload crossing ``hops`` — a list of
    ``(Link, weight)`` pairs, where ``weight`` is the link capacity the
    flow consumes per payload byte/s (1.0 for a NIC hop; 2.0 for the
    coordinator NIC on the relay route, which carries every byte twice).

    ``rate`` is the current max-min fair payload rate in bytes/s; it is
    re-assigned by :meth:`FluidNetwork._reallocate` every time any flow
    starts or finishes anywhere on the fabric.
    """

    __slots__ = (
        "fid", "src", "dst", "nbytes", "remaining", "hops", "rate",
        "on_done", "t_start",
    )

    def __init__(self, fid, src, dst, nbytes, hops, on_done, t_start):
        self.fid = fid
        self.src = src
        self.dst = dst
        self.nbytes = int(nbytes)
        self.remaining = float(nbytes)
        self.hops = hops
        self.rate = 0.0
        self.on_done = on_done
        self.t_start = t_start


class FluidNetwork:
    """Progressive-filling (max-min fair) fluid-flow engine over a
    :class:`NetworkModel` topology.

    The store-and-forward model reserves each link back-to-back: a
    transfer holds the whole link for ``bytes/bandwidth`` seconds and
    later transfers queue behind it.  Real fabrics multiplex: N flows
    sharing a link each progress at roughly ``capacity / N`` and every
    flow's rate changes whenever any flow starts or finishes.  This
    class models exactly that:

    * :meth:`start` registers a flow over the topology's path
      (source NIC, any shared uplinks, destination NIC) and re-rates
      **all** active flows by weighted progressive filling: repeatedly
      grant every unfrozen flow the smallest per-link fair share,
      freeze the flows crossing the bottleneck link, subtract their
      consumption, and continue — the textbook max-min fair water
      filling, with per-hop weights so the relay route's coordinator
      NIC (2 bytes crossed per payload byte) is charged honestly.
    * The engine is clock-agnostic: the owning simulator injects
      ``now()`` and ``post(t, fn)`` and the network posts itself one
      ``transfer_progress`` event at the earliest flow completion;
      stale events (rates changed since) are invalidated by a
      generation counter.
    * Byte and busy accounting land on the *same* :class:`Link`
      objects the store-and-forward path uses (``bytes_total``, and
      ``busy_seconds`` as utilization-integrated time), so
      ``SimResult.uplink_busy_s`` / rack byte counters read
      identically from either engine.

    Conservation is tracked first-class: ``bytes_injected`` equals
    ``bytes_delivered`` plus the payload of the flows still active at
    every instant (the invariant suite pins this).
    """

    def __init__(
        self,
        topo: NetworkModel,
        *,
        now: Callable[[], float],
        post: Callable[[float, Callable[[], None]], None],
    ) -> None:
        self.topo = topo
        self._now = now
        self._post = post
        self.flows: dict[int, FluidFlow] = {}
        # id(Link) -> {fid: weight} for active flows; id() keys because
        # the same Link object is shared with the reservation path.
        self._link_flows: dict[int, dict[int, float]] = {}
        self._links: dict[int, Link] = {}
        self._fid = itertools.count(1)
        self._t_last = 0.0
        self._gen = 0
        self.bytes_injected = 0
        self.bytes_delivered = 0
        self.flows_started = 0
        self.flows_completed = 0
        # Peak concurrent flows (sizing/diagnostic, shown in benches).
        self.max_concurrent = 0

    # -- public API ---------------------------------------------------------

    def start(
        self,
        src: Optional[int],
        dst: int,
        nbytes: int,
        on_done: Callable[[float], None],
        *,
        relay: bool = False,
    ) -> Optional[int]:
        """Begin a transfer; ``on_done(t)`` fires when the last byte
        lands.  Same-node copies complete immediately (synchronously).
        Returns the flow id, or None for the degenerate instant copy.
        """
        t = self._now()
        self._advance(t)
        if relay:
            hops: list[tuple[Link, float]] = []
            if src is not None and src != dst:
                hops.append((self.topo.egress[src], 1.0))
            hops.append((self.topo.coordinator, 2.0))
            hops.append((self.topo.ingress[dst], 1.0))
        else:
            hops = [(l, 1.0) for l in self.topo.path(src, dst)]
            self.topo.account_rack(src, dst, nbytes)
        if not hops or nbytes <= 0:
            on_done(t)
            return None
        fid = next(self._fid)
        flow = FluidFlow(fid, src, dst, nbytes, hops, on_done, t)
        self.flows[fid] = flow
        for link, w in hops:
            lid = id(link)
            self._links[lid] = link
            self._link_flows.setdefault(lid, {})[fid] = w
            link.bytes_total += int(nbytes * w)
        self.bytes_injected += int(nbytes)
        self.flows_started += 1
        self.max_concurrent = max(self.max_concurrent, len(self.flows))
        self._reallocate()
        self._schedule()
        return fid

    @property
    def n_active(self) -> int:
        return len(self.flows)

    def in_flight_bytes(self) -> float:
        return sum(f.remaining for f in self.flows.values())

    def conservation_error(self) -> float:
        """``injected - delivered - sum(active flow payloads)``; exactly
        0 at all times — non-zero means a flow was lost, registered
        twice, or delivered twice.  (``in_flight_bytes`` is the
        *remaining* payload, which mid-flight differs from the active
        payload by the bytes already moved.)"""
        return (
            self.bytes_injected
            - self.bytes_delivered
            - sum(f.nbytes for f in self.flows.values())
        )

    def link_rate(self, link: Link) -> float:
        """Current aggregate consumption on ``link`` (bytes/s)."""
        fl = self._link_flows.get(id(link), {})
        return sum(self.flows[fid].rate * w for fid, w in fl.items())

    # -- engine internals ---------------------------------------------------

    def _advance(self, t: float) -> None:
        """Progress every flow to time ``t`` and complete the finished
        ones (their callbacks may start new flows re-entrantly — state
        is consistent before any callback fires)."""
        dt = t - self._t_last
        if dt <= 0.0 or not self.flows:
            self._t_last = max(self._t_last, t)
            return
        for lid, fl in self._link_flows.items():
            if not fl:
                continue
            link = self._links[lid]
            cap = link.gb_s * _GB
            used = sum(self.flows[fid].rate * w for fid, w in fl.items())
            link.busy_seconds += (min(used, cap) / cap) * dt
        done: list[FluidFlow] = []
        for f in self.flows.values():
            f.remaining -= f.rate * dt
            if f.remaining <= _EPS_BYTES:
                done.append(f)
        self._t_last = t
        if not done:
            return
        done.sort(key=lambda f: f.fid)  # deterministic completion order
        for f in done:
            self._remove(f)
        self._reallocate()
        for f in done:
            self.bytes_delivered += f.nbytes
            self.flows_completed += 1
            f.on_done(t)

    def _remove(self, flow: FluidFlow) -> None:
        self.flows.pop(flow.fid, None)
        for link, _w in flow.hops:
            fl = self._link_flows.get(id(link))
            if fl is not None:
                fl.pop(flow.fid, None)

    def _reallocate(self) -> None:
        """Weighted progressive filling: assign every active flow its
        max-min fair payload rate.  O(bottlenecks x links x flows) —
        flows on the fabric at once are bounded by in-flight staging
        copies, so this stays cheap even at fleet scale."""
        if not self.flows:
            return
        residual: dict[int, float] = {}
        for lid, fl in self._link_flows.items():
            if fl:
                residual[lid] = self._links[lid].gb_s * _GB
        todo = set(self.flows)
        while todo:
            r_star: Optional[float] = None
            for lid, fl in self._link_flows.items():
                w_tot = 0.0
                for fid, w in fl.items():
                    if fid in todo:
                        w_tot += w
                if w_tot <= 0.0:
                    continue
                share = residual[lid] / w_tot
                if r_star is None or share < r_star:
                    r_star = share
            if r_star is None:  # pragma: no cover - defensive
                for fid in todo:
                    self.flows[fid].rate = 0.0
                break
            bound = r_star * (1.0 + 1e-12)
            frozen: set[int] = set()
            for lid, fl in self._link_flows.items():
                w_tot = 0.0
                for fid, w in fl.items():
                    if fid in todo:
                        w_tot += w
                if w_tot <= 0.0:
                    continue
                if residual[lid] / w_tot <= bound:
                    for fid in fl:
                        if fid in todo:
                            frozen.add(fid)
            for fid in frozen:
                f = self.flows[fid]
                f.rate = r_star
                for link, w in f.hops:
                    lid = id(link)
                    residual[lid] = max(residual[lid] - r_star * w, 0.0)
            todo -= frozen

    def _schedule(self) -> None:
        """Post the next ``transfer_progress`` event at the earliest
        flow completion; the generation counter invalidates any event
        posted before the latest re-rate."""
        self._gen += 1
        if not self.flows:
            return
        t_next = min(
            self._t_last + f.remaining / f.rate
            for f in self.flows.values()
            if f.rate > 0.0
        )
        gen = self._gen
        self._post(t_next, lambda: self._on_timer(gen))

    def _on_timer(self, gen: int) -> None:
        if gen != self._gen:
            return  # superseded by a later re-rate
        self._advance(self._now())
        self._schedule()


def build_network(
    kind: str,
    n_nodes: int,
    link_gb_s: float,
    *,
    rack_size: int = 4,
    oversubscription: float = 4.0,
    coordinator_gb_s: Optional[float] = None,
) -> NetworkModel:
    """Factory behind ``SimConfig.network``.

    ``"flat"`` — non-blocking single tier (default, seed-compatible
    plus source-NIC serialization); ``"fat_tree"`` (aliases
    ``"fat-tree"``, ``"fattree"``) — two-tier oversubscribed tree.
    """
    normalized = kind.lower().replace("-", "_").replace(" ", "_")
    if normalized == "flat":
        return FlatNetwork(
            n_nodes, link_gb_s, coordinator_gb_s=coordinator_gb_s
        )
    if normalized in ("fat_tree", "fattree"):
        return FatTreeNetwork(
            n_nodes,
            link_gb_s,
            rack_size=rack_size,
            oversubscription=oversubscription,
            coordinator_gb_s=coordinator_gb_s,
        )
    raise ValueError(f"unknown network model {kind!r}")
