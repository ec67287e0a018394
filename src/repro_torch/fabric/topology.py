"""Multi-endpoint WAN fabric topology: endpoints, links, and route planning.

The paper's workloads move data "to, from, and among leadership computing
facilities, as well as other scientific facilities and the home institutions
of facility users" — a *graph* of endpoints, not a single pipe. This module
is the fabric's control-plane map:

  * ``Endpoint`` — one facility DTN pool: mover caps, staging-storage and
    checksum rates, whether it may act as a store-and-forward relay, and a
    scheduled-outage calendar (``core.vclock.Window``);
  * ``Link`` — one directed WAN edge with bandwidth, RTT, and packet loss.
    Loss degrades achievable bandwidth via the Mathis throughput bound
    applied to the paper's 64 movers x 4 TCP streams;
  * ``Topology`` — the registry + adjacency, with JSON round-tripping for
    the CLI (``transferd fabric --topology fabric.json``);
  * ``RoutePlanner`` — congestion-aware route planning: Dijkstra on per-link
    traversal seconds (RTT + bytes over the *residual* capacity after
    already-committed flows), Yen's algorithm for k-shortest simple paths,
    and a multi-source variant used to grow campaign distribution
    trees. Only ``relay``-capable endpoints may appear as intermediate
    store-and-forward hops.

Canonical shapes used by benchmarks and tests (``star_topology``,
``shared_trunk_topology``, ``fat_tree_topology``) are built here too, so the
"1 -> N over a shared trunk" wire-byte experiments are reproducible from a
single seed.
"""
from __future__ import annotations

import dataclasses
import heapq
import json
import math
import os
from typing import Iterable, Sequence

from repro_torch.core.simulator import SiteConfig
from repro_torch.core.vclock import Window

Gb = 1e9 / 8.0                     # bytes per Gigabit

# Mathis et al. TCP throughput bound, applied per stream with the paper's
# transfer shape (64 movers x 4 TCP streams): achievable <= C * MSS / (RTT *
# sqrt(loss)) per stream. Zero loss leaves the link at its configured rate.
MATHIS_C = 1.22
MSS_BYTES = 1460
DEFAULT_STREAMS = 64 * 4


class NoRouteError(RuntimeError):
    """No usable path between two endpoints (partition, outage, or caps)."""


@dataclasses.dataclass(frozen=True)
class Endpoint:
    """One facility's DTN pool as seen by the fabric control plane."""

    name: str
    movers: int = 64                 # concurrent data movers at this endpoint
    mover_gbps: float = 3.2          # per-mover network ceiling (paper §4)
    storage_gbps: float = 100.0      # staging-store ingest/egress ceiling
    cksum_gbps: float = 5.2          # per-mover re-read + checksum rate
    relay: bool = True               # may stage chunks as an intermediate hop
    outages: tuple[Window, ...] = () # scheduled maintenance windows

    def available(self, t: float) -> bool:
        return not any(w.contains(t) for w in self.outages)

    @property
    def net_gbps(self) -> float:
        """Aggregate mover-pool network ceiling."""
        return self.movers * self.mover_gbps

    def to_site(self) -> SiteConfig:
        """Project onto the calibrated simulator's site model.

        ``ost_gbps = storage_gbps`` makes the file-level stripe cap saturate
        at the staging-store ceiling, which is the right single-file model
        for a DTN staging area (no Lustre stripe sweep inside the fabric).
        """
        return SiteConfig(
            name=self.name, movers=self.movers, mover_gbps=self.mover_gbps,
            site_io_gbps=self.storage_gbps, ost_gbps=self.storage_gbps,
            cksum_gbps=self.cksum_gbps,
        )

    def to_json(self) -> dict:
        return {
            "name": self.name, "movers": self.movers,
            "mover_gbps": self.mover_gbps, "storage_gbps": self.storage_gbps,
            "cksum_gbps": self.cksum_gbps, "relay": self.relay,
            "outages": [[w.start, w.duration] for w in self.outages],
        }

    @staticmethod
    def from_json(obj: dict) -> "Endpoint":
        return Endpoint(
            name=obj["name"], movers=int(obj.get("movers", 64)),
            mover_gbps=float(obj.get("mover_gbps", 3.2)),
            storage_gbps=float(obj.get("storage_gbps", 100.0)),
            cksum_gbps=float(obj.get("cksum_gbps", 5.2)),
            relay=bool(obj.get("relay", True)),
            outages=tuple(Window(float(s), float(d))
                          for s, d in obj.get("outages", ())),
        )


@dataclasses.dataclass(frozen=True)
class Link:
    """One directed WAN edge."""

    src: str
    dst: str
    gbps: float = 100.0
    rtt_ms: float = 20.0
    loss: float = 0.0                # packet-loss fraction in [0, 1)

    def __post_init__(self):
        if self.gbps <= 0:
            raise ValueError(f"link {self.src}->{self.dst}: gbps must be > 0")
        if not (0.0 <= self.loss < 1.0):
            raise ValueError(f"link {self.src}->{self.dst}: loss must be in [0, 1)")

    @property
    def effective_gbps(self) -> float:
        """Loss-degraded achievable bandwidth (Mathis bound, 256 streams)."""
        if self.loss <= 0.0:
            return self.gbps
        per_stream_bps = (
            MATHIS_C * MSS_BYTES * 8 / ((self.rtt_ms / 1e3) * math.sqrt(self.loss))
        )
        return min(self.gbps, DEFAULT_STREAMS * per_stream_bps / 1e9)

    @property
    def rtt_s(self) -> float:
        return self.rtt_ms / 1e3

    def to_json(self) -> dict:
        return {"src": self.src, "dst": self.dst, "gbps": self.gbps,
                "rtt_ms": self.rtt_ms, "loss": self.loss}


@dataclasses.dataclass(frozen=True)
class Route:
    """One simple path through the fabric, with the planner's cost estimate."""

    nodes: tuple[str, ...]
    seconds: float = 0.0             # planner traversal estimate (not a sim)

    def __post_init__(self):
        if len(self.nodes) < 2:
            raise ValueError("a route needs at least two endpoints")
        if len(set(self.nodes)) != len(self.nodes):
            raise ValueError(f"route revisits an endpoint: {self.nodes}")

    @property
    def hops(self) -> tuple[tuple[str, str], ...]:
        return tuple(zip(self.nodes[:-1], self.nodes[1:]))

    @property
    def n_hops(self) -> int:
        return len(self.nodes) - 1

    @property
    def src(self) -> str:
        return self.nodes[0]

    @property
    def dst(self) -> str:
        return self.nodes[-1]


class Topology:
    """Endpoint registry + directed link graph."""

    def __init__(self):
        self._endpoints: dict[str, Endpoint] = {}
        self._links: dict[tuple[str, str], Link] = {}
        self._adj: dict[str, list[str]] = {}

    # -- construction -------------------------------------------------------
    def add_endpoint(self, ep: Endpoint | str, **kw) -> Endpoint:
        if isinstance(ep, str):
            ep = Endpoint(name=ep, **kw)
        elif kw:
            ep = dataclasses.replace(ep, **kw)
        if ep.name in self._endpoints:
            raise ValueError(f"duplicate endpoint {ep.name!r}")
        self._endpoints[ep.name] = ep
        self._adj.setdefault(ep.name, [])
        return ep

    def add_link(self, src: str, dst: str, *, gbps: float = 100.0,
                 rtt_ms: float = 20.0, loss: float = 0.0,
                 bidirectional: bool = True) -> None:
        for name in (src, dst):
            if name not in self._endpoints:
                raise ValueError(f"link references unknown endpoint {name!r}")
        pairs = [(src, dst)] + ([(dst, src)] if bidirectional else [])
        for u, v in pairs:
            if (u, v) in self._links:
                raise ValueError(f"duplicate link {u}->{v}")
            self._links[(u, v)] = Link(u, v, gbps=gbps, rtt_ms=rtt_ms, loss=loss)
            self._adj[u].append(v)

    # -- queries ------------------------------------------------------------
    @property
    def endpoints(self) -> dict[str, Endpoint]:
        return dict(self._endpoints)

    @property
    def links(self) -> dict[tuple[str, str], Link]:
        return dict(self._links)

    def endpoint(self, name: str) -> Endpoint:
        try:
            return self._endpoints[name]
        except KeyError:
            raise KeyError(f"unknown endpoint {name!r}") from None

    def link(self, u: str, v: str) -> Link:
        try:
            return self._links[(u, v)]
        except KeyError:
            raise KeyError(f"no link {u}->{v}") from None

    def neighbors(self, u: str) -> tuple[str, ...]:
        return tuple(self._adj.get(u, ()))

    # -- serialization (CLI topology files) ---------------------------------
    def to_json(self) -> dict:
        # a symmetric pair is stored once (bidirectional: true); an
        # asymmetric reverse link keeps its own directed entry
        emitted: set[tuple[str, str]] = set()
        links = []
        for (u, v), ln in sorted(self._links.items()):
            if (u, v) in emitted:
                continue
            rev = self._links.get((v, u))
            bidi = rev is not None and rev == Link(
                v, u, gbps=ln.gbps, rtt_ms=ln.rtt_ms, loss=ln.loss)
            links.append({**ln.to_json(), "bidirectional": bidi})
            emitted.add((u, v))
            if bidi:
                emitted.add((v, u))
        return {
            "endpoints": [ep.to_json() for _, ep in sorted(self._endpoints.items())],
            "links": links,
        }

    @staticmethod
    def from_json(obj: dict) -> "Topology":
        topo = Topology()
        for e in obj.get("endpoints", ()):
            topo.add_endpoint(Endpoint.from_json(e))
        for ln in obj.get("links", ()):
            topo.add_link(
                ln["src"], ln["dst"], gbps=float(ln.get("gbps", 100.0)),
                rtt_ms=float(ln.get("rtt_ms", 20.0)),
                loss=float(ln.get("loss", 0.0)),
                bidirectional=bool(ln.get("bidirectional", True)),
            )
        return topo

    @staticmethod
    def load(path: str | os.PathLike) -> "Topology":
        with open(path, "r", encoding="utf-8") as fh:
            return Topology.from_json(json.load(fh))

    def save(self, path: str | os.PathLike) -> None:
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(self.to_json(), fh, indent=2, sort_keys=True)


# ---------------------------------------------------------------------------
# route planning
# ---------------------------------------------------------------------------
class RoutePlanner:
    """Congestion-aware shortest / k-shortest route planning.

    Per-link traversal cost for a payload of ``nbytes``:

        rtt + nbytes / min(residual link bandwidth, endpoint ceilings)

    where residual bandwidth is the link's loss-degraded capacity minus the
    Gb/s already committed through it (``commit``/``release``), floored at
    ``min_residual_frac`` of capacity so a saturated link stays *expensive*
    rather than unreachable. Endpoint ceilings are the mover-pool and
    staging-store rates of both ends, so a slow DTN penalizes every route
    through it. Non-``relay`` endpoints are never used as intermediate hops,
    and endpoints inside a scheduled outage window at ``now`` are skipped.
    """

    def __init__(self, topo: Topology, *, min_residual_frac: float = 0.02):
        self.topo = topo
        self.min_residual_frac = min_residual_frac
        self._load: dict[tuple[str, str], float] = {}

    # -- congestion bookkeeping ---------------------------------------------
    def committed_gbps(self, u: str, v: str) -> float:
        return self._load.get((u, v), 0.0)

    def commit(self, route: Route, gbps: float) -> None:
        for u, v in route.hops:
            self._load[(u, v)] = self._load.get((u, v), 0.0) + gbps

    def release(self, route: Route, gbps: float) -> None:
        for u, v in route.hops:
            left = self._load.get((u, v), 0.0) - gbps
            if left <= 1e-12:
                self._load.pop((u, v), None)
            else:
                self._load[(u, v)] = left

    # -- cost model ---------------------------------------------------------
    def hop_gbps(self, u: str, v: str) -> float:
        """Residual end-to-end capacity of one hop (link + both endpoints)."""
        link = self.topo.link(u, v)
        residual = max(
            link.effective_gbps - self.committed_gbps(u, v),
            link.effective_gbps * self.min_residual_frac,
        )
        a, b = self.topo.endpoint(u), self.topo.endpoint(v)
        return min(residual, a.net_gbps, a.storage_gbps, b.net_gbps, b.storage_gbps)

    def hop_seconds(self, u: str, v: str, nbytes: int) -> float:
        link = self.topo.link(u, v)
        return link.rtt_s + nbytes / (self.hop_gbps(u, v) * Gb)

    def route_seconds(self, nodes: Sequence[str], nbytes: int) -> float:
        return sum(self.hop_seconds(u, v, nbytes) for u, v in zip(nodes, nodes[1:]))

    # -- shortest path ------------------------------------------------------
    def _usable(self, name: str, *, now: float, terminals: frozenset[str]) -> bool:
        ep = self.topo.endpoint(name)
        if not ep.available(now):
            return False
        return ep.relay or name in terminals

    def shortest_from_set(
        self, sources: Iterable[str], dst: str, nbytes: int, *,
        now: float = 0.0, banned_links: frozenset[tuple[str, str]] = frozenset(),
        banned_nodes: frozenset[str] = frozenset(),
    ) -> Route:
        """Multi-source Dijkstra: cheapest route from ANY source to ``dst``.

        The campaign tree construction grows a Steiner-ish tree with this: every
        node already in the tree is a zero-cost source, so a new destination
        attaches at the cheapest grafting point and shared trunk links are
        paid for exactly once.
        """
        sources = [s for s in sources if s not in banned_nodes]
        if not sources:
            raise NoRouteError(f"no usable source for {dst!r}")
        terminals = frozenset(sources) | {dst}
        dist: dict[str, float] = {s: 0.0 for s in sources}
        prev: dict[str, str | None] = {s: None for s in sources}
        heap: list[tuple[float, str]] = [(0.0, s) for s in sources]
        heapq.heapify(heap)
        settled: set[str] = set()
        while heap:
            d, u = heapq.heappop(heap)
            if u in settled:
                continue
            settled.add(u)
            if u == dst:
                nodes = [u]
                while prev[nodes[-1]] is not None:
                    nodes.append(prev[nodes[-1]])
                nodes.reverse()
                return Route(tuple(nodes), seconds=d)
            # only relay-capable (or terminal) nodes may be expanded through
            if u != dst and not self._usable(u, now=now, terminals=terminals):
                continue
            for v in self.topo.neighbors(u):
                if v in settled or v in banned_nodes or (u, v) in banned_links:
                    continue
                if not self._usable(v, now=now, terminals=terminals):
                    continue
                nd = d + self.hop_seconds(u, v, nbytes)
                if nd < dist.get(v, math.inf):
                    dist[v] = nd
                    prev[v] = u
                    heapq.heappush(heap, (nd, v))
        raise NoRouteError(f"no route to {dst!r} (from {sorted(sources)})")

    def best_route(self, src: str, dst: str, nbytes: int, *, now: float = 0.0) -> Route:
        if src == dst:
            raise ValueError("source and destination endpoints are identical")
        return self.shortest_from_set([src], dst, nbytes, now=now)

    def k_shortest(self, src: str, dst: str, nbytes: int, k: int, *,
                   now: float = 0.0) -> list[Route]:
        """Yen's algorithm: the k cheapest loop-free routes, cost-ordered."""
        if k < 1:
            raise ValueError("k must be >= 1")
        best = [self.best_route(src, dst, nbytes, now=now)]
        candidates: list[tuple[float, tuple[str, ...]]] = []
        seen: set[tuple[str, ...]] = {best[0].nodes}
        while len(best) < k:
            last = best[-1].nodes
            for i in range(len(last) - 1):
                spur, root = last[i], last[: i + 1]
                banned_links = {
                    (p[i], p[i + 1]) for p in (r.nodes for r in best)
                    if len(p) > i + 1 and p[: i + 1] == root
                }
                banned_nodes = frozenset(root[:-1])
                try:
                    tail = self.shortest_from_set(
                        [spur], dst, nbytes, now=now,
                        banned_links=frozenset(banned_links),
                        banned_nodes=banned_nodes,
                    )
                except NoRouteError:
                    continue
                nodes = root[:-1] + tail.nodes
                if nodes in seen:
                    continue
                seen.add(nodes)
                heapq.heappush(
                    candidates, (self.route_seconds(nodes, nbytes), nodes))
            if not candidates:
                break
            cost, nodes = heapq.heappop(candidates)
            best.append(Route(nodes, seconds=cost))
        return best


# ---------------------------------------------------------------------------
# canonical topologies (benchmarks + tests)
# ---------------------------------------------------------------------------
def star_topology(n_dests: int, *, trunk_gbps: float = 100.0,
                  leaf_gbps: float = 100.0, rtt_ms: float = 20.0,
                  relay_storage_gbps: float = 400.0) -> Topology:
    """``src -- hub -- {d0..dN-1}``: one shared first hop, N leaf links.

    Relay DTNs get ``relay_storage_gbps`` staging stores: a fan-out node
    re-reads the staged payload once per downstream branch.
    """
    topo = Topology()
    topo.add_endpoint("src")
    topo.add_endpoint("hub", storage_gbps=relay_storage_gbps)
    topo.add_link("src", "hub", gbps=trunk_gbps, rtt_ms=rtt_ms)
    for i in range(n_dests):
        topo.add_endpoint(f"d{i}")
        topo.add_link("hub", f"d{i}", gbps=leaf_gbps, rtt_ms=rtt_ms)
    return topo


def shared_trunk_topology(n_dests: int, *, trunk_hops: int = 3,
                          trunk_gbps: float = 100.0, leaf_gbps: float = 100.0,
                          rtt_ms: float = 20.0,
                          relay_storage_gbps: float = 400.0) -> Topology:
    """``src -- r1 -- ... -- r<trunk_hops> -- {d0..dN-1}``.

    The continental-trunk shape of the climate-replication case study: every
    replica shares ``trunk_hops`` WAN links before fanning out, so naive
    per-destination transfers pay the trunk N times while a campaign
    distribution tree pays it once.
    """
    if trunk_hops < 1:
        raise ValueError("trunk_hops must be >= 1")
    topo = Topology()
    topo.add_endpoint("src")
    prev = "src"
    for h in range(1, trunk_hops + 1):
        topo.add_endpoint(f"r{h}", storage_gbps=relay_storage_gbps)
        topo.add_link(prev, f"r{h}", gbps=trunk_gbps, rtt_ms=rtt_ms)
        prev = f"r{h}"
    for i in range(n_dests):
        topo.add_endpoint(f"d{i}")
        topo.add_link(prev, f"d{i}", gbps=leaf_gbps, rtt_ms=rtt_ms)
    return topo


def fat_tree_topology(n_dests: int, *, core_gbps: float = 400.0,
                      agg_gbps: float = 200.0, leaf_gbps: float = 100.0,
                      rtt_ms: float = 10.0, aggs: int = 2) -> Topology:
    """``src -- core -- {agg_j} -- {d_i}``: two-level distribution tree."""
    if aggs < 1:
        raise ValueError("aggs must be >= 1")
    topo = Topology()
    topo.add_endpoint("src")
    topo.add_endpoint("core", storage_gbps=4 * leaf_gbps)
    topo.add_link("src", "core", gbps=core_gbps, rtt_ms=rtt_ms)
    for j in range(aggs):
        topo.add_endpoint(f"agg{j}", storage_gbps=2 * leaf_gbps)
        topo.add_link("core", f"agg{j}", gbps=agg_gbps, rtt_ms=rtt_ms)
    for i in range(n_dests):
        topo.add_endpoint(f"d{i}")
        topo.add_link(f"agg{i % aggs}", f"d{i}", gbps=leaf_gbps, rtt_ms=rtt_ms)
    return topo


# One canonical fan-out factory map (name -> fn(n_dests) -> Topology) shared
# by the CLI (``transferd fabric --topology``) and ``benchmarks/fabric.py``,
# so the shape users reproduce is exactly the shape the CI wire-byte gate
# measures. "chain" is the shared-trunk case-study shape (3 WAN trunk hops).
BUILTIN_TOPOLOGIES = {
    "chain": lambda n: shared_trunk_topology(n, trunk_hops=3),
    "star": star_topology,
    "fat_tree": fat_tree_topology,
}
