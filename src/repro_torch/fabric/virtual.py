"""Virtual-time fabric execution — campaigns at testbed scale, no testbed.

The fluid-model executor for distribution trees, built from the same parts
as the service testbed and sharing its virtual clock:

  * per-edge steady-state rate ceilings come from the CALIBRATED per-chunk
    simulator (``core.simulator.simulate_transfer``) run on the two
    endpoints' site projections and the link's loss-degraded bandwidth — so
    checksum pipelining, mover caps and chunk-control overheads are folded
    into every hop exactly as they are for single-pipe predictions;
  * shared links and endpoints are arbitrated max-min fair across all
    concurrently-flowing tree edges (``core.simulator._maxmin_rates`` — the
    same progressive-filling allocator the WAN model uses internally);
  * store-and-forward coupling: an edge can forward no faster than custody
    arrives at its tail (cut-through at chunk granularity), so relay
    makespan approaches the slowest hop instead of the sum of hops;
  * campaign arrivals are activated tenant-fair under a concurrency cap via
    ``service.scheduler.select_activations`` — the same activation policy
    the real service and the testbed run;
  * the fault-scenario DSL applies: ``link_outage_at_50pct`` drops a seeded
    victim link to zero bandwidth for ``link_outage_s`` virtual seconds once
    the campaign set crosses the progress fraction; ``degrade_hop`` scales a
    seeded victim relay endpoint's rates by ``degrade_factor``; corruption
    at ``bytes_per_error`` costs chunk-granular re-moves per edge; endpoint
    *scheduled* outages (``Endpoint.outages`` windows) zero every edge
    touching the endpoint for the window.

Event stepping runs on ``core.vclock.VirtualClock`` like every other
virtual backend in the repo.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Sequence

import numpy as np

from repro_torch.core.simulator import (
    Gb,
    LinkConfig,
    TransferSpec,
    _maxmin_rates,
    simulate_transfer,
)
from repro_torch.core.vclock import VirtualClock, Window
from repro_torch.fabric.campaign import DistributionTree
from repro_torch.fabric.topology import RoutePlanner, Topology
from repro_torch.faults.injectors import _seed_int
from repro_torch.faults.scenarios import Scenario
from repro_torch.service.scheduler import DEFAULT_QUOTA, TenantQuota, select_activations


# ---------------------------------------------------------------------------
# submissions / reports
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CampaignSubmission:
    """One replication campaign entering the fabric at ``time_s``."""

    time_s: float
    tenant: str
    tree: DistributionTree
    nbytes: int
    label: str = ""


@dataclasses.dataclass
class FlowResult:
    campaign_id: str
    tenant: str
    label: str
    nbytes: int
    dests: tuple[str, ...]
    submit_s: float
    start_s: float | None = None
    done_s: float | None = None
    dest_done_s: dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def latency_s(self) -> float:
        assert self.done_s is not None
        return self.done_s - self.submit_s


@dataclasses.dataclass
class FabricFaultLog:
    corruptions: int = 0
    re_moved_bytes: float = 0.0
    link_outage_s: float = 0.0
    degraded_endpoints: tuple[str, ...] = ()


@dataclasses.dataclass
class FabricLoadReport:
    flows: list[FlowResult]
    makespan_s: float
    wire_bytes: float                # bytes that crossed WAN links (with re-moves)
    goodput_bytes: float             # replica bytes delivered (nbytes * n_dests)
    scenario: str = "clean"
    faults: FabricFaultLog = dataclasses.field(default_factory=FabricFaultLog)
    victims: dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def aggregate_gbps(self) -> float:
        return (
            self.goodput_bytes * 8 / 1e9 / self.makespan_s
            if self.makespan_s > 0 else 0.0
        )

    @property
    def all_done(self) -> bool:
        return all(f.done_s is not None for f in self.flows)


# ---------------------------------------------------------------------------
# per-edge steady-state rate prediction (core.simulator)
# ---------------------------------------------------------------------------
class EdgeRatePredictor:
    """Memoized per-hop rate ceilings from the calibrated per-chunk model."""

    def __init__(self, topo: Topology, *, chunk_bytes: int | None,
                 integrity: bool = True):
        self.topo = topo
        self.chunk_bytes = chunk_bytes
        self.integrity = integrity
        self._cache: dict[tuple, float] = {}

    def cap_gbps(self, u: str, v: str, nbytes: int) -> float:
        key = (u, v, nbytes)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        link = self.topo.link(u, v)
        a, b = self.topo.endpoint(u), self.topo.endpoint(v)
        spec = TransferSpec(
            file_bytes=(nbytes,),
            chunk_bytes=min(self.chunk_bytes, nbytes) if self.chunk_bytes else None,
            integrity=self.integrity,
            concurrency=min(a.movers, b.movers),
        )
        lnk = LinkConfig(
            wan_gbps=link.effective_gbps,
            chunk_latency_s=max(0.02, 2.0 * link.rtt_s),
        )
        secs = simulate_transfer(a.to_site(), b.to_site(), spec, lnk).seconds
        cap = nbytes * 8 / 1e9 / secs if secs > 0 else float("inf")
        self._cache[key] = cap
        return cap


# ---------------------------------------------------------------------------
# fluid engine internals
# ---------------------------------------------------------------------------
class _EdgeFlow:
    __slots__ = ("flow", "u", "v", "parent", "delivered", "cap_gbps",
                 "corrupt_slowdown", "rate")

    def __init__(self, flow: "_Flow", u: str, v: str,
                 parent: "_EdgeFlow | None", cap_gbps: float):
        self.flow, self.u, self.v, self.parent = flow, u, v, parent
        self.delivered = 0.0
        self.cap_gbps = cap_gbps
        self.corrupt_slowdown = 1.0   # goodput fraction after re-moved chunks
        self.rate = 0.0               # effective Gb/s this step

    @property
    def done(self) -> bool:
        return self.delivered >= self.flow.nbytes - 1e-6


class _Flow:
    def __init__(self, seq: int, sub: CampaignSubmission,
                 predictor: EdgeRatePredictor):
        self.seq = seq
        self.sub = sub
        self.nbytes = float(sub.nbytes)
        self.result = FlowResult(
            campaign_id=f"campaign-{seq:04d}-{sub.tenant}",
            tenant=sub.tenant, label=sub.label, nbytes=sub.nbytes,
            dests=sub.tree.dests, submit_s=sub.time_s,
        )
        by_node: dict[str, _EdgeFlow] = {}
        self.edges: list[_EdgeFlow] = []
        for u, v in sub.tree.edges:          # topo order: parent before child
            ef = _EdgeFlow(self, u, v, by_node.get(u),
                           predictor.cap_gbps(u, v, sub.nbytes))
            by_node[v] = ef
            self.edges.append(ef)

    @property
    def done(self) -> bool:
        return all(e.done for e in self.edges)


def run_fabric_load(
    topo: Topology,
    submissions: Sequence[CampaignSubmission],
    *,
    chunk_bytes: int | None = 500 * 1000 * 1000,
    integrity: bool = True,
    max_concurrent: int = 8,
    scenario: Scenario | None = None,
    seed: int = 0,
    quotas: dict[str, TenantQuota] | None = None,
    default_quota: TenantQuota = DEFAULT_QUOTA,
) -> FabricLoadReport:
    """Drive a set of replication campaigns through the fabric in virtual time."""
    predictor = EdgeRatePredictor(topo, chunk_bytes=chunk_bytes, integrity=integrity)
    flows = [
        _Flow(i, sub, predictor)
        for i, sub in enumerate(sorted(submissions, key=lambda s: (s.time_s,)))
    ]
    flog = FabricFaultLog()
    victims: dict[str, str] = {}

    # ---- seeded fault realisation over the whole campaign set
    used_links: list[tuple[str, str]] = []
    link_count: dict[tuple[str, str], int] = {}
    for f in flows:
        for e in f.edges:
            key = (e.u, e.v)
            if key not in link_count:
                used_links.append(key)
            link_count[key] = link_count.get(key, 0) + 1
    rng = random.Random(_seed_int(seed, "fabric-virtual",
                                  scenario.name if scenario else "clean"))
    victim_link: tuple[str, str] | None = None
    degraded: set[str] = set()
    if scenario is not None and scenario.link_outage_at_frac is not None and used_links:
        shared = [l for l in used_links if link_count[l] > 1]
        victim_link = rng.choice(sorted(shared or used_links))
        victims["link_outage"] = f"{victim_link[0]}->{victim_link[1]}"
    if scenario is not None and scenario.degrade_hops > 0:
        inner = sorted({
            e.u for f in flows for e in f.edges if e.parent is not None
        })
        if not inner:
            inner = sorted({e.v for f in flows for e in f.edges})
        for name in rng.sample(inner, min(scenario.degrade_hops, len(inner))):
            degraded.add(name)
        victims["degrade"] = ",".join(sorted(degraded))
        flog.degraded_endpoints = tuple(sorted(degraded))
    if scenario is not None and scenario.bytes_per_error is not None:
        crng = np.random.default_rng(_seed_int(seed, "corrupt"))
        eff_chunk = float(chunk_bytes or 500 * 1000 * 1000)
        for f in flows:
            for e in f.edges:
                n = int(crng.poisson(f.nbytes / scenario.bytes_per_error))
                if n:
                    extra = float(min(n * min(eff_chunk, f.nbytes), 4 * f.nbytes))
                    # a corrupt landing costs one chunk re-move on THIS hop:
                    # model as a goodput-rate haircut on the edge
                    e.corrupt_slowdown = f.nbytes / (f.nbytes + extra)
                    flog.corruptions += n
                    flog.re_moved_bytes += extra

    planned_wire = sum(f.nbytes * len(f.edges) for f in flows)
    outage_trigger = (
        scenario.link_outage_at_frac * planned_wire
        if scenario is not None and scenario.link_outage_at_frac is not None
        else None
    )
    link_outage_win: Window | None = None

    pending: list[_Flow] = []
    active: list[_Flow] = []
    finished: list[_Flow] = []
    served: dict[str, int] = {}
    ai = 0
    moved_wire = 0.0
    n_edges_total = sum(len(f.edges) for f in flows) or 1
    clock = VirtualClock(guard=200 * n_edges_total + 2000, label="fabric")

    def degrade_factor(name: str) -> float:
        return scenario.degrade_factor if name in degraded else 1.0

    def endpoint_dark(name: str, t: float) -> bool:
        return not topo.endpoint(name).available(t)

    def link_dark(u: str, v: str, t: float) -> bool:
        if link_outage_win is None or victim_link is None:
            return False
        if not link_outage_win.contains(t):
            return False
        return (u, v) == victim_link or (v, u) == victim_link

    def compute_rates(t: float) -> list[_EdgeFlow]:
        for f in active:
            for e in f.edges:
                e.rate = 0.0          # incl. done parents: no stale coupling
        live = [e for f in active for e in f.edges if not e.done]
        flowing = [
            e for e in live
            if not link_dark(e.u, e.v, t)
            and not endpoint_dark(e.u, t) and not endpoint_dark(e.v, t)
        ]
        if flowing:
            idx = {id(e): i for i, e in enumerate(flowing)}
            res: dict[str, tuple[float, list[int]]] = {}

            def add(name: str, cap_gbps: float, member: _EdgeFlow):
                cap = cap_gbps * Gb
                if name not in res:
                    res[name] = (cap, [])
                res[name][1].append(idx[id(member)])

            for e in flowing:
                link = topo.link(e.u, e.v)
                a, b = topo.endpoint(e.u), topo.endpoint(e.v)
                add(f"link:{e.u}->{e.v}", link.effective_gbps, e)
                add(f"out:{e.u}",
                    min(a.net_gbps, a.storage_gbps) * degrade_factor(e.u), e)
                add(f"in:{e.v}",
                    min(b.net_gbps, b.storage_gbps) * degrade_factor(e.v), e)
                ceiling = (
                    e.cap_gbps * e.corrupt_slowdown
                    * degrade_factor(e.u) * degrade_factor(e.v)
                )
                add(f"edge:{id(e)}", ceiling, e)
            _maxmin_rates(flowing, res)
            for e in flowing:
                e.rate = e.rate / Gb          # _maxmin_rates works in bytes/s
        # store-and-forward coupling, in topo order (parents precede children)
        for e in live:
            par = e.parent
            avail = e.flow.nbytes if par is None else par.delivered
            backlog = avail - e.delivered
            if backlog <= 1e-6:
                e.rate = min(e.rate, par.rate if par is not None else e.rate)
        return live

    def reschedule(t: float) -> None:
        free = max_concurrent - len(active)
        if free <= 0 or not pending:
            return
        by_tenant: dict[str, int] = {}
        for a in active:
            by_tenant[a.sub.tenant] = by_tenant.get(a.sub.tenant, 0) + 1
        chosen = select_activations(
            [(p.seq, p.result.campaign_id, p.sub.tenant) for p in pending],
            by_tenant, free_slots=free,
            quotas=quotas, default_quota=default_quota,
            served_by_tenant=served,
        )
        lut = {p.result.campaign_id: p for p in pending}
        for cid in chosen:
            f = lut[cid]
            pending.remove(f)
            f.result.start_s = t
            served[f.sub.tenant] = served.get(f.sub.tenant, 0) + 1
            active.append(f)

    while ai < len(flows) or pending or active:
        # admissions
        while ai < len(flows) and flows[ai].sub.time_s <= clock.now + 1e-12:
            pending.append(flows[ai])
            ai += 1
        reschedule(clock.now)
        live = compute_rates(clock.now)
        # wire traffic includes the re-moved chunks corruption costs: an edge
        # delivering goodput at rate r crosses the link at r / slowdown
        wire_Bps = sum(e.rate / e.corrupt_slowdown for e in live) * Gb

        cands: list[float] = []
        if ai < len(flows):
            cands.append(flows[ai].sub.time_s - clock.now)
        for e in live:
            if e.rate > 1e-12:
                cands.append((e.flow.nbytes - e.delivered) / (e.rate * Gb))
                par = e.parent
                if par is not None:
                    backlog = par.delivered - e.delivered
                    gap = (e.rate - par.rate) * Gb
                    if backlog > 1e-6 and gap > 1e-9:
                        cands.append(backlog / gap)   # catch-up: coupling binds
        if outage_trigger is not None and wire_Bps > 0 and moved_wire < outage_trigger:
            cands.append((outage_trigger - moved_wire) / wire_Bps)
        if link_outage_win is not None:
            b = link_outage_win.next_boundary(clock.now)
            if math.isfinite(b):
                cands.append(b)
        for f in active:                     # endpoint maintenance calendars
            for e in f.edges:
                if e.done:
                    continue
                for name in (e.u, e.v):
                    for w in topo.endpoint(name).outages:
                        b = w.next_boundary(clock.now)
                        if math.isfinite(b):
                            cands.append(b)
        dt = clock.tick(*cands)

        for e in live:
            if e.rate > 0:
                e.delivered += e.rate * Gb * dt
                par = e.parent
                ceiling = e.flow.nbytes if par is None else par.delivered
                e.delivered = min(e.delivered, ceiling)
        moved_wire += wire_Bps * dt

        if (outage_trigger is not None and moved_wire >= outage_trigger - 1e-6
                and link_outage_win is None and victim_link is not None):
            link_outage_win = Window(clock.now, scenario.link_outage_s)
            flog.link_outage_s = scenario.link_outage_s
            outage_trigger = None
        if link_outage_win is not None and clock.now >= link_outage_win.end - 1e-12:
            link_outage_win = None

        # completions: record dest arrival times, retire finished campaigns
        for f in list(active):
            for e in f.edges:
                if e.done and e.v in f.sub.tree.dests:
                    f.result.dest_done_s.setdefault(e.v, clock.now)
            if f.done:
                f.result.done_s = clock.now
                active.remove(f)
                finished.append(f)

    goodput = sum(float(f.nbytes) * len(f.sub.tree.dests) for f in flows)
    t0 = min((f.sub.time_s for f in flows), default=0.0)
    makespan = max((f.result.done_s or 0.0 for f in flows), default=0.0) - t0
    return FabricLoadReport(
        flows=[f.result for f in flows],
        makespan_s=makespan,
        wire_bytes=moved_wire,
        goodput_bytes=goodput,
        scenario=scenario.name if scenario is not None else "clean",
        faults=flog,
        victims=victims,
    )


# ---------------------------------------------------------------------------
# convenience entry points
# ---------------------------------------------------------------------------
def simulate_campaign(
    topo: Topology,
    tree: DistributionTree,
    nbytes: int,
    *,
    tenant: str = "default",
    **kw,
) -> FabricLoadReport:
    """One fan-out campaign, submitted at t=0."""
    return run_fabric_load(
        topo, [CampaignSubmission(0.0, tenant, tree, nbytes)], **kw)


def simulate_naive(
    topo: Topology,
    source: str,
    dests: Sequence[str],
    nbytes: int,
    *,
    planner: RoutePlanner | None = None,
    tenant: str = "default",
    **kw,
) -> FabricLoadReport:
    """N independent per-destination transfers (the pre-fabric baseline).

    Each destination gets its own best route executed as a degenerate
    single-branch tree; all N run concurrently and contend max-min fair for
    the shared trunk links a campaign tree would have crossed once.
    """
    planner = planner or RoutePlanner(topo)
    subs = []
    for d in dests:
        route = planner.best_route(source, d, nbytes)
        tree = DistributionTree(source=source, dests=(d,), edges=route.hops)
        subs.append(CampaignSubmission(0.0, tenant, tree, nbytes, label=f"naive:{d}"))
    return run_fabric_load(topo, subs, **kw)
