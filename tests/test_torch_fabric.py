"""The port's fabric layer — topology, route planner, distribution trees,
relay, replication campaigns, virtual executor — against the reference.

Every test of ``tests/test_fabric.py`` runs here on both packages (``pkg``
is "repro" or "repro_torch"; the port's ``RelayTransfer`` and
``TransferService`` run with ``device="cpu"``, the digest kernels' plain
versions). Then the checks across packages on the same seeded inputs: a
relay — plain, tuned, and under a chaos campaign of the scenario DSL —
journals equal per-hop chunk digests, lands equal destination bytes and
heals the same number of corrupt landings, and a real replication campaign
reaches equal replica digests. The ``gpu`` tests run the relay on the card.

The reference is imported inside the tests (``_ns``), so the card's
machine, which has no JAX, can collect this file.
"""
import functools
import importlib
import itertools
import os
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

PKGS = ("repro", "repro_torch")
GB = 10**9
KiB, MiB = 1024, 1024 * 1024


@functools.lru_cache(maxsize=None)
def _ns(name: str) -> SimpleNamespace:
    """One package's fabric API under one set of names. The port's
    ``RelayTransfer`` and ``TransferService`` are bound to ``device="cpu"``."""
    core = importlib.import_module(f"{name}.core")
    fabric = importlib.import_module(f"{name}.fabric")
    svc = importlib.import_module(f"{name}.service")
    relay_cls, svc_cls = fabric.RelayTransfer, svc.TransferService
    if name == "repro_torch":
        relay_cls = functools.partial(relay_cls, device="cpu")
        svc_cls = functools.partial(svc_cls, device="cpu")
    return SimpleNamespace(
        name=name,
        BufferSource=core.BufferSource, BufferDest=core.BufferDest,
        ChunkJournal=core.ChunkJournal, FileDest=core.FileDest,
        fingerprint_bytes=core.fingerprint_bytes,
        Window=importlib.import_module(f"{name}.core.vclock").Window,
        CampaignRunner=fabric.CampaignRunner,
        DistributionTree=fabric.DistributionTree,
        NoRouteError=fabric.NoRouteError,
        RelayTransfer=relay_cls,
        relay_journal_paths=fabric.RelayTransfer.journal_paths,
        RoutePlanner=fabric.RoutePlanner, Topology=fabric.Topology,
        build_distribution_tree=fabric.build_distribution_tree,
        fat_tree_topology=fabric.fat_tree_topology,
        naive_wire_hops=fabric.naive_wire_hops,
        run_fabric_load=fabric.run_fabric_load,
        shared_trunk_topology=fabric.shared_trunk_topology,
        simulate_campaign=fabric.simulate_campaign,
        simulate_naive=fabric.simulate_naive,
        star_topology=fabric.star_topology,
        realize_hop_campaigns=importlib.import_module(
            f"{name}.fabric.relay").realize_hop_campaigns,
        CampaignSubmission=importlib.import_module(
            f"{name}.fabric.virtual").CampaignSubmission,
        parse_scenario=importlib.import_module(f"{name}.faults").parse_scenario,
        BatchConfig=svc.BatchConfig, ServiceConfig=svc.ServiceConfig,
        TransferService=svc_cls,
    )


@pytest.fixture(params=PKGS)
def pkg(request):
    return _ns(request.param)


# ---------------------------------------------------------------------------
# the tests of tests/test_fabric.py, on both packages
# ---------------------------------------------------------------------------
def _random_topology(pkg, seed: int, *, n: int = 6, p: float = 0.55):
    rng = np.random.default_rng(seed)
    topo = pkg.Topology()
    names = [f"n{i}" for i in range(n)]
    for name in names:
        topo.add_endpoint(name)
    for i, j in itertools.combinations(range(n), 2):
        if rng.random() < p:
            topo.add_link(
                names[i], names[j],
                gbps=float(rng.uniform(10.0, 200.0)),
                rtt_ms=float(rng.uniform(5.0, 80.0)),
            )
    return topo


def _all_simple_paths(topo, src: str, dst: str):
    """Exhaustive DFS over simple paths, honouring relay capability."""
    out = []

    def walk(node, path):
        if node == dst:
            out.append(tuple(path))
            return
        if node != src and not topo.endpoint(node).relay:
            return                          # can't store-and-forward here
        for nxt in topo.neighbors(node):
            if nxt not in path:
                walk(nxt, path + [nxt])

    walk(src, [src])
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_best_route_matches_brute_force(pkg, seed):
    topo = _random_topology(pkg, seed)
    planner = pkg.RoutePlanner(topo)
    nbytes = 5 * GB
    paths = _all_simple_paths(topo, "n0", "n5")
    if not paths:
        with pytest.raises(pkg.NoRouteError):
            planner.best_route("n0", "n5", nbytes)
        return
    costs = sorted(planner.route_seconds(p, nbytes) for p in paths)
    route = planner.best_route("n0", "n5", nbytes)
    assert route.seconds == pytest.approx(costs[0], rel=1e-9)
    assert planner.route_seconds(route.nodes, nbytes) == pytest.approx(
        route.seconds, rel=1e-9)


@pytest.mark.parametrize("seed", [0, 2, 4])
def test_k_shortest_matches_brute_force_top_k(pkg, seed):
    topo = _random_topology(pkg, seed)
    planner = pkg.RoutePlanner(topo)
    nbytes = 5 * GB
    paths = _all_simple_paths(topo, "n0", "n5")
    if not paths:
        pytest.skip("disconnected draw")
    k = min(4, len(paths))
    want = sorted(planner.route_seconds(p, nbytes) for p in paths)[:k]
    got = planner.k_shortest("n0", "n5", nbytes, k)
    assert len(got) == k
    assert [r.seconds for r in got] == pytest.approx(want, rel=1e-9)
    # ordered, loop-free, distinct
    assert all(a.seconds <= b.seconds + 1e-12 for a, b in zip(got, got[1:]))
    assert len({r.nodes for r in got}) == k


def test_non_relay_endpoint_never_intermediate(pkg):
    topo = pkg.Topology()
    for name in ("a", "b", "c", "d"):
        topo.add_endpoint(name, relay=(name != "b"))
    topo.add_link("a", "b", gbps=100.0, rtt_ms=1.0)    # short but through b
    topo.add_link("b", "c", gbps=100.0, rtt_ms=1.0)
    topo.add_link("a", "d", gbps=100.0, rtt_ms=50.0)   # long way around
    topo.add_link("d", "c", gbps=100.0, rtt_ms=50.0)
    route = pkg.RoutePlanner(topo).best_route("a", "c", GB)
    assert route.nodes == ("a", "d", "c")
    # b is still reachable as a TERMINAL
    assert pkg.RoutePlanner(topo).best_route("a", "b", GB).nodes == ("a", "b")


def test_outaged_endpoint_skipped_at_plan_time(pkg):
    topo = pkg.Topology()
    topo.add_endpoint("a")
    topo.add_endpoint("m", outages=(pkg.Window(0.0, 100.0),))
    topo.add_endpoint("m2")
    topo.add_endpoint("b")
    topo.add_link("a", "m", gbps=100.0, rtt_ms=1.0)
    topo.add_link("m", "b", gbps=100.0, rtt_ms=1.0)
    topo.add_link("a", "m2", gbps=100.0, rtt_ms=30.0)
    topo.add_link("m2", "b", gbps=100.0, rtt_ms=30.0)
    planner = pkg.RoutePlanner(topo)
    assert planner.best_route("a", "b", GB, now=50.0).nodes == ("a", "m2", "b")
    assert planner.best_route("a", "b", GB, now=200.0).nodes == ("a", "m", "b")


def test_congestion_shifts_routes(pkg):
    topo = pkg.Topology()
    for name in ("a", "m1", "m2", "b"):
        topo.add_endpoint(name)
    topo.add_link("a", "m1", gbps=100.0, rtt_ms=5.0)
    topo.add_link("m1", "b", gbps=100.0, rtt_ms=5.0)
    topo.add_link("a", "m2", gbps=100.0, rtt_ms=12.0)
    topo.add_link("m2", "b", gbps=100.0, rtt_ms=12.0)
    planner = pkg.RoutePlanner(topo)
    first = planner.best_route("a", "b", 50 * GB)
    assert first.nodes == ("a", "m1", "b")
    planner.commit(first, 95.0)                 # trunk nearly saturated
    second = planner.best_route("a", "b", 50 * GB)
    assert second.nodes == ("a", "m2", "b")
    planner.release(first, 95.0)
    assert planner.best_route("a", "b", 50 * GB).nodes == ("a", "m1", "b")


def test_loss_degrades_link_bandwidth(pkg):
    clean = pkg.Topology()
    for t in (clean,):
        t.add_endpoint("a"), t.add_endpoint("b")
    clean.add_link("a", "b", gbps=100.0, rtt_ms=20.0, loss=0.0)
    assert clean.link("a", "b").effective_gbps == pytest.approx(100.0)
    lossy = pkg.Topology()
    lossy.add_endpoint("a"), lossy.add_endpoint("b")
    lossy.add_link("a", "b", gbps=100.0, rtt_ms=20.0, loss=0.01)
    assert lossy.link("a", "b").effective_gbps < 100.0


def test_topology_json_roundtrip_keeps_asymmetric_links(pkg, tmp_path):
    topo = pkg.Topology()
    topo.add_endpoint("a"), topo.add_endpoint("b")
    topo.add_link("a", "b", gbps=100.0, bidirectional=False)
    topo.add_link("b", "a", gbps=10.0, bidirectional=False)   # asymmetric pair
    back = pkg.Topology.from_json(topo.to_json())
    assert set(back.links) == {("a", "b"), ("b", "a")}
    assert back.link("a", "b").gbps == 100.0
    assert back.link("b", "a").gbps == 10.0


def test_topology_json_roundtrip(pkg, tmp_path):
    topo = pkg.shared_trunk_topology(3, trunk_hops=2)
    path = tmp_path / "fabric.json"
    topo.save(path)
    back = pkg.Topology.load(path)
    assert set(back.endpoints) == set(topo.endpoints)
    assert set(back.links) == set(topo.links)
    assert back.link("src", "r1").gbps == topo.link("src", "r1").gbps
    r1 = pkg.RoutePlanner(topo).best_route("src", "d0", GB)
    r2 = pkg.RoutePlanner(back).best_route("src", "d0", GB)
    assert r1.nodes == r2.nodes


def test_tree_dedupes_shared_trunk(pkg):
    topo = pkg.shared_trunk_topology(4, trunk_hops=3)
    planner = pkg.RoutePlanner(topo)
    dests = ["d0", "d1", "d2", "d3"]
    tree = pkg.build_distribution_tree(planner, "src", dests, 10 * GB)
    assert tree.wire_hops == 3 + 4                      # trunk once + 4 leaves
    assert pkg.naive_wire_hops(planner, "src", dests, 10 * GB) == 4 * (3 + 1)
    assert tree.wire_bytes(10 * GB) == 7 * 10 * GB
    # every destination's in-tree path is a real route through the trunk
    for d in dests:
        assert tree.path(d) == ("src", "r1", "r2", "r3", d)


def test_tree_star_and_fat_tree_accounting(pkg):
    star = pkg.star_topology(3)
    ptree = pkg.build_distribution_tree(pkg.RoutePlanner(star), "src",
                                    ["d0", "d1", "d2"], GB)
    assert ptree.wire_hops == 1 + 3
    assert pkg.naive_wire_hops(pkg.RoutePlanner(star), "src", ["d0", "d1", "d2"], GB) == 6

    ft = pkg.fat_tree_topology(4, aggs=2)
    dests = ["d0", "d1", "d2", "d3"]
    tree = pkg.build_distribution_tree(pkg.RoutePlanner(ft), "src", dests, GB)
    # src->core, core->agg0/agg1, 4 leaf links
    assert tree.wire_hops == 1 + 2 + 4
    assert pkg.naive_wire_hops(pkg.RoutePlanner(ft), "src", dests, GB) == 4 * 3


def test_tree_validation_invariants(pkg):
    with pytest.raises(ValueError):                     # child before parent
        pkg.DistributionTree("s", ("d",), (("m", "d"), ("s", "m")))
    with pytest.raises(ValueError):                     # not a tree
        pkg.DistributionTree("s", ("d",), (("s", "d"), ("s", "d")))
    with pytest.raises(ValueError):                     # dest not covered
        pkg.DistributionTree("s", ("d", "e"), (("s", "d"),))
    t = pkg.DistributionTree("s", ("d",), (("s", "m"), ("m", "d")))
    assert t.parent("d") == "m" and t.children("s") == ("m",)


def test_tree_never_forwards_through_non_relay_destination(pkg):
    # d0 (relay=False) sits between src and d1 via a cheap shortcut; the
    # tree must still reach d1 through the relay-capable hub, because a
    # non-relay destination holds a replica but never re-serves it
    topo = pkg.Topology()
    topo.add_endpoint("src")
    topo.add_endpoint("hub")
    topo.add_endpoint("d0", relay=False)
    topo.add_endpoint("d1")
    topo.add_link("src", "hub", gbps=100.0, rtt_ms=10.0)
    topo.add_link("hub", "d0", gbps=100.0, rtt_ms=1.0)
    topo.add_link("d0", "d1", gbps=100.0, rtt_ms=1.0)     # tempting shortcut
    topo.add_link("hub", "d1", gbps=100.0, rtt_ms=40.0)   # the legal way
    tree = pkg.build_distribution_tree(pkg.RoutePlanner(topo), "src", ["d0", "d1"], GB)
    assert ("d0", "d1") not in tree.edges
    assert tree.path("d1") == ("src", "hub", "d1")


def test_tree_rejects_degenerate_campaigns(pkg):
    topo = pkg.star_topology(2)
    planner = pkg.RoutePlanner(topo)
    with pytest.raises(ValueError):
        pkg.build_distribution_tree(planner, "src", [], GB)
    with pytest.raises(ValueError):
        pkg.build_distribution_tree(planner, "src", ["src"], GB)


class _HostCrash(Exception):
    pass


def _relay_setup(pkg, tmp_path, *, nbytes=256 * 1024 + 13):
    payload = np.random.default_rng(7).integers(
        0, 256, nbytes, dtype=np.uint8).tobytes()
    topo = pkg.shared_trunk_topology(1, trunk_hops=2)
    route = pkg.RoutePlanner(topo).best_route("src", "d0", nbytes)
    return payload, route, str(tmp_path / "work"), str(tmp_path / "out.bin")


def test_relay_clean_end_to_end(pkg, tmp_path):
    payload, route, wd, out = _relay_setup(pkg, tmp_path)
    rep = pkg.RelayTransfer(
        route, pkg.BufferSource(payload), pkg.FileDest(out, len(payload)),
        workdir=wd, chunk_bytes=32 * 1024, movers=3,
    ).run()
    with open(out, "rb") as fh:
        assert fh.read() == payload
    assert rep.wire_bytes == route.n_hops * len(payload)
    assert [h.resumed_chunks for h in rep.hops] == [0] * route.n_hops
    assert rep.n_chunks == -(-len(payload) // (32 * 1024))


def test_relay_kill_restart_never_re_moves_journaled_chunks(pkg, tmp_path):
    payload, route, wd, out = _relay_setup(pkg, tmp_path)
    lock = threading.Lock()
    calls = [0]

    def bomb(_hop, _chunk, _attempt):
        with lock:
            calls[0] += 1
            if calls[0] > 9:
                raise _HostCrash("host died mid-relay")

    with pytest.raises((_HostCrash, RuntimeError)):
        pkg.RelayTransfer(
            route, pkg.BufferSource(payload), pkg.FileDest(out, len(payload)),
            workdir=wd, chunk_bytes=32 * 1024, movers=3, max_retries=0,
            fault_injector=bomb,
        ).run()

    journaled = {}
    for h, p in enumerate(pkg.relay_journal_paths(wd, route)):
        if os.path.exists(p):
            probe = pkg.ChunkJournal(p)
            journaled[h] = set(probe.records)
            probe.close()
    assert sum(len(s) for s in journaled.values()) > 0   # crash was mid-flight

    moved = []

    def record(hop, chunk, _attempt):
        with lock:
            moved.append((hop, chunk.index))

    rep = pkg.RelayTransfer(
        route, pkg.BufferSource(payload), pkg.FileDest(out, len(payload)),
        workdir=wd, chunk_bytes=32 * 1024, movers=3, fault_injector=record,
    ).run()
    with open(out, "rb") as fh:
        assert fh.read() == payload
    # the custody invariant, per hop: nothing journaled is ever re-moved
    re_moved = [(h, i) for (h, i) in set(moved) if i in journaled.get(h, set())]
    assert re_moved == []
    assert rep.resumed_chunks == sum(len(s) for s in journaled.values())


def test_relay_chaos_scenario_heals_and_verifies(pkg, tmp_path):
    payload, route, wd, out = _relay_setup(pkg, tmp_path)
    nbytes = len(payload)
    scenario = pkg.parse_scenario(
        "corrupt_1_per_TiB+link_outage_at_50pct+degrade_hop"
    ).scaled_to(nbytes, target_events=3.0)
    camps, victims = pkg.realize_hop_campaigns(
        scenario, route, total_bytes=nbytes, seed=11, movers=3)
    rep = pkg.RelayTransfer(
        route, pkg.BufferSource(payload), pkg.FileDest(out, nbytes),
        workdir=wd, chunk_bytes=32 * 1024, movers=3,
        source_wrapper=lambda h, s: camps[h].wrap_source(s),
        dest_wrapper=lambda h, d: camps[h].wrap_dest(d),
    ).run()
    with open(out, "rb") as fh:
        assert fh.read() == payload
    corrupt_writes = sum(c.stats.corrupt_writes for c in camps.values())
    assert corrupt_writes > 0                 # the scenario actually struck
    assert rep.refetches == corrupt_writes    # every landing healed once
    assert sum(h.outage_retries for h in rep.hops) > 0
    assert "link_outage" in victims and "degrade" in victims
    assert len(victims["degrade"]) == 1      # degrade_hops=1 -> one victim
    assert all(1 <= h < route.n_hops for h in victims["degrade"])


def test_realize_hop_campaigns_honors_degrade_count(pkg):
    topo = pkg.shared_trunk_topology(1, trunk_hops=3)      # 4-hop route
    nbytes = 64 * 1024
    route = pkg.RoutePlanner(topo).best_route("src", "d0", nbytes)
    scenario = pkg.parse_scenario("degrade_hop").replace(degrade_hops=2)
    _camps, victims = pkg.realize_hop_campaigns(
        scenario, route, total_bytes=nbytes, seed=1, movers=2)
    assert len(victims["degrade"]) == 2
    assert all(1 <= h < route.n_hops for h in victims["degrade"])


def _campaign_env(pkg, tmp_path, topo, nbytes):
    payload = np.random.default_rng(3).integers(
        0, 256, nbytes, dtype=np.uint8).tobytes()
    dirs = {}
    for name in topo.endpoints:
        dirs[name] = str(tmp_path / name)
        os.makedirs(dirs[name])
    with open(os.path.join(dirs["src"], "data.bin"), "wb") as fh:
        fh.write(payload)
    svc = pkg.TransferService(str(tmp_path / "svc"), pkg.ServiceConfig(
        mover_budget=4, max_concurrent_tasks=2, chunk_bytes=32 * 1024,
        tick_s=0.002, batch=pkg.BatchConfig(direct_bytes=1 << 30, batch_files=64),
    ))
    return payload, dirs, svc


def test_campaign_replicates_verifies_and_dedupes(pkg, tmp_path):
    topo = pkg.shared_trunk_topology(2, trunk_hops=2)
    nbytes = 96 * 1024 + 5
    payload, dirs, svc = _campaign_env(pkg, tmp_path, topo, nbytes)
    try:
        rep = pkg.CampaignRunner(svc, topo, dirs).replicate(
            "data.bin", "src", ["d0", "d1"], tenant="alice", timeout=60)
    finally:
        svc.close()
    assert rep.state == "SUCCEEDED"
    assert rep.replicas_verified == 2 and rep.integrity_escapes == 0
    # trunk paid once: 2 trunk hops + 2 leaves, vs naive 2 * 3
    assert rep.wire_bytes == 4 * nbytes
    assert rep.naive_wire_bytes == 6 * nbytes
    assert len(rep.edge_tasks) == 4
    for d in ("d0", "d1"):
        with open(os.path.join(dirs[d], "data.bin"), "rb") as fh:
            assert fh.read() == payload
    # the digest chain anchors every replica at the origin digest
    assert rep.origin_digest
    assert rep.replica_digests["d0"] == rep.origin_digest
    assert rep.replica_digests["d1"] == rep.origin_digest
    # edge tasks are ordinary service tasks under the campaign tenant
    st = svc.status(rep.edge_tasks[("src", "r1")])
    assert st.tenant == "alice" and st.state == "SUCCEEDED"


def test_campaign_tasks_carry_tenant_events(pkg, tmp_path):
    topo = pkg.star_topology(2)
    nbytes = 48 * 1024
    _payload, dirs, svc = _campaign_env(pkg, tmp_path, topo, nbytes)
    events = []
    svc.subscribe(lambda e: events.append(e))
    try:
        rep = pkg.CampaignRunner(svc, topo, dirs).replicate(
            "data.bin", "src", ["d0", "d1"], tenant="bob", timeout=60)
    finally:
        svc.close()
    assert rep.state == "SUCCEEDED"
    kinds = {e.kind for e in events}
    assert {"SUBMITTED", "ACTIVATED", "PROGRESS", "SUCCEEDED"} <= kinds
    assert {e.tenant for e in events if e.kind == "SUBMITTED"} == {"bob"}


def test_campaign_edge_timeout_cancels_and_fails(pkg, tmp_path):
    import time as _time

    topo = pkg.star_topology(1)
    nbytes = 64 * 1024
    payload = np.random.default_rng(5).integers(
        0, 256, nbytes, dtype=np.uint8).tobytes()
    dirs = {}
    for name in topo.endpoints:
        dirs[name] = str(tmp_path / name)
        os.makedirs(dirs[name])
    with open(os.path.join(dirs["src"], "data.bin"), "wb") as fh:
        fh.write(payload)
    svc = pkg.TransferService(
        str(tmp_path / "svc"),
        pkg.ServiceConfig(mover_budget=2, max_concurrent_tasks=2,
                      chunk_bytes=8 * 1024, tick_s=0.002,
                      batch=pkg.BatchConfig(direct_bytes=1 << 30, batch_files=64)),
        fault_injector=lambda *_a: _time.sleep(0.05),   # pace chunks
    )
    try:
        rep = pkg.CampaignRunner(svc, topo, dirs).replicate(
            "data.bin", "src", ["d0"], timeout=0.05)
        assert rep.state == "FAILED"
        assert "timed out" in (rep.error or "")
        # the hung edge task was canceled, not left running
        tid = rep.edge_tasks[("src", "hub")]
        st = svc.wait(tid, timeout=30)
        assert st.state == "CANCELED"
    finally:
        svc.close()


def test_virtual_campaign_wire_accounting_and_makespan(pkg):
    topo = pkg.shared_trunk_topology(4, trunk_hops=3)
    tree = pkg.build_distribution_tree(pkg.RoutePlanner(topo), "src",
                                   ["d0", "d1", "d2", "d3"], 100 * GB)
    camp = pkg.simulate_campaign(topo, tree, 100 * GB)
    naive = pkg.simulate_naive(topo, "src", ["d0", "d1", "d2", "d3"], 100 * GB)
    assert camp.all_done and naive.all_done
    assert camp.wire_bytes == pytest.approx(7 * 100 * GB, rel=1e-6)
    assert naive.wire_bytes == pytest.approx(16 * 100 * GB, rel=1e-6)
    assert naive.wire_bytes / camp.wire_bytes >= 2.0
    assert camp.makespan_s <= naive.makespan_s + 1e-6
    assert camp.goodput_bytes == pytest.approx(4 * 100 * GB)


def test_virtual_link_outage_and_degrade_slow_the_campaign(pkg):
    topo = pkg.shared_trunk_topology(2, trunk_hops=2)
    tree = pkg.build_distribution_tree(pkg.RoutePlanner(topo), "src",
                                   ["d0", "d1"], 50 * GB)
    clean = pkg.simulate_campaign(topo, tree, 50 * GB)
    outage = pkg.simulate_campaign(
        topo, tree, 50 * GB,
        scenario=pkg.parse_scenario("link_outage_at_50pct").replace(
            link_outage_s=100.0),
        seed=1,
    )
    assert outage.all_done
    assert outage.makespan_s > clean.makespan_s
    assert outage.faults.link_outage_s == 100.0
    assert "link_outage" in outage.victims

    degraded = pkg.simulate_campaign(
        topo, tree, 50 * GB, scenario=pkg.parse_scenario("degrade_hop"), seed=1)
    assert degraded.all_done
    assert degraded.makespan_s > clean.makespan_s
    assert degraded.faults.degraded_endpoints


def test_virtual_corruption_costs_re_moved_bytes(pkg):
    topo = pkg.star_topology(2)
    tree = pkg.build_distribution_tree(pkg.RoutePlanner(topo), "src", ["d0", "d1"],
                                   100 * GB)
    scenario = pkg.parse_scenario("corrupt_1_per_TiB").scaled_to(
        3 * 100 * GB, target_events=6.0)
    rep = pkg.simulate_campaign(topo, tree, 100 * GB, scenario=scenario, seed=5)
    assert rep.all_done
    assert rep.faults.corruptions > 0
    assert rep.faults.re_moved_bytes > 0
    # wire accounting includes the re-moved chunks, not just goodput
    clean_wire = tree.wire_bytes(100 * GB)
    assert rep.wire_bytes == pytest.approx(
        clean_wire + rep.faults.re_moved_bytes, rel=1e-3)


def _two_hop_topology(pkg, outages=()):
    topo = pkg.Topology()
    topo.add_endpoint("src")
    topo.add_endpoint("r1", storage_gbps=400.0, outages=tuple(outages))
    topo.add_endpoint("d0")
    topo.add_link("src", "r1", gbps=100.0, rtt_ms=20.0)
    topo.add_link("r1", "d0", gbps=100.0, rtt_ms=20.0)
    return topo


def test_virtual_endpoint_maintenance_window_delays(pkg):
    clean_topo = _two_hop_topology(pkg)
    # r1 goes dark for a mid-run maintenance window (not at plan time)
    dark_topo = _two_hop_topology(pkg, outages=(pkg.Window(2.0, 60.0),))
    tree = pkg.build_distribution_tree(pkg.RoutePlanner(clean_topo), "src", ["d0"], 50 * GB)
    clean = pkg.simulate_campaign(clean_topo, tree, 50 * GB)
    delayed = pkg.simulate_campaign(dark_topo, tree, 50 * GB)
    assert delayed.all_done
    assert delayed.makespan_s > clean.makespan_s + 50.0


def test_virtual_multi_tenant_load_tenant_fair(pkg):
    topo = pkg.shared_trunk_topology(2, trunk_hops=2)
    planner = pkg.RoutePlanner(topo)
    tree = pkg.build_distribution_tree(planner, "src", ["d0", "d1"], 10 * GB)
    subs = [
        pkg.CampaignSubmission(0.0, "alice", tree, 10 * GB),
        pkg.CampaignSubmission(0.0, "alice", tree, 10 * GB),
        pkg.CampaignSubmission(0.0, "bob", tree, 10 * GB),
    ]
    rep = pkg.run_fabric_load(topo, subs, max_concurrent=1)
    assert rep.all_done
    starts = {(f.tenant, f.start_s) for f in rep.flows}
    assert len(starts) == 3
    # stride-fair activation: bob's single campaign is not starved behind
    # alice's backlog — it starts second, not last
    order = sorted(rep.flows, key=lambda f: f.start_s)
    assert order[1].tenant == "bob"


def test_fabric_scenarios_parse_and_compose(pkg):
    s = pkg.parse_scenario("link_outage_at_50pct+degrade_hop")
    assert s.link_outage_at_frac == 0.5
    assert s.degrade_hops == 1
    assert not s.is_clean
    c = pkg.parse_scenario("corrupt_1_per_TiB+link_outage_at_50pct+degrade_hop")
    assert c.bytes_per_error is not None
    assert c.link_outage_at_frac == 0.5 and c.degrade_hops == 1
    assert pkg.parse_scenario("clean").is_clean




# ---------------------------------------------------------------------------
# replica-aware campaigns (tests/test_cas.py's fabric leg): the index
# probes' local verify digests on the service's device in the port
# ---------------------------------------------------------------------------
def test_campaign_replica_dedup_and_heal(pkg, tmp_path):
    from importlib import import_module

    cas = import_module(f"{pkg.name}.cas")
    deduped = import_module(f"{pkg.name}.fabric.campaign").DEDUPED
    index_kw = {"device": "cpu"} if pkg.name == "repro_torch" else {}
    topo = pkg.shared_trunk_topology(2, trunk_hops=2)
    nbytes = 96 * 1024 + 5
    payload, dirs, svc = _campaign_env(pkg, tmp_path, topo, nbytes)
    indexes = {name: cas.ChunkIndex(tmp_path / "idx" / name / "index.log", **index_kw)
               for name in topo.endpoints}
    try:
        runner = pkg.CampaignRunner(svc, topo, dirs, indexes=indexes)
        rep1 = runner.replicate("data.bin", "src", ["d0", "d1"], timeout=60)
        assert rep1.state == "SUCCEEDED" and rep1.edges_deduped == 0
        rep2 = runner.replicate("data.bin", "src", ["d0", "d1"], timeout=60)
        assert rep2.state == "SUCCEEDED"
        assert rep2.edges_deduped == len(rep2.edge_states) == 4
        assert set(rep2.edge_states.values()) == {deduped}
        assert rep2.wire_bytes == 0
        assert rep2.dedup_wire_bytes_saved == 4 * nbytes
        assert rep2.replicas_verified == 2 and rep2.integrity_escapes == 0
        assert rep2.origin_digest == rep1.origin_digest
        victim = os.path.join(dirs["d0"], "data.bin")
        with open(victim, "r+b") as fh:
            fh.seek(100)
            b = fh.read(1)
            fh.seek(100)
            fh.write(bytes([b[0] ^ 0x40]))
        rep3 = runner.replicate("data.bin", "src", ["d0", "d1"], timeout=60)
        assert rep3.state == "SUCCEEDED" and rep3.integrity_escapes == 0
        states = list(rep3.edge_states.values())
        assert states.count(deduped) == len(states) - 1     # one wire edge
        with open(victim, "rb") as fh:
            assert fh.read() == payload                     # healed
        assert rep3.replica_digests["d0"] == rep3.origin_digest
    finally:
        svc.close()
        for idx in indexes.values():
            idx.close()


# ---------------------------------------------------------------------------
# across packages: the same relay, the same journals
# ---------------------------------------------------------------------------
def _relay_run(pkg, tmp_path, mode, *, nbytes=256 * 1024 + 13, device=None):
    os.makedirs(tmp_path, exist_ok=True)
    payload, route, wd, out = _relay_setup(pkg, tmp_path, nbytes=nbytes)
    kw = {}
    camps = {}
    if mode == "tuned":
        kw = dict(tuning=True, granule_min=8 * KiB, tune_epoch_chunks=1)
    elif mode == "chaos":
        scenario = pkg.parse_scenario(
            "corrupt_1_per_TiB+link_outage_at_50pct+degrade_hop"
        ).scaled_to(len(payload), target_events=3.0)
        camps, _victims = pkg.realize_hop_campaigns(
            scenario, route, total_bytes=len(payload), seed=11, movers=3)
        kw = dict(source_wrapper=lambda h, s: camps[h].wrap_source(s),
                  dest_wrapper=lambda h, d: camps[h].wrap_dest(d))
    if device is not None:
        kw["device"] = device
    rep = pkg.RelayTransfer(
        route, pkg.BufferSource(payload), pkg.FileDest(out, len(payload)),
        workdir=wd, chunk_bytes=32 * KiB, movers=3, **kw,
    ).run()
    journals = []
    for p in pkg.relay_journal_paths(wd, route):
        probe = pkg.ChunkJournal(p)
        journals.append({i: r.digest_hex for i, r in probe.records.items()})
        probe.close()
    with open(out, "rb") as fh:
        landed = fh.read()
    assert landed == payload
    return {
        "file_digest": rep.file_digest.hexdigest(),
        "journals": journals,
        "landed": landed,
        "refetches": rep.refetches,
        "corrupt_writes": sum(c.stats.corrupt_writes for c in camps.values()),
        "moved_bytes": [h.moved_bytes for h in rep.hops],
    }


@pytest.mark.parametrize("mode", ["plain", "tuned", "chaos"])
def test_relay_equal_across_packages(tmp_path, mode):
    """One seeded source over the same 3-hop route: equal per-hop custody
    digests, destination bytes, refetch counts and moved bytes — with whole
    -chunk hops, with tuned granule hops (``[data, back]`` digests, granules
    down to 8 KiB, off the 32 KiB tile), and under a chaos campaign."""
    ref = _relay_run(_ns("repro"), tmp_path / "repro", mode)
    port = _relay_run(_ns("repro_torch"), tmp_path / "repro_torch", mode)
    assert port == ref
    assert ref["file_digest"] == _ns("repro").fingerprint_bytes(ref["landed"]).hexdigest()
    if mode == "chaos":
        assert ref["corrupt_writes"] > 0 and ref["refetches"] == ref["corrupt_writes"]


def test_relay_without_a_card_refuses_before_its_workdir(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default relay is valid here")
    from repro_torch.fabric import RelayTransfer

    pkg = _ns("repro_torch")
    payload, route, wd, out = _relay_setup(pkg, tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RelayTransfer(route, pkg.BufferSource(payload),
                      pkg.FileDest(out, len(payload)), workdir=wd)
    assert not os.path.exists(wd)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["plain", "tuned", "chaos"])
def test_cuda_relay_digests_on_the_card(cuda_device, tmp_path, mode):
    """The relay on the card equals the reference's on the host (when JAX is
    there) and launches the checksum kernels on every hop: tile-aligned
    chunks through ``checksum_many_words``, the ragged tail and sub-tile
    granules through ``checksum_words``."""
    from repro_torch.fabric import RelayTransfer
    from repro_torch.kernels import checksum as tck

    pkg = _ns("repro_torch")
    card = SimpleNamespace(**{**vars(pkg), "RelayTransfer": RelayTransfer})
    tck.reset_launch_counts()
    got = _relay_run(card, tmp_path / "card", mode, device=cuda_device)
    counts = tck.launch_counts()
    assert counts["checksum_many_words"] > 0 and counts["checksum_words"] > 0
    host = _relay_run(pkg, tmp_path / "cpu", mode)
    assert got == host
