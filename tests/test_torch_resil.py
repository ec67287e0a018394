"""The port's resilience plane — circuit breakers and health tracking, the
relay's mid-flight failover, campaign re-parenting, the scrubber — against
the reference.

Every test of ``tests/test_resil.py`` runs here on both packages (``pkg``
is "repro" or "repro_torch"; the port's ``RelayTransfer``,
``TransferService``, ``ChunkIndex`` and ``Scrubber`` run with
``device="cpu"``, the digest kernels' plain versions). Across packages: the
same seeded bit-rot (``corrupt_landed_regions``) over the same landed
replicas gives equal scrub reports, from a bare ``Scrubber`` and from a
service's ``scrub()``, and leaves equal repaired bytes.

The reference is imported inside the tests (``_ns``), so the card's machine,
which has no JAX, can collect this file.
"""
import dataclasses
import functools
import importlib
import os
import random
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
try:
    from hypothesis import given, settings, strategies as st
except ImportError:                                        # pragma: no cover
    from _hypofallback import given, settings, strategies as st

PKGS = ("repro", "repro_torch")
CHUNK = 16 * 1024
N_CHUNKS = 6
RESIL_SEEDS = range(20)


@functools.lru_cache(maxsize=None)
def _ns(name: str) -> SimpleNamespace:
    """One package's resilience API under one set of names. The port's
    device-taking classes are bound to ``device="cpu"``."""
    def mod(m):
        return importlib.import_module(f"{name}.{m}")

    cas, core, svc = mod("cas"), mod("core"), mod("service")
    campaign, relay, topology = mod("fabric.campaign"), mod("fabric.relay"), mod("fabric.topology")
    faults, resil, health, scrub = mod("faults"), mod("resil"), mod("resil.health"), mod("resil.scrub")
    transfer = mod("core.transfer")
    bound = dict(ChunkIndex=cas.ChunkIndex, ChunkedTransfer=transfer.ChunkedTransfer,
                 RelayTransfer=relay.RelayTransfer, Scrubber=scrub.Scrubber,
                 TransferService=svc.TransferService)
    if name == "repro_torch":
        bound = {k: functools.partial(v, device="cpu") for k, v in bound.items()}
    return SimpleNamespace(
        name=name, **bound,
        BufferSource=core.BufferSource, FileDest=core.FileDest,
        plan_chunks=core.plan_chunks,
        fingerprint_bytes=mod("core.integrity").fingerprint_bytes,
        BufferDest=transfer.BufferDest, EndpointOutage=transfer.EndpointOutage,
        CampaignRunner=campaign.CampaignRunner,
        build_distribution_tree=campaign.build_distribution_tree,
        Endpoint=topology.Endpoint, RoutePlanner=topology.RoutePlanner,
        Topology=topology.Topology,
        FaultCampaign=faults.FaultCampaign,
        corrupt_landed_regions=faults.corrupt_landed_regions,
        parse_scenario=faults.parse_scenario,
        BreakerConfig=resil.BreakerConfig, CircuitBreaker=resil.CircuitBreaker,
        HealthTracker=resil.HealthTracker,
        CLOSED=health.CLOSED, HALF_OPEN=health.HALF_OPEN, OPEN=health.OPEN,
        ScrubTarget=scrub.ScrubTarget,
        BatchConfig=svc.BatchConfig, ServiceConfig=svc.ServiceConfig,
        TaskSpec=svc.TaskSpec, TransferItem=svc.TransferItem,
        ev=mod("service.events"),
    )


@pytest.fixture(params=PKGS)
def pkg(request):
    return _ns(request.param)


# ---------------------------------------------------------------------------
# the tests of tests/test_resil.py, on both packages
# ---------------------------------------------------------------------------
def _cfg(pkg, **kw):
    defaults = dict(fail_threshold=3, open_ops=6, probe_ops=2, jitter=0.0)
    defaults.update(kw)
    return pkg.BreakerConfig(**defaults)


def test_breaker_opens_on_consecutive_failures(pkg):
    br = pkg.CircuitBreaker("ep:n1", _cfg(pkg))
    for _ in range(2):
        br.record(False)
    assert br.state == pkg.CLOSED
    br.record(False)
    assert br.state == pkg.OPEN
    assert br.transitions[-1].reason == "consecutive_failures"


def test_breaker_success_resets_the_streak(pkg):
    br = pkg.CircuitBreaker("ep:n1", _cfg(pkg))
    for _ in range(2):
        br.record(False)
    br.record(True)
    br.record(False)
    br.record(False)
    assert br.state == pkg.CLOSED


def test_breaker_ewma_trips_without_a_streak(pkg):
    # alternating failures never build a streak but push the error EWMA up
    br = pkg.CircuitBreaker("ep:n1", _cfg(pkg, fail_threshold=50, ewma_alpha=0.5,
                                      ewma_threshold=0.4, min_samples=6))
    for i in range(12):
        br.record(i % 2 == 0)
        if br.state == pkg.OPEN:
            break
    assert br.state == pkg.OPEN
    assert br.transitions[-1].reason == "ewma_error_rate"


def test_breaker_min_samples_shields_cold_start(pkg):
    br = pkg.CircuitBreaker("ep:n1", _cfg(pkg, fail_threshold=50, ewma_alpha=1.0,
                                      ewma_threshold=0.5, min_samples=8))
    br.record(False)          # EWMA jumps to 1.0 instantly, but samples < 8
    assert br.state == pkg.CLOSED


def test_breaker_cooldown_counts_ops_then_half_opens(pkg):
    br = pkg.CircuitBreaker("ep:n1", _cfg(pkg, open_ops=4))
    for _ in range(3):
        br.record(False)
    assert br.state == pkg.OPEN
    rejected = 0
    while not br.allow():
        rejected += 1
    assert rejected == 3           # 4 cooldown ops: 3 rejections + the admit
    assert br.state == pkg.HALF_OPEN


def test_breaker_probes_close_and_reset_escalation(pkg):
    br = pkg.CircuitBreaker("ep:n1", _cfg(pkg, open_ops=2, probe_ops=2))
    for _ in range(3):
        br.record(False)
    while not br.allow():
        pass
    br.record(True)
    assert br.state == pkg.HALF_OPEN
    br.record(True)
    assert br.state == pkg.CLOSED
    assert br.reopen_count == 0 and br.ewma == 0.0


def test_breaker_probe_failure_reopens_with_doubled_cooldown(pkg):
    br = pkg.CircuitBreaker("ep:n1", _cfg(pkg, open_ops=4))
    for _ in range(3):
        br.record(False)
    first = br._cooldown_ops if False else None  # noqa: F841  (doc: internal)
    while not br.allow():
        pass
    br.record(False)
    assert br.state == pkg.OPEN
    assert br.transitions[-1].reason == "probe_failed"
    # escalation: the second pkg.OPEN entry draws a doubled base cooldown
    r2 = 0
    while not br.allow():
        r2 += 1
    assert r2 >= 4                 # >= open_ops: doubled (jitter disabled)


def test_breaker_transitions_deterministic_across_same_seed_runs(pkg):
    script = random.Random(11)
    outcomes = [script.random() > 0.4 for _ in range(300)]
    snaps = []
    for _ in range(2):
        tr = pkg.HealthTracker(seed=5, config=pkg.BreakerConfig(
            fail_threshold=3, open_ops=8, probe_ops=2))
        rejected = []
        for i, ok in enumerate(outcomes):
            t = pkg.HealthTracker.link_target("u", "v")
            if tr.allow(t):
                tr.record(t, ok)
            else:
                rejected.append(i)
        snaps.append((tr.snapshot(), tuple(rejected)))
    assert snaps[0] == snaps[1]
    assert snaps[0][1], "script never tripped the breaker — test is vacuous"


def test_breaker_cooldowns_jittered_per_seed(pkg):
    lens = set()
    for seed in range(6):
        br = pkg.CircuitBreaker("ep:n1", pkg.BreakerConfig(
            fail_threshold=2, open_ops=64, jitter=0.5), seed=seed)
        br.record(False)
        br.record(False)
        n = 0
        while not br.allow():
            n += 1
        lens.add(n)
    assert len(lens) > 1, "cooldowns identical across seeds — jitter dead"


def test_tracker_targets_and_sick_listing(pkg):
    tr = pkg.HealthTracker(config=_cfg(pkg))
    ep, ln = pkg.HealthTracker.endpoint_target("dtn1"), pkg.HealthTracker.link_target("a", "b")
    assert ep == "ep:dtn1" and ln == "link:a->b"
    assert tr.healthy(ep) and tr.state(ep) == pkg.CLOSED and tr.allow(ep)
    for _ in range(3):
        tr.record(ln, False)
    assert not tr.healthy(ln) and tr.sick_targets() == (ln,)
    assert tr.healthy(ep)
    assert tr.error_rate(ln) > 0


def _diamond(pkg):
    topo = pkg.Topology()
    for n in ("S", "A", "B", "D"):
        topo.add_endpoint(pkg.Endpoint(n))
    topo.add_link("S", "A", gbps=100, rtt_ms=5)
    topo.add_link("A", "D", gbps=100, rtt_ms=5)
    topo.add_link("S", "B", gbps=50, rtt_ms=30)
    topo.add_link("B", "D", gbps=50, rtt_ms=30)
    return topo


class _DeadAfter:
    """ByteDest that hard-fails every write once ``live`` have landed."""

    def __init__(self, pkg, inner, live):
        self._outage = pkg.EndpointOutage
        self._inner, self._left = inner, live
        self._lock = threading.Lock()

    def write(self, offset, data):
        with self._lock:
            if self._left <= 0:
                raise self._outage("node died")
            self._left -= 1
        self._inner.write(offset, data)

    def read_back(self, offset, length):
        return self._inner.read_back(offset, length)


def _run_failover(pkg, tmp_path, payload, live_writes, *, tag=""):
    topo = _diamond(pkg)
    planner = pkg.RoutePlanner(topo)
    route = planner.best_route("S", "D", len(payload))
    assert "A" in route.nodes                  # the fast path crosses A
    out = str(tmp_path / f"out{tag}.bin")
    xfer = pkg.RelayTransfer(
        route, pkg.BufferSource(payload), pkg.FileDest(out, len(payload)),
        workdir=str(tmp_path / f"wd{tag}"), chunk_bytes=CHUNK, movers=2,
        outage_retries=6, outage_backoff_s=0.0005, retry_backoff_s=0.0005,
        planner=planner, failover=True, failover_outage_threshold=3,
        health=pkg.HealthTracker(seed=1),
        link_dest_wrapper=lambda u, v, d: _DeadAfter(pkg, d, live_writes)
        if v == "A" else d,
    )
    rep = xfer.run()
    with open(out, "rb") as fh:
        landed = fh.read()
    return rep, landed


@pytest.mark.parametrize("name", PKGS)
@settings(max_examples=8, deadline=None)
@given(boundary=st.integers(min_value=0, max_value=N_CHUNKS))
def test_failover_at_any_chunk_boundary_preserves_custody(name, boundary):
    """Property: whatever the boundary the victim dies at — before the first
    chunk, mid-transfer, or after its last — failover re-plans around it,
    re-moves ZERO journaled chunks, and the landed bytes (hence the digest
    chain) are exact."""
    pkg = _ns(name)
    import pathlib
    import tempfile
    payload = np.random.default_rng(boundary).integers(
        0, 256, N_CHUNKS * CHUNK + 37, dtype=np.uint8).tobytes()
    with tempfile.TemporaryDirectory(prefix="resil-prop-") as td:
        rep, landed = _run_failover(pkg, pathlib.Path(td), payload, boundary,
                                    tag=f"-{boundary}")
    assert landed == payload
    assert rep.re_moved_journaled == 0
    assert rep.failovers >= 1
    assert (pkg.fingerprint_bytes(landed).hexdigest()
            == pkg.fingerprint_bytes(payload).hexdigest())


def test_failover_emits_structured_events_and_retires_hops(pkg, tmp_path):
    payload = np.random.default_rng(0).integers(
        0, 256, 4 * CHUNK, dtype=np.uint8).tobytes()
    rep, landed = _run_failover(pkg, tmp_path, payload, 2)
    assert landed == payload
    assert rep.failovers >= 1 and rep.retired_hops
    for evt in rep.failover_events:
        assert evt["sick_link"] and evt["new_path"]
        assert evt["resumed_chunks"] >= 0


def test_failover_off_pins_the_route_and_fails(pkg, tmp_path):
    payload = np.random.default_rng(1).integers(
        0, 256, 4 * CHUNK, dtype=np.uint8).tobytes()
    topo = _diamond(pkg)
    planner = pkg.RoutePlanner(topo)
    route = planner.best_route("S", "D", len(payload))
    with pytest.raises(Exception):
        pkg.RelayTransfer(
            route, pkg.BufferSource(payload),
            pkg.FileDest(str(tmp_path / "out.bin"), len(payload)),
            workdir=str(tmp_path / "wd"), chunk_bytes=CHUNK, movers=2,
            outage_retries=4, outage_backoff_s=0.0005,
            planner=planner, failover=False,
            link_dest_wrapper=lambda u, v, d: _DeadAfter(pkg, d, 1)
            if v == "A" else d,
        ).run()


def _engine_leg(pkg, payload, scenario, seed):
    plan = pkg.plan_chunks(len(payload), 4, chunk_bytes=CHUNK,
                       min_chunk=1, max_chunk=1 << 40)
    camp = pkg.FaultCampaign(scenario, total_bytes=len(payload), seed=seed, movers=4)
    dst = pkg.BufferDest(len(payload))
    pkg.ChunkedTransfer(camp.wrap_source(pkg.BufferSource(payload)),
                    camp.wrap_dest(dst), plan, outage_backoff_s=0.0003).run()
    return bytes(dst.buf), camp.stats


@pytest.fixture(scope="module")
def small_payload():
    return np.random.default_rng(42).integers(
        0, 256, 4 * CHUNK + 11, dtype=np.uint8).tobytes()


def test_endpoint_down_window_survived_across_seeds(pkg, small_payload):
    sc = pkg.parse_scenario("endpoint_down_at_50pct").replace(down_ops=24)
    for seed in RESIL_SEEDS:
        landed, stats = _engine_leg(pkg, small_payload, sc, seed)
        assert landed == small_payload, seed
        assert stats.outage_rejections >= 24, seed


def test_link_flap_windows_survived_across_seeds(pkg, small_payload):
    sc = pkg.parse_scenario("link_flap").replace(flap_ops=4)
    for seed in RESIL_SEEDS:
        landed, stats = _engine_leg(pkg, small_payload, sc, seed)
        assert landed == small_payload, seed
        assert stats.outage_rejections >= 3 * 4, seed


def test_brownout_rejections_heal_on_retry_across_seeds(pkg, small_payload):
    sc = pkg.parse_scenario("brownout").replace(brownout_events=8)
    for seed in RESIL_SEEDS:
        landed, stats = _engine_leg(pkg, small_payload, sc, seed)
        assert landed == small_payload, seed
        assert stats.brownout_rejections == 8, seed


def test_bitrot_landed_flips_detected_and_repaired_across_seeds(pkg, tmp_path):
    payload = np.random.default_rng(9).integers(
        0, 256, 4 * CHUNK, dtype=np.uint8).tobytes()
    sc = pkg.parse_scenario("bitrot_landed")
    for seed in RESIL_SEEDS:
        d = tmp_path / f"s{seed}"
        os.makedirs(d)
        victim, donor = str(d / "victim.bin"), str(d / "donor.bin")
        for p in (victim, donor):
            with open(p, "wb") as fh:
                fh.write(payload)
        regions, targets = [], []
        with pkg.ChunkIndex(str(d / "idx.log"), fsync=False) as idx:
            for off in range(0, len(payload), CHUNK):
                blob = payload[off:off + CHUNK]
                hx = pkg.fingerprint_bytes(blob).hexdigest()
                idx.put(hx, len(blob), donor, off)
                regions.append((victim, off, len(blob)))
                targets.append(pkg.ScrubTarget(path=victim, offset=off,
                                           length=len(blob), digest_hex=hx))
            flipped = pkg.corrupt_landed_regions(regions, count=sc.bitrot_landed,
                                             seed=seed)
            assert len(flipped) == sc.bitrot_landed
            rep = pkg.Scrubber(index=idx).scrub(targets)
        assert rep.rot_detected == rep.repaired == sc.bitrot_landed, seed
        with open(victim, "rb") as fh:
            assert fh.read() == payload, seed


def test_corrupt_landed_regions_is_seed_deterministic(pkg, tmp_path):
    p = str(tmp_path / "f.bin")
    with open(p, "wb") as fh:
        fh.write(b"\x00" * 8192)
    regions = [(p, off, 1024) for off in range(0, 8192, 1024)]
    a = pkg.corrupt_landed_regions(regions, count=3, seed=7)
    with open(p, "rb") as fh:
        rotted = fh.read()
    with open(p, "wb") as fh:
        fh.write(b"\x00" * 8192)
    b = pkg.corrupt_landed_regions(regions, count=3, seed=7)
    with open(p, "rb") as fh:
        assert fh.read() == rotted
    assert a == b and len(a) == 3


class _DeadEdgeDest:
    def __init__(self, inner):
        self._inner = inner

    def write(self, offset, data):
        raise OSError("edge link dead")

    def read_back(self, offset, length):
        return self._inner.read_back(offset, length)


def test_campaign_failover_reparents_via_surviving_path(pkg, tmp_path):
    """The planned trunk S->A->B dies on its first edge; the campaign must
    re-parent B's delivery onto the surviving S->C->B path, verify the
    digest chain through the new parent, and record the failover."""
    topo = pkg.Topology()
    for n in ("S", "A", "B", "C"):
        topo.add_endpoint(pkg.Endpoint(n))
    topo.add_link("S", "A", gbps=100, rtt_ms=5)
    topo.add_link("A", "B", gbps=100, rtt_ms=5)
    topo.add_link("S", "C", gbps=50, rtt_ms=30)
    topo.add_link("C", "B", gbps=50, rtt_ms=30)
    dirs = {n: str(tmp_path / n) for n in topo.endpoints}
    for d in dirs.values():
        os.makedirs(d)
    payload = np.random.default_rng(2).integers(
        0, 256, 96 * 1024 + 7, dtype=np.uint8).tobytes()
    with open(os.path.join(dirs["S"], "f.bin"), "wb") as fh:
        fh.write(payload)

    labels = {}
    svc = pkg.TransferService(str(tmp_path / "svc"), pkg.ServiceConfig(
        mover_budget=4, max_concurrent_tasks=2, chunk_bytes=32 * 1024,
        tick_s=0.002, retry_backoff_s=0.001,
        batch=pkg.BatchConfig(direct_bytes=1 << 30, batch_files=64)),
        dest_wrapper=lambda tid, i, d: _DeadEdgeDest(d)
        if labels.get(tid, "").endswith("S->A") else d)
    orig_submit = svc.submit

    def submit(items, **kw):
        tids = orig_submit(items, **kw)
        for t in tids:
            labels[t] = kw.get("label", "")
        return tids

    svc.submit = submit
    events = []
    svc.subscribe(lambda e: events.append(e))
    try:
        tree = pkg.build_distribution_tree(pkg.RoutePlanner(topo), "S", ["B"], len(payload))
        assert ("S", "A") in tree.edges        # the doomed trunk was planned
        rep = pkg.CampaignRunner(svc, topo, dirs).replicate(
            "f.bin", "S", ["B"], tree=tree, failover="auto", timeout=60)
    finally:
        svc.close()
    assert rep.state == "SUCCEEDED"
    assert rep.failovers == 1 and rep.integrity_escapes == 0
    # the dead trunk's orphan relay A was dropped and B's subtree was
    # re-parented straight onto the surviving S->C->B path
    [fo] = rep.failover_events
    assert fo["edge"] == "A->B" and "unreachable" in fo["reason"]
    assert fo["new_parent"] == "S" and fo["new_path"] == ["S", "C", "B"]
    with open(os.path.join(dirs["B"], "f.bin"), "rb") as fh:
        assert fh.read() == payload
    assert rep.replica_digests["B"] == rep.origin_digest
    kinds = [e.kind for e in events]
    assert pkg.ev.FAILOVER in kinds and pkg.ev.FAILED in kinds


def test_campaign_failover_off_fails_on_dead_edge(pkg, tmp_path):
    topo = pkg.Topology()
    for n in ("S", "A", "B"):
        topo.add_endpoint(pkg.Endpoint(n))
    topo.add_link("S", "A", gbps=100, rtt_ms=5)
    topo.add_link("A", "B", gbps=100, rtt_ms=5)
    dirs = {n: str(tmp_path / n) for n in topo.endpoints}
    for d in dirs.values():
        os.makedirs(d)
    payload = b"x" * (48 * 1024)
    with open(os.path.join(dirs["S"], "f.bin"), "wb") as fh:
        fh.write(payload)
    labels = {}
    svc = pkg.TransferService(str(tmp_path / "svc"), pkg.ServiceConfig(
        mover_budget=4, chunk_bytes=32 * 1024, tick_s=0.002,
        retry_backoff_s=0.001,
        batch=pkg.BatchConfig(direct_bytes=1 << 30, batch_files=64)),
        dest_wrapper=lambda tid, i, d: _DeadEdgeDest(d)
        if labels.get(tid, "").endswith("S->A") else d)
    orig_submit = svc.submit

    def submit(items, **kw):
        tids = orig_submit(items, **kw)
        for t in tids:
            labels[t] = kw.get("label", "")
        return tids

    svc.submit = submit
    try:
        rep = pkg.CampaignRunner(svc, topo, dirs).replicate(
            "f.bin", "S", ["B"], failover="off", timeout=60)
    finally:
        svc.close()
    assert rep.state == "FAILED" and rep.failovers == 0


def _landed_file(tmp_path, name, payload):
    p = str(tmp_path / name)
    with open(p, "wb") as fh:
        fh.write(payload)
    return p


def _targets_for(pkg, path, payload, chunk=CHUNK):
    out = []
    for off in range(0, len(payload), chunk):
        blob = payload[off:off + chunk]
        out.append(pkg.ScrubTarget(path=path, offset=off, length=len(blob),
                               digest_hex=pkg.fingerprint_bytes(blob).hexdigest()))
    return out


def test_scrub_clean_pass_touches_everything(pkg, tmp_path):
    payload = os.urandom(3 * CHUNK + 5)
    p = _landed_file(tmp_path, "a.bin", payload)
    rep = pkg.Scrubber().scrub(_targets_for(pkg, p, payload))
    assert rep.scanned == 4 and rep.clean == 4
    assert rep.rot_detected == rep.repaired == rep.quarantined == 0
    assert rep.scanned_bytes == len(payload)


def test_scrub_quarantines_without_a_donor(pkg, tmp_path):
    payload = os.urandom(2 * CHUNK)
    p = _landed_file(tmp_path, "a.bin", payload)
    targets = _targets_for(pkg, p, payload)
    with open(p, "r+b") as fh:
        fh.seek(100)
        fh.write(b"\xff")
    quarantined = []
    rep = pkg.Scrubber(on_quarantine=quarantined.append).scrub(targets)
    assert rep.rot_detected == 1 and rep.quarantined == 1 and rep.repaired == 0
    assert quarantined == [targets[0]]


def test_scrub_repairs_from_replica_and_skips_self_donor(pkg, tmp_path):
    payload = os.urandom(2 * CHUNK)
    victim = _landed_file(tmp_path, "v.bin", payload)
    donor = _landed_file(tmp_path, "d.bin", payload)
    with pkg.ChunkIndex(str(tmp_path / "idx.log"), fsync=False) as idx:
        for off in range(0, len(payload), CHUNK):
            hx = pkg.fingerprint_bytes(payload[off:off + CHUNK]).hexdigest()
            # the rotted region itself is indexed too — the scrubber must not
            # "repair" from the very bytes it just found rotten
            idx.put(hx, CHUNK, victim, off)
            idx.put(hx, CHUNK, donor, off)
        with open(victim, "r+b") as fh:
            fh.seek(CHUNK + 9)
            fh.write(b"\x00" if payload[CHUNK + 9] != 0 else b"\x01")
        rep = pkg.Scrubber(index=idx).scrub(_targets_for(pkg, victim, payload))
    assert rep.rot_detected == 1 and rep.repaired == 1 and rep.quarantined == 0
    with open(victim, "rb") as fh:
        assert fh.read() == payload


def test_scrub_budget_and_cursor_round_robin(pkg, tmp_path):
    payload = os.urandom(4 * CHUNK)
    p = _landed_file(tmp_path, "a.bin", payload)
    targets = _targets_for(pkg, p, payload)
    sc = pkg.Scrubber(budget_bytes=2 * CHUNK)
    r1 = sc.scrub(targets)
    assert r1.scanned == 2 and r1.remaining == 2
    r2 = sc.scrub(targets)
    assert r2.scanned == 2 and r2.remaining == 2
    # two budgeted passes covered all four regions exactly once
    assert r1.scanned + r2.scanned == len(targets)


def test_scrub_missing_file_quarantines(pkg, tmp_path):
    t = pkg.ScrubTarget(path=str(tmp_path / "gone.bin"), offset=0, length=16,
                    digest_hex=pkg.fingerprint_bytes(b"x" * 16).hexdigest())
    rep = pkg.Scrubber().scrub([t])
    assert rep.quarantined == 1


def test_taskspec_failover_round_trips(pkg, tmp_path):
    svc = pkg.TransferService(str(tmp_path / "svc"), pkg.ServiceConfig(
        chunk_bytes=32 * 1024,
        batch=pkg.BatchConfig(direct_bytes=1 << 30, batch_files=64)))
    try:
        src = _landed_file(tmp_path, "f.bin", os.urandom(4096))
        [tid] = svc.submit([(src, src + ".out")], failover="auto", batch=False)
        svc.wait(tid, timeout=60)
        st_ = svc.status(tid)
        assert st_.failovers == 0 and st_.scrub_repairs == 0
        TaskSpec, TransferItem = pkg.TaskSpec, pkg.TransferItem
        spec = TaskSpec(task_id=tid, tenant="default", label="t",
                        items=(TransferItem(src, src + ".out", 4096),),
                        failover="auto")
        spec2 = TaskSpec.from_json(spec.to_json())
        assert spec2.failover == "auto"
        # a restarted service replays specs from its journal — the persisted
        # policy must survive the round trip on disk too
        import json
        assert json.loads(json.dumps(spec.to_json()))["failover"] == "auto"
    finally:
        svc.close()


def test_record_failover_bumps_status_and_emits(pkg, tmp_path):
    svc = pkg.TransferService(str(tmp_path / "svc"), pkg.ServiceConfig(
        chunk_bytes=32 * 1024,
        batch=pkg.BatchConfig(direct_bytes=1 << 30, batch_files=64)))
    events = []
    svc.subscribe(lambda e: events.append(e))
    try:
        src = _landed_file(tmp_path, "f.bin", os.urandom(4096))
        [tid] = svc.submit([(src, src + ".out")], batch=False)
        svc.wait(tid, timeout=60)
        svc.record_failover(tid, sick_link="a->b", new_path=["a", "c", "b"],
                            resumed_chunks=3, reason="outage")
        assert svc.status(tid).failovers == 1
        [fe] = [e for e in events if e.kind == pkg.ev.FAILOVER]
        assert fe.task_id == tid and fe.payload["sick_link"] == "a->b"
        with pytest.raises(KeyError):
            svc.record_failover("no-such-task")
    finally:
        svc.close()


def test_service_scrub_end_to_end_repairs_replica(pkg, tmp_path):
    """Land the same payload at two replicas (dedup indexes both), rot one,
    and svc.scrub() must repair it from the other — bumping the task's
    scrub_repairs counter and emitting SCRUB."""
    payload = np.random.default_rng(5).integers(
        0, 256, 96 * 1024, dtype=np.uint8).tobytes()
    src = _landed_file(tmp_path, "src.bin", payload)
    svc = pkg.TransferService(str(tmp_path / "svc"), pkg.ServiceConfig(
        dedup="on", chunk_bytes=32 * 1024,
        batch=pkg.BatchConfig(direct_bytes=1 << 30, batch_files=64)))
    events = []
    svc.subscribe(lambda e: events.append(e))
    try:
        [t1] = svc.submit([(src, str(tmp_path / "r1.bin"))], batch=False)
        svc.wait(t1, timeout=60)
        [t2] = svc.submit([(src, str(tmp_path / "r2.bin"))], batch=False)
        svc.wait(t2, timeout=60)
        targets = svc.scrub_targets()
        assert len(targets) == 2 * 3           # 3 chunks per replica
        regions = [(str(tmp_path / "r1.bin"), c.offset, c.length)
                   for c in targets if c.task_id == t1][:1]
        pkg.corrupt_landed_regions(regions, count=1, seed=3)
        rep = svc.scrub()
        assert rep.rot_detected == 1 and rep.repaired == 1
        assert rep.quarantined == 0
        assert svc.status(t1).scrub_repairs == 1
        assert svc.status(t2).scrub_repairs == 0
        with open(tmp_path / "r1.bin", "rb") as fh:
            assert fh.read() == payload
        scrub_events = [e for e in events if e.kind == pkg.ev.SCRUB]
        assert scrub_events and any(e.payload["repaired"] == 1
                                    for e in scrub_events)
        # a second pass is clean
        rep2 = svc.scrub()
        assert rep2.rot_detected == 0
    finally:
        svc.close()


def test_service_scrub_survives_restart(pkg, tmp_path):
    """A restarted service has no in-memory item reports — scrub must
    rebuild its targets from the on-disk chunk journals and still repair
    from the persisted CAS index."""
    payload = np.random.default_rng(8).integers(
        0, 256, 96 * 1024, dtype=np.uint8).tobytes()
    src = _landed_file(tmp_path, "src.bin", payload)
    cfg = pkg.ServiceConfig(dedup="on", chunk_bytes=32 * 1024,
                        batch=pkg.BatchConfig(direct_bytes=1 << 30, batch_files=64))
    svc = pkg.TransferService(str(tmp_path / "svc"), cfg)
    try:
        for dst in ("r1.bin", "r2.bin"):
            [tid] = svc.submit([(src, str(tmp_path / dst))], batch=False)
            svc.wait(tid, timeout=60)
    finally:
        svc.close()
    pkg.corrupt_landed_regions([(str(tmp_path / "r1.bin"), 0, 32 * 1024)],
                           count=1, seed=2)
    svc2 = pkg.TransferService(str(tmp_path / "svc"), cfg)
    try:
        targets = svc2.scrub_targets()
        assert len(targets) == 6           # journal-backed, not report-backed
        rep = svc2.scrub()
        assert rep.rot_detected == 1 and rep.repaired == 1
        with open(tmp_path / "r1.bin", "rb") as fh:
            assert fh.read() == payload
    finally:
        svc2.close()


def test_service_scrub_quarantine_emits_fault(pkg, tmp_path):
    payload = os.urandom(64 * 1024)
    src = _landed_file(tmp_path, "src.bin", payload)
    svc = pkg.TransferService(str(tmp_path / "svc"), pkg.ServiceConfig(
        chunk_bytes=32 * 1024,          # dedup off: no donors anywhere
        batch=pkg.BatchConfig(direct_bytes=1 << 30, batch_files=64)))
    events = []
    svc.subscribe(lambda e: events.append(e))
    try:
        [tid] = svc.submit([(src, str(tmp_path / "r1.bin"))], batch=False)
        svc.wait(tid, timeout=60)
        pkg.corrupt_landed_regions([(str(tmp_path / "r1.bin"), 0, 32 * 1024)],
                               count=1, seed=1)
        rep = svc.scrub()
        assert rep.rot_detected == 1 and rep.quarantined == 1
        faults = [e for e in events if e.kind == pkg.ev.FAULT]
        assert any(e.payload.get("quarantined") for e in faults)
        assert svc.status(tid).scrub_repairs == 0
    finally:
        svc.close()




# ---------------------------------------------------------------------------
# across packages: the same rot, the same scrub
# ---------------------------------------------------------------------------
def _rot_and_scrub(ns, d, payload, seed):
    os.makedirs(d)
    victim, donor = str(d / "victim.bin"), str(d / "donor.bin")
    for p in (victim, donor):
        with open(p, "wb") as fh:
            fh.write(payload)
    regions, targets = [], []
    with ns.ChunkIndex(str(d / "idx.log"), fsync=False) as idx:
        for off in range(0, len(payload), CHUNK):
            blob = payload[off:off + CHUNK]
            hx = ns.fingerprint_bytes(blob).hexdigest()
            idx.put(hx, len(blob), donor, off)
            regions.append((victim, off, len(blob)))
            targets.append(ns.ScrubTarget(path=victim, offset=off,
                                          length=len(blob), digest_hex=hx))
        flipped = ns.corrupt_landed_regions(regions, count=3, seed=seed)
        # one region rots beyond repair: its donor rots too
        with open(donor, "r+b") as fh:
            fh.seek(flipped[0][1])
            b = fh.read(1)
            fh.seek(flipped[0][1])
            fh.write(bytes([b[0] ^ 0x10]))
        rep = ns.Scrubber(index=idx).scrub(targets)
    with open(victim, "rb") as fh:
        landed = fh.read()
    report = dataclasses.asdict(rep)
    for key in ("quarantines", "repairs"):
        report[key] = [(t["offset"], t["length"], t["digest_hex"]) for t in report[key]]
    return report, flipped, landed


@pytest.mark.parametrize("seed", [0, 3])
def test_scrub_reports_equal_across_packages(tmp_path, seed):
    payload = np.random.default_rng(seed).integers(
        0, 256, 6 * CHUNK + 77, dtype=np.uint8).tobytes()
    ref = _rot_and_scrub(_ns("repro"), tmp_path / "repro", payload, seed)
    port = _rot_and_scrub(_ns("repro_torch"), tmp_path / "repro_torch", payload, seed)
    flips = lambda f: [(off, ln, extra) for (_p, off, ln, *extra) in f]  # noqa: E731
    assert flips(port[1]) == flips(ref[1])
    assert port[0] == ref[0] and port[2] == ref[2]
    assert ref[0]["rot_detected"] == 3 and ref[0]["repaired"] == 2
    assert ref[0]["quarantined"] == 1


def _service_rot_and_scrub(ns, root, payload, seed):
    os.makedirs(root)
    src = _landed_file(root, "src.bin", payload)
    svc = ns.TransferService(str(root / "svc"), ns.ServiceConfig(
        dedup="on", chunk_bytes=32 * 1024,
        batch=ns.BatchConfig(direct_bytes=1 << 30, batch_files=64)))
    try:
        [t1] = svc.submit([(src, str(root / "r1.bin"))], batch=False)
        svc.wait(t1, timeout=60)
        [t2] = svc.submit([(src, str(root / "r2.bin"))], batch=False)
        svc.wait(t2, timeout=60)
        regions = [(t.path, t.offset, t.length) for t in svc.scrub_targets(t2)]
        flipped = ns.corrupt_landed_regions(regions, count=2, seed=seed)
        rep = svc.scrub()
        st = svc.status(t2)
    finally:
        svc.close()
    with open(root / "r2.bin", "rb") as fh:
        landed = fh.read()
    return ((rep.scanned, rep.scanned_bytes, rep.clean, rep.rot_detected,
             rep.repaired, rep.quarantined),
            [(off, ln) for (_p, off, ln, *_x) in flipped], st.scrub_repairs, landed)


def test_service_scrub_equal_across_packages(tmp_path):
    payload = np.random.default_rng(11).integers(
        0, 256, 160 * 1024 + 3, dtype=np.uint8).tobytes()
    ref = _service_rot_and_scrub(_ns("repro"), tmp_path / "a", payload, 4)
    port = _service_rot_and_scrub(_ns("repro_torch"), tmp_path / "b", payload, 4)
    assert port == ref
    assert ref[0][3] == 2 and ref[3] == payload


def test_scrub_after_a_delta_checkpoint_raises(pkg, tmp_path):
    """Pins a fault of the reference that the port shares (ROADMAP Queue 3):
    on a service with a content index, ``scrub()`` after a full and a delta
    checkpoint save raises ``FileNotFoundError``. A checkpoint task's scrub
    targets name its leaf files under ``step_N.tmp/``, which the commit
    renames to ``step_N/``; the scrubber reads the missing region as rot,
    finds a donor through the index and opens the missing path to repair
    it. Neither package is fixed here: when one is, this test says so."""
    svc_mod = importlib.import_module(f"{pkg.name}.service")
    cfg = pkg.ServiceConfig(dedup="on", mover_budget=4, max_concurrent_tasks=3,
                            chunk_bytes=32 * 1024, tick_s=0.002)
    svc = pkg.TransferService(tmp_path / "svc", cfg)
    r = np.random.default_rng(3)
    state = {"w": r.standard_normal((96, 512)).astype(np.float32),
             "b": r.standard_normal(700).astype(np.float32)}
    if pkg.name == "repro_torch":
        import torch
        state = {k: torch.from_numpy(v) for k, v in state.items()}
    try:
        svc_mod.submit_checkpoint(svc, tmp_path / "ckpt", 1, state).wait(60)
        state["w"][:4] += 1.0
        sub = svc_mod.submit_checkpoint(svc, tmp_path / "ckpt", 2, state, delta=True)
        sub.wait(60)
        assert sub.status().chunks_deduped > 0
        with pytest.raises(FileNotFoundError, match=r"step_0000000\d\.tmp"):
            svc.scrub()
    finally:
        svc.close()
