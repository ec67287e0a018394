"""The port's fault injection — the scenario DSL and the seeded injectors —
against the reference, on the engines and the service they wrap.

Every test of ``tests/test_faults.py`` runs here on both packages (``pkg``
is "repro" or "repro_torch"; the port's ``ChunkedTransfer`` and
``TransferService`` run with ``device="cpu"``, the digest kernels' plain
versions), with the stale-index legs of ``tests/test_cas.py``. Across
packages: every scenario of the conformance matrix parses to the same
scenario, realises the same seeded corruption plan, and drives the
virtual-time testbed to the same report. And one property of the port
alone: a digest that fails on the device is a task error — generic retries,
then FAILED with the device's error in the fault report — never a corrupt
chunk and never a host digest.

The reference is imported inside the tests (``_ns``), so the card's machine,
which has no JAX, can collect this file.
"""
import dataclasses
import functools
import importlib
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from _doubles import SlowReadBackWrapper

PKGS = ("repro", "repro_torch")
CHUNK = 64 * 1024


@functools.lru_cache(maxsize=None)
def _ns(name: str) -> SimpleNamespace:
    """One package's fault and engine API under one set of names. The port's
    ``ChunkedTransfer``, ``TransferService`` and ``ChunkIndex`` are bound to
    ``device="cpu"``."""
    core = importlib.import_module(f"{name}.core")
    faults = importlib.import_module(f"{name}.faults")
    svc = importlib.import_module(f"{name}.service")
    cas = importlib.import_module(f"{name}.cas")
    engine, svc_cls, index_cls = core.ChunkedTransfer, svc.TransferService, cas.ChunkIndex
    if name == "repro_torch":
        engine = functools.partial(engine, device="cpu")
        svc_cls = functools.partial(svc_cls, device="cpu")
        index_cls = functools.partial(index_cls, device="cpu")
    return SimpleNamespace(
        name=name,
        BufferDest=core.BufferDest, BufferSource=core.BufferSource,
        ChunkedTransfer=engine, ChunkJournal=core.ChunkJournal,
        EndpointOutage=core.EndpointOutage, IntegrityError=core.IntegrityError,
        MoverCrash=core.MoverCrash, fingerprint_bytes=core.fingerprint_bytes,
        plan_chunks=core.plan_chunks,
        FULL_MATRIX=faults.FULL_MATRIX, FABRIC_MATRIX=faults.FABRIC_MATRIX,
        FaultCampaign=faults.FaultCampaign, FaultStats=faults.FaultStats,
        SCENARIOS=faults.SCENARIOS, Scenario=faults.Scenario,
        parse_scenario=faults.parse_scenario,
        corrupt_index_backing=faults.corrupt_index_backing,
        BatchConfig=svc.BatchConfig, ServiceConfig=svc.ServiceConfig,
        TransferService=svc_cls, run_load=svc.run_load,
        Submission=svc.Submission, ChunkIndex=index_cls,
        SlowReadBackWrapper=SlowReadBackWrapper,
    )


@pytest.fixture(params=PKGS)
def pkg(request):
    return _ns(request.param)


# ---------------------------------------------------------------------------
# the tests of tests/test_faults.py, on both packages
# ---------------------------------------------------------------------------
@pytest.fixture
def payload(rng):
    return rng.integers(0, 256, 1024 * 1024 + 17, dtype=np.uint8).tobytes()


def make_plan(pkg, n, movers=6):
    return pkg.plan_chunks(n, movers, chunk_bytes=CHUNK, min_chunk=1, max_chunk=1 << 40)


def run_campaign(pkg, payload, scenario, seed=0, movers=6, **engine_kw):
    plan = make_plan(pkg, len(payload), movers)
    camp = pkg.FaultCampaign(scenario, total_bytes=len(payload), seed=seed, movers=movers)
    dst = pkg.BufferDest(len(payload))
    eng = pkg.ChunkedTransfer(
        camp.wrap_source(pkg.BufferSource(payload)), camp.wrap_dest(dst), plan,
        **engine_kw,
    )
    return eng.run(), dst, camp


def test_scenario_composition_and_parse(pkg):
    sc = pkg.parse_scenario("corrupt_1_per_TiB+kill_2_movers+outage_at_50pct")
    assert sc.bytes_per_error == float(1024**4)
    assert sc.kill_movers == 2 and sc.outage_at_frac == 0.5
    assert sc.name == "corrupt_1_per_TiB+kill_2_movers+outage_at_50pct"
    assert (pkg.SCENARIOS["clean"] + pkg.SCENARIOS["kill_2_movers"]).kill_movers == 2
    with pytest.raises(ValueError):
        pkg.parse_scenario("no_such_scenario")
    with pytest.raises(ValueError):
        pkg.Scenario(kill_at_frac=1.5)


def test_scenario_scaled_to_payload(pkg):
    sc = pkg.SCENARIOS["corrupt_1_per_TiB"].scaled_to(1_000_000, target_events=4)
    assert sc.bytes_per_error == 250_000
    assert pkg.SCENARIOS["kill_2_movers"].scaled_to(1_000_000).bytes_per_error is None


def test_campaign_determinism(pkg):
    sc = pkg.SCENARIOS["corrupt_1_per_TiB"].scaled_to(1 << 20, target_events=8)
    a = pkg.FaultCampaign(sc, total_bytes=1 << 20, seed=3)
    b = pkg.FaultCampaign(sc, total_bytes=1 << 20, seed=3)
    c = pkg.FaultCampaign(sc, total_bytes=1 << 20, seed=4)
    assert a._corrupt == b._corrupt and a.planned_corruptions > 0
    assert a._corrupt != c._corrupt


def test_corruption_every_injection_caught_and_healed(pkg, payload):
    sc = pkg.SCENARIOS["corrupt_1_per_TiB"].scaled_to(len(payload), target_events=6)
    for seed in range(3):
        rep, dst, camp = run_campaign(pkg, payload, sc, seed=seed)
        assert bytes(dst.buf) == payload                      # zero escapes
        assert camp.stats.corrupt_writes > 0 or camp.planned_corruptions == 0
        assert rep.refetches == camp.stats.corrupt_writes     # all caught
        assert rep.file_digest == pkg.fingerprint_bytes(payload)
        # quarantine carries the diagnosis
        assert len(rep.quarantined) == rep.refetches
        assert all("corruption" in q.detail for q in rep.quarantined)


def test_persistent_corruption_exhausts_refetch_budget(pkg, payload):
    plan = make_plan(pkg, len(payload))

    class AlwaysCorrupt(pkg.BufferDest):
        def write(self, offset, data):
            if offset == plan.chunks[2].offset:
                data = bytes([data[0] ^ 0x01]) + data[1:]     # sticky bit error
            super().write(offset, data)

    with pytest.raises(pkg.IntegrityError, match="re-fetches"):
        pkg.ChunkedTransfer(pkg.BufferSource(payload), AlwaysCorrupt(len(payload)), plan,
                        max_refetches=2).run()


def run_pipelined_campaign(pkg, payload, scenario, seed=0, movers=4, lag=True,
                           **engine_kw):
    plan = make_plan(pkg, len(payload), movers)
    camp = pkg.FaultCampaign(scenario, total_bytes=len(payload), seed=seed, movers=movers)
    dst = pkg.BufferDest(len(payload))
    wrapped = camp.wrap_dest(pkg.SlowReadBackWrapper(dst, 0.003) if lag else dst)
    eng = pkg.ChunkedTransfer(
        camp.wrap_source(pkg.BufferSource(payload)), wrapped, plan,
        pipeline="pipelined", integrity_workers=2, **engine_kw,
    )
    return eng.run(), dst, camp


def test_pipelined_corruption_caught_by_lagging_verifier(pkg, payload):
    """Corruption detected by the DEFERRED verifier (chunks behind the mover)
    must still quarantine the landing and heal by source re-fetch within the
    same budget — zero escapes, every corrupt write caught."""
    sc = pkg.SCENARIOS["corrupt_1_per_TiB"].scaled_to(len(payload), target_events=6)
    for seed in range(3):
        rep, dst, camp = run_pipelined_campaign(pkg, payload, sc, seed=seed)
        assert bytes(dst.buf) == payload, seed                # zero escapes
        assert camp.stats.corrupt_writes > 0 or camp.planned_corruptions == 0
        assert rep.refetches == camp.stats.corrupt_writes     # all caught
        assert len(rep.quarantined) == rep.refetches
        assert all("corruption" in q.detail for q in rep.quarantined)
        assert rep.file_digest == pkg.fingerprint_bytes(payload)


def test_pipelined_persistent_corruption_exhausts_budget(pkg, payload):
    plan = make_plan(pkg, len(payload))

    class AlwaysCorrupt(pkg.BufferDest):
        def write(self, offset, data):
            if offset == plan.chunks[2].offset:
                data = bytes([data[0] ^ 0x01]) + bytes(data[1:])
            super().write(offset, data)

    with pytest.raises(pkg.IntegrityError, match="re-fetches"):
        pkg.ChunkedTransfer(pkg.BufferSource(payload), AlwaysCorrupt(len(payload)), plan,
                        max_refetches=2, pipeline="pipelined").run()


def test_pipelined_compound_campaign_full_recovery(pkg, payload):
    """The failure cocktail against the pipelined engine: corruption caught
    by deferred verify, mover deaths re-queued, outages waited out."""
    sc = pkg.parse_scenario("corrupt_1_per_TiB+kill_2_movers+outage_at_50pct")
    sc = sc.scaled_to(len(payload), target_events=5)
    rep, dst, camp = run_pipelined_campaign(pkg, payload, sc, seed=1)
    assert bytes(dst.buf) == payload
    assert rep.refetches == camp.stats.corrupt_writes
    assert rep.mover_deaths == 2
    assert camp.stats.outage_rejections > 0


def test_mover_deaths_cost_chunks_not_the_transfer(pkg, payload):
    sc = pkg.SCENARIOS["kill_2_movers"]
    rep, dst, camp = run_campaign(pkg, payload, sc, seed=1)
    assert bytes(dst.buf) == payload
    assert rep.mover_deaths == 2 == camp.stats.mover_kills


def test_all_movers_die_pool_respawns(pkg, payload):
    rep, dst, camp = run_campaign(pkg, payload, pkg.SCENARIOS["kill_all_movers"], seed=2,
                                  movers=4)
    assert bytes(dst.buf) == payload
    assert rep.mover_deaths == 4          # every original mover was killed once


def test_mover_death_budget_fails_the_transfer(pkg, payload):
    plan = make_plan(pkg, len(payload))

    def always_crash(chunk, attempt):
        raise pkg.MoverCrash("flaky pool")

    with pytest.raises(RuntimeError, match="mover-death budget"):
        pkg.ChunkedTransfer(pkg.BufferSource(payload), pkg.BufferDest(len(payload)), plan,
                        fault_injector=always_crash, max_mover_deaths=3).run()


def test_outage_survived_without_consuming_chunk_retries(pkg, payload):
    # max_retries=0: any generic failure would abort, so surviving the outage
    # proves the outage budget is separate from the chunk retry budget
    sc = pkg.SCENARIOS["outage_at_50pct"]
    rep, dst, camp = run_campaign(pkg, payload, sc, seed=3, max_retries=0)
    assert bytes(dst.buf) == payload
    assert camp.stats.outage_rejections == sc.outage_ops
    assert rep.outage_retries == sc.outage_ops
    assert rep.retries == 0               # generic budget untouched


def test_outage_budget_exhaustion_raises(pkg, payload):
    plan = make_plan(pkg, len(payload))

    def always_down(chunk, attempt):
        raise pkg.EndpointOutage("endpoint gone for good")

    with pytest.raises(pkg.EndpointOutage):
        pkg.ChunkedTransfer(pkg.BufferSource(payload), pkg.BufferDest(len(payload)), plan,
                        fault_injector=always_down,
                        outage_retries=2, outage_backoff_s=0.0).run()


def test_compound_campaign_full_recovery(pkg, payload):
    sc = pkg.parse_scenario("corrupt_1_per_TiB+kill_2_movers+outage_at_50pct")
    sc = sc.scaled_to(len(payload), target_events=5)
    for seed in range(3):
        rep, dst, camp = run_campaign(pkg, payload, sc, seed=seed)
        assert bytes(dst.buf) == payload, seed
        assert rep.refetches == camp.stats.corrupt_writes
        assert rep.mover_deaths == 2
        assert camp.stats.outage_rejections > 0


def test_full_matrix_parses_and_runs_one_seed(pkg, payload):
    for expr in pkg.FULL_MATRIX:
        sc = pkg.parse_scenario(expr).scaled_to(len(payload), target_events=3)
        rep, dst, camp = run_campaign(pkg, payload, sc.replace(torn_journal=False), seed=0)
        assert bytes(dst.buf) == payload, expr


def _svc_files(tmp_path, n=2, nbytes=200_000, seed=0):
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        p = os.path.join(str(tmp_path), f"f{i}.bin")
        with open(p, "wb") as fh:
            fh.write(rng.integers(0, 256, nbytes + i, dtype=np.uint8).tobytes())
        items.append((p, p + ".out"))
    return items


def _svc_config(pkg, **kw):
    defaults = dict(mover_budget=4, max_concurrent_tasks=2, chunk_bytes=32 * 1024,
                    tick_s=0.002, retry_backoff_s=0.001,
                    batch=pkg.BatchConfig(direct_bytes=1 << 30, batch_files=64))
    defaults.update(kw)
    return pkg.ServiceConfig(**defaults)


def test_service_corruption_faults_propagate_and_heal(pkg, tmp_path):
    items = _svc_files(tmp_path)
    sizes = [os.path.getsize(p) for p, _ in items]
    total = sum(sizes)
    sc = pkg.SCENARIOS["corrupt_1_per_TiB"].scaled_to(total, target_events=4)
    camp = pkg.FaultCampaign(sc, total_bytes=total, seed=0, movers=4, item_bytes=sizes)
    events = []
    svc = pkg.TransferService(tmp_path / "svc", _svc_config(pkg),
                          source_wrapper=camp.service_source_wrapper,
                          dest_wrapper=camp.service_dest_wrapper)
    svc.subscribe(lambda e: e.kind == "FAULT" and events.append(e))
    try:
        [tid] = svc.submit(items, batch=False)
        st = svc.wait(tid, timeout=60)
        assert st.state == "SUCCEEDED"
        for src, dst in items:
            assert open(src, "rb").read() == open(dst, "rb").read()
        assert st.refetches == camp.stats.corrupt_writes > 0
        corr = [e for e in events if e.payload.get("fault") == "corruption"]
        assert len(corr) == st.refetches
        assert all(not e.payload["fatal"] for e in corr)
    finally:
        svc.close()


def test_service_multi_item_corruption_spans_all_items(pkg, tmp_path):
    """With per-item offset bases, a planned corruption beyond the first
    item's size must land (and be healed) in a later item — the whole
    workload is reachable, not just [0, item0_size)."""
    items = _svc_files(tmp_path, n=3, nbytes=120_000, seed=9)
    sizes = [os.path.getsize(p) for p, _ in items]
    total = sum(sizes)
    # every planned offset beyond item 0: bytes_per_error chosen so draws
    # spread across the whole range; assert at least one lands past item 0
    sc = pkg.SCENARIOS["corrupt_1_per_TiB"].scaled_to(total, target_events=12)
    camp = pkg.FaultCampaign(sc, total_bytes=total, seed=5, movers=4, item_bytes=sizes)
    assert any(p >= sizes[0] for p in camp._corrupt), "seed draws all in item 0"
    svc = pkg.TransferService(tmp_path / "svc", _svc_config(pkg),
                          dest_wrapper=camp.service_dest_wrapper)
    try:
        [tid] = svc.submit(items, batch=False)
        st = svc.wait(tid, timeout=60)
        assert st.state == "SUCCEEDED"
        assert camp.stats.corruptions_injected == camp.planned_corruptions
        assert st.refetches == camp.stats.corrupt_writes > 0
        for src, dst in items:
            assert open(src, "rb").read() == open(dst, "rb").read()
    finally:
        svc.close()


def test_service_pipelined_corruption_heals_and_surfaces_lag(pkg, tmp_path):
    """Pipelined service data plane: deferred verification catches every
    corrupt landing (FAULT events carry deferred=True), the task still
    succeeds byte-exact, and checksum lag is surfaced in TaskStatus."""
    items = _svc_files(tmp_path, seed=11)
    sizes = [os.path.getsize(p) for p, _ in items]
    total = sum(sizes)
    sc = pkg.SCENARIOS["corrupt_1_per_TiB"].scaled_to(total, target_events=4)
    camp = pkg.FaultCampaign(sc, total_bytes=total, seed=3, movers=4, item_bytes=sizes)
    events = []
    svc = pkg.TransferService(tmp_path / "svc", _svc_config(pkg, pipeline="pipelined"),
                          dest_wrapper=camp.service_dest_wrapper)
    svc.subscribe(lambda e: e.kind == "FAULT" and events.append(e))
    try:
        [tid] = svc.submit(items, batch=False)
        st = svc.wait(tid, timeout=60)
        assert st.state == "SUCCEEDED"
        for src, dst in items:
            assert open(src, "rb").read() == open(dst, "rb").read()
        assert st.pipeline == "pipelined"
        assert st.refetches == camp.stats.corrupt_writes > 0
        assert st.cksum_lag_s > 0.0        # verification ran off the movers
        corr = [e for e in events if e.payload.get("fault") == "corruption"]
        assert len(corr) == st.refetches
        assert all(e.payload.get("deferred") for e in corr)
        assert all(not e.payload["fatal"] for e in corr)
    finally:
        svc.close()


def test_service_pipelined_kill_restart_removes_only_unverified(pkg, tmp_path):
    """Service kill with deferred verification in flight: the journal holds
    only verified chunks; the restarted service re-moves the rest and never
    a journaled one (the pipelined custody rule, service flavoured)."""
    items = _svc_files(tmp_path, n=1, nbytes=400_000, seed=12)

    cfg = _svc_config(pkg, pipeline="pipelined", integrity_workers=1,
                      chunk_bytes=16 * 1024)
    before = set(threading.enumerate())
    svc = pkg.TransferService(tmp_path / "svc", cfg,
                          dest_wrapper=lambda _t, _i, d: pkg.SlowReadBackWrapper(d, 0.02))
    [tid] = svc.submit(items, batch=False)
    # wait until some chunks are journaled, then kill mid-verification
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        st = svc.status(tid)
        if st.chunks_done >= 3:
            break
        time.sleep(0.005)
    svc.kill()

    # kill() abandons the verifier threads mid-flight (as SIGKILL would leave
    # in-flight appends); they end once their queue drains, so join every
    # thread the service started before reading the journal: a verdict
    # appended after the read would be resumed but not counted
    for th in set(threading.enumerate()) - before:
        th.join(timeout=60)
        assert not th.is_alive(), f"{th.name} still running after the kill"
    j = svc.store.open_journal(tid)
    journaled = {g: (r.offset, r.length) for g, r in j.records.items()}
    j.close()
    assert journaled                          # something was verified
    st = svc.status(tid)
    assert 0 < len(journaled) <= st.chunks_total

    moved = []
    svc2 = pkg.TransferService(
        tmp_path / "svc", cfg,
        fault_injector=lambda _t, _i, chunk, _a: moved.append(
            (chunk.offset, chunk.length)),
    )
    try:
        st2 = svc2.wait(tid, timeout=60)
        assert st2.state == "SUCCEEDED"
        assert st2.resumed_chunks == len(journaled)
        re_moved = [m for m in set(moved)
                    if any(m[0] < jo + jl and jo < m[0] + m[1]
                           for jo, jl in journaled.values())]
        assert re_moved == []
        src, dst = items[0]
        assert open(src, "rb").read() == open(dst, "rb").read()
    finally:
        svc2.close()


def test_service_mover_deaths_requeue_chunks(pkg, tmp_path):
    items = _svc_files(tmp_path, seed=1)
    total = sum(os.path.getsize(p) for p, _ in items)
    camp = pkg.FaultCampaign(pkg.SCENARIOS["kill_2_movers"], total_bytes=total, seed=1, movers=4)
    events = []
    svc = pkg.TransferService(tmp_path / "svc", _svc_config(pkg),
                          dest_wrapper=camp.service_dest_wrapper)
    svc.subscribe(lambda e: e.kind == "FAULT" and events.append(e))
    try:
        [tid] = svc.submit(items, batch=False)
        st = svc.wait(tid, timeout=60)
        assert st.state == "SUCCEEDED"
        assert st.mover_deaths == 2
        assert sum(1 for e in events if e.payload.get("fault") == "mover_death") == 2
        for src, dst in items:
            assert open(src, "rb").read() == open(dst, "rb").read()
    finally:
        svc.close()


def test_service_outage_survived(pkg, tmp_path):
    items = _svc_files(tmp_path, seed=2)
    total = sum(os.path.getsize(p) for p, _ in items)
    camp = pkg.FaultCampaign(pkg.SCENARIOS["outage_at_50pct"], total_bytes=total, seed=2, movers=4)
    svc = pkg.TransferService(tmp_path / "svc", _svc_config(pkg),
                          source_wrapper=camp.service_source_wrapper,
                          dest_wrapper=camp.service_dest_wrapper)
    try:
        [tid] = svc.submit(items, batch=False)
        st = svc.wait(tid, timeout=60)
        assert st.state == "SUCCEEDED"
        assert st.outages == camp.stats.outage_rejections > 0
    finally:
        svc.close()


def test_service_failed_task_carries_structured_fault_report(pkg, tmp_path):
    items = _svc_files(tmp_path, n=1, seed=3)

    def sticky_corrupt(task_id, item_idx, dst):
        class Sticky:
            def write(self, offset, data):
                if offset == 0:
                    data = bytes([data[0] ^ 0x80]) + data[1:]
                dst.write(offset, data)
            def read_back(self, offset, length):
                return dst.read_back(offset, length)
        return Sticky()

    failed_events = []
    svc = pkg.TransferService(tmp_path / "svc", _svc_config(pkg, max_refetches=1),
                          dest_wrapper=sticky_corrupt)
    svc.subscribe(lambda e: e.kind == "FAILED" and failed_events.append(e))
    try:
        [tid] = svc.submit(items, batch=False)
        st = svc.wait(tid, timeout=60)
        assert st.state == "FAILED"
        assert st.fault is not None
        assert st.fault.kind == "corruption"
        assert st.fault.chunk == 0 and st.fault.offset == 0
        assert st.fault.refetches >= 2        # budget spent before giving up
        [ev] = failed_events
        assert ev.payload["fault"]["kind"] == "corruption"
    finally:
        svc.close()


def test_service_mover_death_budget_fails_with_report(pkg, tmp_path):
    items = _svc_files(tmp_path, n=1, seed=4)

    def always_crash(task_id, item_idx, chunk, attempt):
        raise pkg.MoverCrash("pool on fire")

    svc = pkg.TransferService(tmp_path / "svc", _svc_config(pkg, max_mover_deaths=2),
                          fault_injector=always_crash)
    try:
        [tid] = svc.submit(items, batch=False)
        st = svc.wait(tid, timeout=60)
        assert st.state == "FAILED"
        assert st.fault is not None and st.fault.kind == "mover_death"
        # budget 2 + the fatal third; concurrent movers may crash past the
        # budget before the task lands on FAILED, so >= not ==
        assert st.mover_deaths >= 3
    finally:
        svc.close()


def test_engine_dead_journal_fails_fast(pkg, payload, tmp_path):
    """A journal that can't accept appends (ENOSPC, pulled mount) must fail
    the transfer promptly — completions that can't be made durable are not
    completions — rather than churning through movers."""
    plan = make_plan(pkg, len(payload))
    j = pkg.ChunkJournal(tmp_path / "dead.journal")
    j.close()                                     # appends now raise
    with pytest.raises(RuntimeError, match="journal append failed"):
        pkg.ChunkedTransfer(pkg.BufferSource(payload), pkg.BufferDest(len(payload)), plan,
                        journal=j).run()


def test_service_dead_journal_fails_task_with_report(pkg, tmp_path):
    """Same contract at service level: the task lands on FAILED with a
    structured report instead of hanging ACTIVE forever."""
    items = _svc_files(tmp_path, n=1, seed=6)
    svc = pkg.TransferService(tmp_path / "svc", _svc_config(pkg))
    try:
        # sabotage journal opening: every append hits a closed file handle
        orig_open = svc.store.open_journal

        def dead_journal(task_id):
            j = orig_open(task_id)
            j._fh.close()
            return j

        svc.store.open_journal = dead_journal
        [tid] = svc.submit(items, batch=False)
        st = svc.wait(tid, timeout=30)
        assert st.state == "FAILED"
        assert "journal append failed" in (st.error or "")
        assert st.fault is not None and st.fault.kind == "io"
    finally:
        svc.close()


def _tb_work(pkg):
    GB = 10**9
    return [pkg.Submission(0.0, f"t{k % 2}", (20 * GB,)) for k in range(6)]


def _tb_run(pkg, scenario=None, seed=0):
    return pkg.run_load(_tb_work(pkg), policy="marginal", mover_budget=16, max_concurrent=4,
                    chunk_bytes=500 * 10**6,
                    batch=pkg.BatchConfig(direct_bytes=10**9, batch_files=8),
                    scenario=scenario, seed=seed)


def test_testbed_outage_stretches_makespan(pkg):
    clean = _tb_run(pkg)
    faulted = _tb_run(pkg, pkg.SCENARIOS["outage_at_50pct"])
    assert all(t.done_s is not None for t in faulted.tasks)
    assert faulted.makespan_s >= clean.makespan_s + 0.5 * pkg.SCENARIOS[
        "outage_at_50pct"].outage_s
    assert faulted.faults.outage_s == pkg.SCENARIOS["outage_at_50pct"].outage_s


def test_testbed_corruption_amplifies_moved_bytes(pkg):
    total = sum(sum(s.file_bytes) for s in _tb_work(pkg))
    sc = pkg.SCENARIOS["corrupt_1_per_TiB"].scaled_to(total, target_events=10)
    faulted = _tb_run(pkg, sc, seed=1)
    assert all(t.done_s is not None for t in faulted.tasks)
    assert faulted.faults.corruptions > 0
    assert faulted.retry_amplification > 1.0
    assert faulted.moved_bytes > faulted.goodput_bytes


def test_testbed_mover_kills_shrink_budget(pkg):
    clean = _tb_run(pkg)
    faulted = _tb_run(pkg, pkg.SCENARIOS["kill_2_movers"].replace(kill_movers=12), seed=2)
    assert all(t.done_s is not None for t in faulted.tasks)
    assert faulted.faults.mover_kills == 12
    assert faulted.makespan_s >= clean.makespan_s   # fewer movers, never faster


def test_testbed_clean_run_unchanged_by_scenario_plumbing(pkg):
    a, b = _tb_run(pkg), _tb_run(pkg, pkg.SCENARIOS["clean"])
    assert a.makespan_s == b.makespan_s
    assert b.retry_amplification == 1.0 and b.faults.corruptions == 0




# ---------------------------------------------------------------------------
# stale-index faults (tests/test_cas.py's fault legs), on both packages
# ---------------------------------------------------------------------------
def test_stale_index_scenario_dsl(pkg):
    sc = pkg.parse_scenario("stale_index")
    assert sc.stale_index == 2 and not sc.is_clean
    assert "stale_index" in pkg.SCENARIOS and "stale_index" in pkg.FULL_MATRIX
    combo = pkg.parse_scenario("stale_index+kill_2_movers")
    assert combo.stale_index == 2 and combo.kill_movers == 2


def test_corrupt_index_backing_deterministic(pkg, tmp_path):
    def build(tag):
        backing = tmp_path / f"{tag}.bin"
        data = np.random.default_rng(10).integers(0, 256, 8 * 64, dtype=np.uint8).tobytes()
        backing.write_bytes(data)
        idx = pkg.ChunkIndex(tmp_path / tag / "index.log")
        for i in range(8):
            idx.put(pkg.fingerprint_bytes(data[i * 64:(i + 1) * 64]).hexdigest(), 64,
                    str(backing), i * 64)
        return idx

    idx_a, idx_b = build("a"), build("b")
    stats = pkg.FaultStats()
    vics_a = pkg.corrupt_index_backing(idx_a, count=3, seed=5, stats=stats)
    vics_b = pkg.corrupt_index_backing(idx_b, count=3, seed=5)
    assert stats.stale_index_corruptions == 3
    assert [(e.digest_hex, e.offset) for e in vics_a] \
        == [(e.digest_hex, e.offset) for e in vics_b]       # seeded: same draw
    for v in vics_a:
        assert idx_a.verify_entry(v) is None                # genuinely poisoned
    untouched = [e for e in idx_a.entries()
                 if (e.digest_hex, e.offset)
                 not in {(v.digest_hex, v.offset) for v in vics_a}]
    assert untouched and all(
        idx_a.verify_entry(e) is not None for e in untouched)
    idx_a.close()
    idx_b.close()


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------
def _plan(ns, spec, total, seed):
    camp = ns.FaultCampaign(ns.parse_scenario(spec).scaled_to(total, target_events=6),
                            total_bytes=total, seed=seed, movers=4)
    return (camp.scenario.name, dataclasses.asdict(camp.scenario),
            camp.planned_corruptions, sorted(camp._corrupt.items()))


@pytest.mark.parametrize("seed", [0, 7])
def test_every_scenario_realises_the_same_plan(seed):
    ref, port = _ns("repro"), _ns("repro_torch")
    specs = list(ref.FULL_MATRIX) + list(ref.FABRIC_MATRIX)
    assert specs == list(port.FULL_MATRIX) + list(port.FABRIC_MATRIX)
    for spec in specs:
        assert _plan(port, spec, 3 << 20, seed) == _plan(ref, spec, 3 << 20, seed), spec


def _tb_report(ns, spec, seed):
    work = _tb_work(ns)
    total = sum(sum(s.file_bytes) for s in work)
    sc = ns.parse_scenario(spec).scaled_to(total, target_events=10)
    rep = ns.run_load(work, policy="marginal", mover_budget=16, max_concurrent=4,
                      chunk_bytes=500 * 10**6,
                      batch=ns.BatchConfig(direct_bytes=10**9, batch_files=8),
                      scenario=sc, seed=seed)
    return repr(rep)


def test_testbed_reports_equal_under_every_scenario():
    ref, port = _ns("repro"), _ns("repro_torch")
    for spec in ref.FULL_MATRIX:
        assert _tb_report(port, spec, 3) == _tb_report(ref, spec, 3), spec


# ---------------------------------------------------------------------------
# the port alone: a failing device digest is a task error
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pipeline", ["serial", "single_pass"])
def test_failing_device_digest_fails_the_task_not_the_chunk(tmp_path, monkeypatch,
                                                            pipeline):
    import repro_torch.service.service as port_service

    def launch_fails(data, device):
        raise RuntimeError("checksum_many_words kernel launch failed: "
                           "an illegal memory access was encountered (700)")

    monkeypatch.setattr(port_service, "fingerprint_on_device", launch_fails)
    monkeypatch.setattr("repro_torch.core.dataplane._digest_staged", launch_fails)
    port = _ns("repro_torch")
    items = _svc_files(tmp_path, n=1, seed=4)
    svc = port.TransferService(tmp_path / "svc", _svc_config(port, pipeline=pipeline,
                                                             max_retries=2))
    try:
        [tid] = svc.submit(items, batch=False)
        st = svc.wait(tid, timeout=60)
    finally:
        svc.close()
    assert st.state == "FAILED"
    assert st.refetches == 0                      # never taken for corruption
    assert st.fault is not None and st.fault.kind == "error"   # generic budget
    assert "illegal memory access" in st.fault.error
