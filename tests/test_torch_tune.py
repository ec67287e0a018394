"""The port's step-change harness (``tune/harness.py``) against the
reference, and the tuned paths it drives.

On both packages (``pkg`` is "repro" or "repro_torch"; the port's engines
run with ``device="cpu"``, the digest kernels' plain versions): the harness
tests of ``tests/test_tune.py`` — corruption re-fetches under a paced path
do not drive the chunk size down, a degraded relay hop shrinks its own
granule — and a tuned service task, whose controller reads the movers'
``cksum_seconds`` (in the port, the staging copies and the device digest).
Across packages: the deterministic loss model, the phase schedules of the
canonical step scenarios, and a stepped path's realisation of a fixed
sequence of reads, landings and read-backs are equal.

The reference is imported inside the tests (``_ns``), so the card's machine,
which has no JAX, can collect this file.
"""
import dataclasses
import functools
import importlib
import os
import pathlib
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import pytest

PKGS = ("repro", "repro_torch")
KiB, MiB = 1024, 1024 * 1024


@functools.lru_cache(maxsize=None)
def _ns(name: str) -> SimpleNamespace:
    """One package's tuning API under one set of names. The port's
    device-taking classes are bound to ``device="cpu"``."""
    def mod(m):
        return importlib.import_module(f"{name}.{m}")

    core, tune, harness, svc = mod("core"), mod("tune"), mod("tune.harness"), mod("service")
    bound = dict(ChunkedTransfer=core.ChunkedTransfer,
                 RelayTransfer=mod("fabric.relay").RelayTransfer,
                 TransferService=svc.TransferService)
    if name == "repro_torch":
        bound = {k: functools.partial(v, device="cpu") for k, v in bound.items()}
    return SimpleNamespace(
        name=name, **bound,
        BufferDest=core.BufferDest, BufferSource=core.BufferSource,
        ChunkJournal=core.ChunkJournal, FileDest=core.FileDest,
        plan_chunks=core.plan_chunks,
        fingerprint_bytes=mod("core.integrity").fingerprint_bytes,
        verify=mod("core.integrity").verify,
        journal_paths=mod("fabric.relay").RelayTransfer.journal_paths,
        Route=mod("fabric").Route,
        FaultCampaign=mod("faults").FaultCampaign,
        parse_scenario=mod("faults").parse_scenario,
        ChunkController=tune.ChunkController, MD=tune.MD,
        Phase=harness.Phase, StepPath=harness.StepPath,
        StepScenario=harness.StepScenario, STEP_SCENARIOS=harness.STEP_SCENARIOS,
        precise_sleep=harness.precise_sleep,
        BatchConfig=svc.BatchConfig, ServiceConfig=svc.ServiceConfig,
    )


@pytest.fixture(params=PKGS)
def pkg(request):
    return _ns(request.param)


def _payload(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


@pytest.fixture
def fast_tmp():
    """tmpfs-backed scratch dir for timing-sensitive legs: on slow network
    filesystems file I/O jitter would swamp the paced rates the controller
    tests assert on."""
    base = "/dev/shm" if os.path.isdir("/dev/shm") else None
    with tempfile.TemporaryDirectory(prefix="tune-", dir=base) as d:
        yield pathlib.Path(d)


# ---------------------------------------------------------------------------
# the harness tests of tests/test_tune.py, on both packages
# ---------------------------------------------------------------------------
def test_corruption_refetches_do_not_drive_chunk_size_down(pkg, fast_tmp):
    """corrupt_1_per_TiB (scaled) injects read-back failures that each cost
    a re-fetch. The controller's rate signal excludes that recovery time,
    so the chunk size must stay put — no MD, no collapse to the floor."""
    tmp_path = fast_tmp
    payload = _payload(7, 2 * MiB)
    scenario = pkg.parse_scenario("corrupt_1_per_TiB").scaled_to(
        len(payload), target_events=6.0)
    camp = pkg.FaultCampaign(scenario, total_bytes=len(payload), seed=11)
    plan = pkg.plan_chunks(len(payload), 2, chunk_bytes=128 * KiB,
                           min_chunk=1, max_chunk=1 << 50)
    pace = pkg.StepPath(pkg.StepScenario("steady", (pkg.Phase(0.0, per_op_s=1e-2),)),
                        len(payload))
    ctrl = pkg.ChunkController(chunk_bytes=128 * KiB, min_chunk=16 * KiB,
                               max_chunk=512 * KiB, epoch_chunks=4,
                               degrade_threshold=0.5, hysteresis=0.25)
    dst = pkg.FileDest(tmp_path / "out", len(payload))
    journal = pkg.ChunkJournal(tmp_path / "j")
    rep = pkg.ChunkedTransfer(
        pace.wrap_source(camp.wrap_source(pkg.BufferSource(payload))),
        camp.wrap_dest(pace.wrap_dest(dst)),
        plan, journal=journal, tuner=ctrl,
    ).run()
    journal.close()
    assert camp.stats.corrupt_writes > 0, "campaign injected nothing"
    assert rep.refetches == camp.stats.corrupt_writes   # every hit healed
    with open(tmp_path / "out", "rb") as fh:
        assert fh.read() == payload                     # 0 escapes
    mds = [d for d in ctrl.decisions if d.action == pkg.MD]
    assert len(mds) <= 1, (
        f"corruption drove MDs: {[(d.action, d.chunk_bytes) for d in ctrl.decisions]}")
    assert ctrl.target() > ctrl.min_chunk, "chunk size driven to the floor"
    assert ctrl.probe.fault_refetches == rep.refetches


def test_relay_degraded_hop_shrinks_its_own_granule(pkg, fast_tmp):
    tmp_path = fast_tmp
    payload = _payload(9, 3 * MiB)
    route = pkg.Route(nodes=("a", "b", "c"), seconds=1.0)
    # hop 1 (b->c) is lossy + slow; hop 0 is clean and steadily paced. Plain
    # time.sleep (no deadline spin): the lossy hop's pacing must not steal
    # the GIL from the clean hop.
    lossy = pkg.StepPath(pkg.StepScenario("hop1", (
        pkg.Phase(0.0, per_op_s=5e-3, per_byte_s=1e-8, error_per_byte=2.5e-5),
    )), len(payload), sleep=time.sleep)
    steady = pkg.StepPath(pkg.StepScenario("hop0", (pkg.Phase(0.0, per_op_s=1e-2),)),
                          len(payload), sleep=time.sleep)

    def wrap_s(h, s):
        return lossy.wrap_source(s) if h == 1 else steady.wrap_source(s)

    dst = pkg.BufferDest(len(payload))
    rt = pkg.RelayTransfer(
        route, pkg.BufferSource(payload), dst,
        workdir=str(tmp_path / "relay"), chunk_bytes=128 * KiB, movers=1,
        tuning=True, granule_min=8 * KiB, max_retries=200,
        retry_backoff_s=0.0, source_wrapper=wrap_s, tune_hops={1},
    )
    assert rt.hops[0].controller is None
    assert rt.hops[1].controller is not None
    rep = rt.run()
    assert bytes(dst.buf) == payload
    assert pkg.verify(rep.file_digest, pkg.fingerprint_bytes(payload))
    h0, h1 = rep.hops
    assert h1.granule_replans >= 1
    assert h1.granule_bytes < 128 * KiB
    assert h0.granule_replans == 0
    assert h0.granule_bytes == 0           # whole-chunk moves throughout
    for h, jp in enumerate(pkg.journal_paths(tmp_path / "relay", route)):
        probe = pkg.ChunkJournal(jp)
        assert len(probe.records) == rep.n_chunks, f"hop {h} custody incomplete"
        probe.close()


def test_service_tuned_task_succeeds_with_tune_events(pkg, tmp_path):
    rng = np.random.default_rng(5)
    items = []
    for i in range(2):
        p = str(tmp_path / f"f{i}.bin")
        with open(p, "wb") as fh:
            fh.write(rng.integers(0, 256, 300_000 + i, dtype=np.uint8).tobytes())
        items.append((p, p + ".out"))
    svc = pkg.TransferService(str(tmp_path / "svc"), pkg.ServiceConfig(
        mover_budget=4, max_concurrent_tasks=2, chunk_bytes=32 * KiB,
        tick_s=0.002, retry_backoff_s=0.001,
        batch=pkg.BatchConfig(direct_bytes=1 << 30, batch_files=64),
        tune_min_chunk=8 * KiB, tune_max_chunk=128 * KiB, tune_seed="sim"))
    events = []
    svc.subscribe(lambda e: events.append(e))
    try:
        [tid] = svc.submit(items, batch=False, tuning="auto")
        st = svc.wait(tid, timeout=60)
        assert st.state == "SUCCEEDED"
        assert st.tuning == "auto"
        assert st.replans >= 1
        assert st.chunk_bytes_current is not None
        assert [e for e in events if e.kind == "TUNE"]
        for src, dst in items:
            with open(src, "rb") as a, open(dst, "rb") as b:
                assert a.read() == b.read()
        for (src, _dst), rep in zip(items, st.item_reports):
            with open(src, "rb") as fh:
                assert rep.digest_hex == pkg.fingerprint_bytes(fh.read()).hexdigest()
    finally:
        svc.close()


def test_step_scenario_validation(pkg):
    with pytest.raises(ValueError):
        pkg.StepScenario("empty", ())
    with pytest.raises(ValueError):
        pkg.StepScenario("late", (pkg.Phase(0.2),))
    with pytest.raises(ValueError):
        pkg.StepScenario("unsorted", (pkg.Phase(0.0), pkg.Phase(0.6), pkg.Phase(0.3)))
    sc = pkg.STEP_SCENARIOS["loss_spike"]()
    assert sc.phase_at(0.0) is sc.phases[0]
    assert sc.phase_at(0.5) is sc.phases[1]
    assert sc.phase_at(0.99) is sc.phases[2]


def test_precise_sleep_is_never_short(pkg):
    for dt in (0.0, 2e-4, 3e-3):
        t0 = time.perf_counter()
        pkg.precise_sleep(dt)
        assert time.perf_counter() - t0 >= dt


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------
def test_loss_model_and_step_scenarios_equal_across_packages():
    ref, port = _ns("repro"), _ns("repro_torch")
    for q in (0.0, 1e-6, 7e-6, 2.5e-5, 1e-3):
        for n in (0, 1, 8 * KiB, 128 * KiB, 4 * MiB):
            assert (port.Phase(error_per_byte=q).attempts_needed(n)
                    == ref.Phase(error_per_byte=q).attempts_needed(n))
    assert list(port.STEP_SCENARIOS) == list(ref.STEP_SCENARIOS)
    for name in ref.STEP_SCENARIOS:
        for kw in ({}, {"scale": 0.25}):
            a, b = ref.STEP_SCENARIOS[name](**kw), port.STEP_SCENARIOS[name](**kw)
            assert a.name == b.name
            assert [dataclasses.asdict(p) for p in a.phases] \
                == [dataclasses.asdict(p) for p in b.phases]


def _walk(ns, name):
    """A fixed sequence of reads (with retries on injected loss), landings
    and read-backs through one stepped path; returns what it realised."""
    slept = []
    total = 2 * MiB
    path = ns.StepPath(ns.STEP_SCENARIOS[name](), total, sleep=slept.append)
    payload = _payload(3, total)
    src = path.wrap_source(ns.BufferSource(payload))
    dst = path.wrap_dest(ns.BufferDest(total))
    tries = []
    for off in range(0, total, 128 * KiB):
        n = 1
        while True:
            try:
                data = src.read(off, 128 * KiB)
                break
            except IOError:
                n += 1
        tries.append(n)
        dst.write(off, data)
        assert dst.read_back(off, 128 * KiB) == payload[off:off + 128 * KiB]
    return tries, path.failed_reads, path.phase_changes, slept


@pytest.mark.parametrize("name", ["link_degrade_50pct", "cksum_starvation", "loss_spike"])
def test_stepped_path_realisation_equal_across_packages(name):
    assert _walk(_ns("repro_torch"), name) == _walk(_ns("repro"), name)
