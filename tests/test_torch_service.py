"""The port's transfer service and checkpoint bridge, against the reference.

Every lifecycle, crash-restart, fairness, store and event test of
``tests/test_service.py`` runs here on both packages (``pkg`` is "repro" or
"repro_torch"; the port's service runs with ``device="cpu"``, its
kernels' plain versions). Then the checks across packages, on the same
seeded inputs:

  * the same submission — serial, and pipelined with fused, single-job and
    oversize verifies — lands equal destination bytes, equal item digests
    and equal chunk lists;
  * a service root one package wrote and was killed mid-flight is resumed
    by the other package's service without re-moving a journaled chunk;
  * the port's bridge writes the reference bridge's MANIFEST and leaf files
    for the same state (the leaves converted by ``convert.state_to_reference``),
    and a delta save by the port against a full save by the reference moves
    the same chunks as the reference's own delta save.

The reference is imported inside the tests (``_ns``), so the card's machine,
which has no JAX, can collect this file; the tests marked ``gpu`` run there.
"""
import functools
import importlib
import json
import os
import pathlib
import random
import shutil
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.ckpt import restore_checkpoint as port_restore
from repro_torch.convert import state_to_reference
from repro_torch.service import ServiceConfig, TransferService, submit_checkpoint

PKGS = ("repro", "repro_torch")
CHUNK = 32 * 1024
KiB, MiB = 1024, 1024 * 1024


@functools.lru_cache(maxsize=None)
def _ns(name: str) -> SimpleNamespace:
    """One package's service API under one set of names. The port's
    ``TransferService`` is bound to ``device="cpu"``."""
    svc = importlib.import_module(f"{name}.service")
    svc_cls = svc.TransferService
    if name == "repro_torch":
        svc_cls = functools.partial(svc.TransferService, device="cpu")
    return SimpleNamespace(
        name=name,
        TransferService=svc_cls,
        ServiceConfig=svc.ServiceConfig,
        BatchConfig=svc.BatchConfig,
        Batcher=svc.Batcher,
        TenantQuota=svc.TenantQuota,
        TransferItem=svc.TransferItem,
        ActivationIndex=svc.ActivationIndex,
        EventBus=svc.EventBus,
        TaskSpec=svc.TaskSpec,
        submit_checkpoint=svc.submit_checkpoint,
        select_activations=importlib.import_module(
            f"{name}.service.scheduler").select_activations,
        store=importlib.import_module(f"{name}.service.store"),
        can_transition=importlib.import_module(f"{name}.service.task").can_transition,
        checked_line=importlib.import_module(f"{name}.core.journal").checked_line,
        fingerprint_bytes=importlib.import_module(
            f"{name}.core.integrity").fingerprint_bytes,
    )


@pytest.fixture(params=PKGS)
def pkg(request):
    return _ns(request.param)


def make_files(dirpath, n, nbytes, seed=0, prefix="f"):
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        p = os.path.join(str(dirpath), f"{prefix}{i}.bin")
        with open(p, "wb") as fh:
            fh.write(rng.integers(0, 256, nbytes + i, dtype=np.uint8).tobytes())
        items.append((p, p + ".out"))
    return items


def svc_config(pkg, **kw):
    defaults = dict(
        mover_budget=4, max_concurrent_tasks=2, chunk_bytes=CHUNK,
        tick_s=0.002, retry_backoff_s=0.001,
        batch=pkg.BatchConfig(direct_bytes=1 << 30, batch_files=64),
    )
    defaults.update(kw)
    return pkg.ServiceConfig(**defaults)


def wait_progress(svc, tid, n, timeout=20.0):
    t0 = time.monotonic()
    while svc.status(tid).chunks_done < n:
        time.sleep(0.002)
        assert time.monotonic() - t0 < timeout, "no progress"


def read(path) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


# ---------------------------------------------------------------------------
# state machine + batching units
# ---------------------------------------------------------------------------
def test_state_machine_rules(pkg):
    can_transition = pkg.can_transition
    assert can_transition("PENDING", "ACTIVE")
    assert can_transition("ACTIVE", "PAUSED")
    assert can_transition("PAUSED", "PENDING")
    assert not can_transition("SUCCEEDED", "ACTIVE")
    assert not can_transition("CANCELED", "PENDING")
    assert not can_transition("PENDING", "SUCCEEDED")   # must go through ACTIVE


def test_batcher_coalesces_small_and_routes_large(pkg):
    cfg = pkg.BatchConfig(direct_bytes=MiB, batch_files=3, batch_bytes=10 * MiB)
    b = pkg.Batcher(cfg)
    items = [pkg.TransferItem(f"s{i}", f"d{i}", 1000) for i in range(7)]
    items.insert(2, pkg.TransferItem("big", "bigd", 2 * MiB))
    groups = b.split(items)
    sizes = sorted(len(g) for g in groups)
    assert sizes == [1, 1, 3, 3]                 # big alone; 7 small -> 3+3+1
    assert any(g[0].src == "big" and len(g) == 1 for g in groups)
    ready = b.add("t", [pkg.TransferItem(f"x{i}", f"y{i}", 10) for i in range(4)])
    assert len(ready) == 1 and len(ready[0]) == 3
    assert b.staged_count("t") == 1
    rest = b.flush("t")
    assert len(rest) == 1 and len(rest[0]) == 1 and b.staged_count("t") == 0


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------
def test_submit_to_complete(pkg, tmp_path):
    items = make_files(tmp_path, 4, 100_000)
    svc = pkg.TransferService(tmp_path / "svc", svc_config(pkg))
    kinds = []
    svc.subscribe(lambda e: kinds.append(e.kind))
    try:
        [tid] = svc.submit(items, tenant="alice", batch=False)
        st = svc.wait(tid, timeout=30)
        assert st.state == "SUCCEEDED"
        assert st.chunks_done == st.chunks_total > 0
        assert st.bytes_done == st.bytes_total == sum(os.path.getsize(p) for p, _ in items)
        for src, dst in items:
            assert read(src) == read(dst)
        for rep, (src, _dst) in zip(st.item_reports, items):
            assert rep.digest_hex == pkg.fingerprint_bytes(read(src)).hexdigest()
        if pkg.name == "repro":
            # the reference's wait() may return before its terminal event
            # has gone out (pinned by test_wait_does_not_return_before_the_event)
            t0 = time.monotonic()
            while "SUCCEEDED" not in kinds and time.monotonic() - t0 < 5:
                time.sleep(0.005)
        assert "SUBMITTED" in kinds and "ACTIVATED" in kinds and "SUCCEEDED" in kinds
    finally:
        svc.close()


def test_wait_does_not_return_before_the_event(pkg, tmp_path):
    """A notify from another thread between ``_finish``'s transition and
    its emit must not let ``wait()`` return ahead of the SUCCEEDED event.
    The port settles the task only after the emit; the reference returns
    early (a fault of the reference, pinned here)."""
    items = make_files(tmp_path, 4, 100_000)
    svc = pkg.TransferService(tmp_path / "svc", svc_config(pkg))
    kinds = []
    svc.subscribe(lambda e: kinds.append(e.kind))
    emit = svc.events.emit

    def slow_succeeded(kind, *args, **kw):
        if kind == "SUCCEEDED":
            with svc._cond:
                svc._cond.notify_all()
            time.sleep(0.3)
        return emit(kind, *args, **kw)
    svc.events.emit = slow_succeeded
    try:
        [tid] = svc.submit(items, tenant="alice", batch=False)
        st = svc.wait(tid, timeout=30)
        assert st.state == "SUCCEEDED"
        if pkg.name == "repro_torch":
            assert "SUCCEEDED" in kinds
        else:
            assert "SUCCEEDED" not in kinds
    finally:
        svc.close()


def test_cancel_mid_flight(pkg, tmp_path):
    items = make_files(tmp_path, 1, 2_000_000)
    slow = lambda task_id, item, chunk, attempt: time.sleep(0.01)  # noqa: E731
    svc = pkg.TransferService(tmp_path / "svc", svc_config(pkg), fault_injector=slow)
    try:
        [tid] = svc.submit(items, batch=False)
        wait_progress(svc, tid, 3)
        svc.cancel(tid)
        st = svc.wait(tid, timeout=30)
        assert st.state == "CANCELED"
        assert 0 < st.chunks_done < st.chunks_total
    finally:
        svc.close()


def test_pause_resume_no_rework(pkg, tmp_path):
    items = make_files(tmp_path, 1, 1_500_000)
    moves = []

    def inject(task_id, item, chunk, attempt):
        moves.append(chunk.offset)
        time.sleep(0.005)
    svc = pkg.TransferService(tmp_path / "svc", svc_config(pkg), fault_injector=inject)
    try:
        [tid] = svc.submit(items, batch=False)
        wait_progress(svc, tid, 4)
        svc.pause(tid)
        t0 = time.monotonic()
        while svc.status(tid).state != "PAUSED":
            time.sleep(0.002)
            assert time.monotonic() - t0 < 20
        frozen = svc.status(tid).chunks_done
        time.sleep(0.05)
        assert svc.status(tid).chunks_done == frozen    # truly paused
        svc.resume(tid)
        st = svc.wait(tid, timeout=30)
        assert st.state == "SUCCEEDED"
        assert st.resumed_chunks >= frozen              # journal carried over
        assert len(moves) == len(set(moves)) == st.chunks_total
        src, dst = items[0]
        assert read(src) == read(dst)
    finally:
        svc.close()


def test_resume_during_pause_drain_not_stranded(pkg, tmp_path):
    items = make_files(tmp_path, 1, 1_000_000)
    slow = lambda task_id, item, chunk, attempt: time.sleep(0.01)  # noqa: E731
    svc = pkg.TransferService(tmp_path / "svc", svc_config(pkg), fault_injector=slow)
    try:
        [tid] = svc.submit(items, batch=False)
        wait_progress(svc, tid, 2)
        svc.pause(tid)
        svc.resume(tid)
        st = svc.wait(tid, timeout=30)
        assert st.state == "SUCCEEDED"
        src, dst = items[0]
        assert read(src) == read(dst)
    finally:
        svc.close()


def test_retry_with_backoff_then_success(pkg, tmp_path):
    items = make_files(tmp_path, 1, 300_000)
    failed = set()

    def flaky(task_id, item, chunk, attempt):
        if chunk.index in (1, 3) and attempt == 1:
            failed.add(chunk.index)
            raise IOError("transient")
    svc = pkg.TransferService(tmp_path / "svc", svc_config(pkg), fault_injector=flaky)
    retries = []
    svc.subscribe(lambda e: e.kind == "RETRY" and retries.append(e))
    try:
        [tid] = svc.submit(items, batch=False)
        st = svc.wait(tid, timeout=30)
        assert st.state == "SUCCEEDED"
        assert failed == {1, 3} and st.retries == 2 and len(retries) == 2
    finally:
        svc.close()


def test_exhausted_retries_fail_the_task(pkg, tmp_path):
    items = make_files(tmp_path, 1, 200_000)

    def dead(task_id, item, chunk, attempt):
        if chunk.index == 2:
            raise IOError("dead OST")
    svc = pkg.TransferService(tmp_path / "svc", svc_config(pkg, max_retries=1),
                              fault_injector=dead)
    try:
        [tid] = svc.submit(items, batch=False)
        st = svc.wait(tid, timeout=30)
        assert st.state == "FAILED"
        assert "dead OST" in (st.error or "")
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# crash + restart
# ---------------------------------------------------------------------------
def _crash_restart(first, second, tmp_path, **cfg_kw):
    """Kill ``first``'s service mid-flight; ``second``'s service resumes the
    same root. Returns what the second incarnation saw."""
    items = make_files(tmp_path, 2, 1_200_000)
    pace = lambda task_id, item, chunk, attempt: time.sleep(0.004)  # noqa: E731
    before = set(threading.enumerate())
    svc = first.TransferService(tmp_path / "svc", svc_config(first, **cfg_kw),
                                fault_injector=pace)
    tids = svc.submit(items, batch=False) + \
        svc.submit(make_files(tmp_path, 1, 400_000, prefix="g"), batch=False)
    wait_progress(svc, tids[0], 5)
    svc.kill()                                   # SIGKILL equivalent

    # kill() abandons threads mid-flight: a serial task's movers finish the
    # chunk they hold, and a pipelined task's verifiers (``integrity-*``)
    # drain their queue up to the sentinels that ``close(abandon=True)``
    # enqueues, each journaling what it vouches for, as in-flight appends of
    # a killed process would land. Read the journals once every thread the
    # killed service started has exited.
    deadline = time.monotonic() + 30
    for th in set(threading.enumerate()) - before:
        th.join(max(0.0, deadline - time.monotonic()))
        assert not th.is_alive(), f"{th.name} still running 30 s after kill()"

    def journals():
        out = {}
        for tid in tids:
            j = svc.store.open_journal(tid)
            out[tid] = len(j.records)
            j.close()
        return out

    journaled = journals()
    # a task that finished before the kill is replayed as SUCCEEDED, not resumed
    resumed_ids = [tid for tid in tids if svc.store.records[tid].state != "SUCCEEDED"]
    assert tids[0] in resumed_ids
    moves2 = []
    svc2 = second.TransferService(
        tmp_path / "svc", svc_config(second, **cfg_kw),
        fault_injector=lambda t, i, c, a: moves2.append((t, i, c.offset)),
    )
    try:
        stats = svc2.wait_all(tids, timeout=60)
        for st in stats:
            assert st.state == "SUCCEEDED", (st.task_id, st.error)
        resumed = [st for st in stats if st.task_id in resumed_ids]
        total_chunks = sum(st.chunks_total for st in resumed)
        total_resumed = sum(st.resumed_chunks for st in resumed)
        # every journaled chunk was skipped ...
        assert total_resumed == sum(journaled[tid] for tid in resumed_ids) > 0
        # ... and the restarted service moved ONLY the complement, once each
        assert svc2.moved_chunks == len(moves2) == total_chunks - total_resumed
        assert len(set(moves2)) == len(moves2)
        for src, dst in items:
            assert read(src) == read(dst)
        return stats
    finally:
        svc2.close()


def test_crash_restart_resumes_without_removing_chunks(pkg, tmp_path):
    _crash_restart(pkg, pkg, tmp_path)


@pytest.mark.parametrize("first,second", [("repro", "repro_torch"),
                                          ("repro_torch", "repro")])
@pytest.mark.parametrize("pipeline", ["serial", "pipelined"])
def test_crash_restart_across_packages(tmp_path, first, second, pipeline):
    """A root one package wrote and was killed in is replayed by the other
    (store shards, event log and chunk journals are byte-compatible)."""
    stats = _crash_restart(_ns(first), _ns(second), tmp_path, pipeline=pipeline)
    assert all(st.item_reports for st in stats)


def test_ephemeral_task_fails_on_restart(pkg, tmp_path):
    pace = lambda *a: time.sleep(0.01)  # noqa: E731
    cfg = svc_config(pkg)
    svc = pkg.TransferService(tmp_path / "svc", cfg, fault_injector=pace)
    payload = np.arange(200_000, dtype=np.uint8)
    tid = svc.submit_buffers([(payload, str(tmp_path / "mem.out"))])
    wait_progress(svc, tid, 1)
    svc.kill()
    svc2 = pkg.TransferService(tmp_path / "svc", cfg)
    try:
        st = svc2.wait(tid, timeout=10)
        assert st.state == "FAILED"
        assert "ephemeral" in st.error
    finally:
        svc2.close()


# ---------------------------------------------------------------------------
# multi-tenant fairness
# ---------------------------------------------------------------------------
def test_tenant_fairness_under_contention(pkg, tmp_path):
    pace = lambda task_id, item, chunk, attempt: time.sleep(0.003)  # noqa: E731
    svc = pkg.TransferService(
        tmp_path / "svc", svc_config(pkg, mover_budget=2, max_concurrent_tasks=1),
        fault_injector=pace,
    )
    order = []
    svc.subscribe(lambda e: e.kind == "ACTIVATED" and order.append(e.task_id))
    try:
        heavy = []
        for k in range(4):
            heavy += svc.submit(make_files(tmp_path, 1, 200_000, seed=k,
                                           prefix=f"a{k}-"), tenant="A", batch=False)
        light = svc.submit(make_files(tmp_path, 1, 200_000, seed=9, prefix="b-"),
                           tenant="B", batch=False)
        svc.wait_all(heavy + light, timeout=60)
        pos_b = order.index(light[0])
        assert pos_b <= 2, f"tenant B starved: activation order {order}"
    finally:
        svc.close()


def test_tenant_quota_max_active(pkg, tmp_path):
    pace = lambda task_id, item, chunk, attempt: time.sleep(0.003)  # noqa: E731
    svc = pkg.TransferService(
        tmp_path / "svc",
        svc_config(pkg, mover_budget=4, max_concurrent_tasks=3,
                   quotas={"A": pkg.TenantQuota(max_active=1)}),
        fault_injector=pace,
    )
    try:
        tids = []
        for k in range(3):
            tids += svc.submit(make_files(tmp_path, 1, 400_000, seed=k,
                                          prefix=f"q{k}-"), tenant="A", batch=False)
        seen_active = set()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            active = [s.task_id for s in svc.tasks() if s.state == "ACTIVE"]
            assert len(active) <= 1, f"quota violated: {active}"
            seen_active.update(active)
            if all(s.done for s in svc.tasks()):
                break
            time.sleep(0.002)
        stats = svc.wait_all(tids, timeout=60)
        assert all(s.state == "SUCCEEDED" for s in stats)
        assert seen_active == set(tids)
    finally:
        svc.close()


# ---------------------------------------------------------------------------
# the same submission through both services
# ---------------------------------------------------------------------------
def _run_submission(ns, root, items, **cfg_kw):
    svc = ns.TransferService(root, svc_config(ns, **cfg_kw))
    try:
        tids = svc.submit(items, tenant="alice")
        stats = svc.wait_all(tids, timeout=60)
        stats = [(st, svc.integrity_stats(st.task_id)
                  if hasattr(svc, "integrity_stats") else None) for st in stats]
    finally:
        svc.close()
    return stats


def _report_key(st):
    return [(r.src, r.nbytes, r.digest_hex, r.chunk_bytes,
             [(c["index"], c["offset"], c["length"], c["digest"]) for c in r.chunks])
            for r in st.item_reports]


@pytest.mark.parametrize("pipeline", ["serial", "single_pass", "pipelined"])
def test_same_submission_same_reports(tmp_path, pipeline):
    """Large files (chunked tasks, ragged tails) and small ones (batched):
    equal destination bytes, item digests and chunk lists in both packages."""
    big = make_files(tmp_path, 2, 300_000, seed=3, prefix="big")
    small = make_files(tmp_path, 6, 5_000, seed=4, prefix="small")
    out = {}
    for name in PKGS:
        items = [(s, f"{d}.{name}") for s, d in big + small]
        stats = _run_submission(
            _ns(name), tmp_path / f"svc-{name}", items, pipeline=pipeline,
            batch=_ns(name).BatchConfig(direct_bytes=100_000, batch_files=4))
        assert all(st.state == "SUCCEEDED" for st, _ in stats)
        for s, d in items:
            assert read(s) == read(d)
        out[name] = stats
    ref, port = out["repro"], out["repro_torch"]
    assert len(ref) == len(port) == 4                   # 2 direct + 2 batches
    for (rs, _), (ps, pstats) in zip(ref, port):
        assert _report_key(ps) == _report_key(rs)
        assert (ps.chunks_total, ps.bytes_total) == (rs.chunks_total, rs.bytes_total)
        if pipeline == "pipelined":
            assert pstats.verified == ps.chunks_total and pstats.per_job == 0
            assert pstats.fused_jobs + pstats.device_jobs == ps.chunks_total
        else:
            assert pstats is None


def test_pipelined_service_verifies_through_the_kernels(tmp_path):
    """The port's pipelined tasks verify in the kernels' plain versions
    (``device="cpu"``): tile-aligned chunks as fused rows or per-job on the
    device path, oversize chunks per job, nothing on the host path."""
    from repro_torch.kernels import checksum as tck

    nbytes = 24 * 64 * KiB                     # 24 tile-aligned 64 KiB chunks
    src = tmp_path / "data.bin"
    src.write_bytes(np.random.default_rng(5).bytes(nbytes))
    # fuse_max_bytes is 8 MiB: 64 KiB chunks fuse; a 9 MiB task is oversize
    big = tmp_path / "big.bin"
    big.write_bytes(np.random.default_rng(6).bytes(9 * MiB + 4096))
    tck.reset_launch_counts()
    svc = TransferService(tmp_path / "svc", ServiceConfig(
        pipeline="pipelined", integrity_workers=2, mover_budget=4,
        max_concurrent_tasks=2, tick_s=0.002), device="cpu")
    try:
        [small_t] = svc.submit([(str(src), str(src) + ".out")], chunk_bytes=64 * KiB)
        [big_t] = svc.submit([(str(big), str(big) + ".out")], chunk_bytes=9 * MiB + 4096)
        sts = svc.wait_all([small_t, big_t], timeout=120)
        small, bigs = svc.integrity_stats(small_t), svc.integrity_stats(big_t)
    finally:
        svc.close()
    assert [s.state for s in sts] == ["SUCCEEDED", "SUCCEEDED"]
    assert read(src) == read(str(src) + ".out") and read(big) == read(str(big) + ".out")
    assert small.verified == 24 and small.per_job == 0 and small.host_rows == 0
    assert small.device_rows == small.fused_jobs
    assert small.fused_jobs + small.device_jobs == 24
    assert bigs.device_jobs == 1 and bigs.per_job == 0 and bigs.fused_jobs == 0
    # the plain versions counted no launch: launches count the card's kernels
    assert tck.launch_counts() == {
        "checksum_words": 0, "checksum_many_words": 0, "checksum_copy_words": 0}


def test_service_flipped_landing_is_healed_on_the_device_path(tmp_path):
    """A bit flipped in one oversize chunk's first landing is caught by the
    per-job verify on the device path and healed by one re-fetch."""
    nbytes = 3 * (9 * MiB)
    src = tmp_path / "data.bin"
    payload = np.random.default_rng(7).bytes(nbytes)
    src.write_bytes(payload)
    flips = []

    class Flippy:
        """Flips the first byte of chunk 1 right after its first landing."""

        def __init__(self, inner):
            self._inner = inner

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def _flip(self, offset):
            if offset == 9 * MiB and not flips:
                flips.append(offset)
                byte = self._inner.read_back(offset, 1)
                self._inner.write(offset, bytes([byte[0] ^ 0x01]))

        def write(self, offset, data):
            self._inner.write(offset, data)
            self._flip(offset)

        def writev(self, offset, views):
            n = self._inner.writev(offset, views)
            self._flip(offset)
            return n

    svc = TransferService(tmp_path / "svc", ServiceConfig(
        pipeline="pipelined", integrity_workers=2, mover_budget=2,
        max_concurrent_tasks=1, tick_s=0.002), device="cpu",
        dest_wrapper=lambda tid, i, d: Flippy(d))
    try:
        [tid] = svc.submit([(str(src), str(src) + ".out")], chunk_bytes=9 * MiB)
        st = svc.wait(tid, timeout=120)
        stats = svc.integrity_stats(tid)
    finally:
        svc.close()
    assert flips == [9 * MiB]
    assert st.state == "SUCCEEDED" and st.refetches == 1
    assert read(str(src) + ".out") == payload
    assert stats.corrupt == 1 and stats.device_jobs == 4 and stats.per_job == 0


def test_service_without_a_card_refuses_to_start(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default service is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransferService(tmp_path / "svc")
    assert not (tmp_path / "svc").exists()          # refused before any write
    with pytest.raises(ValueError):
        TransferService(tmp_path / "svc", device="meta")


# ---------------------------------------------------------------------------
# checkpoint bridge
# ---------------------------------------------------------------------------
def _state(seed=3):
    gen = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn(128, 16, generator=gen),
        "nested": {"b": torch.randn(64, generator=gen).to(torch.bfloat16),
                   "step": torch.tensor(11, dtype=torch.int64)},
    }


def test_checkpoint_submitted_as_task_roundtrips(tmp_path):
    """The reference's bridge test on the port: a state dict saved through
    the service restores bit-equal with the port and with the reference."""
    state = _state()
    svc = TransferService(tmp_path / "svc", svc_config(_ns("repro_torch"), chunk_bytes=4096),
                          device="cpu")
    try:
        sub = submit_checkpoint(svc, tmp_path / "ckpt", 11, state)
        rep = sub.wait(timeout=60)
        assert rep.step == 11 and rep.n_leaves == 3
        restored, step = port_restore(rep.path, device="cpu")
        assert step == 11
        assert torch.equal(restored["w"], state["w"])
        assert torch.equal(restored["nested"]["b"], state["nested"]["b"])
        assert torch.equal(restored["nested"]["step"], state["nested"]["step"])
    finally:
        svc.close()
    from repro.ckpt import restore_checkpoint as ref_restore
    theirs, step = ref_restore(rep.path)
    want = state_to_reference(state)
    assert step == 11
    np.testing.assert_array_equal(theirs["w"], want["w"])
    assert theirs["nested"]["b"].tobytes() == want["nested"]["b"].tobytes()


@pytest.mark.parametrize("pipeline", ["serial", "pipelined"])
def test_bridge_manifest_equals_the_reference_bridge(tmp_path, pipeline):
    """Port bridge on a torch state dict, reference bridge on the same leaves
    as numpy arrays: equal MANIFEST.json bytes and leaf files."""
    gen = torch.Generator().manual_seed(9)
    state = {"layer0": {"w": torch.randn(300, 70, generator=gen),
                        "b": torch.randn(4099, generator=gen).to(torch.bfloat16)},
             "emb": torch.randn(513, 33, generator=gen).to(torch.bfloat16),
             "ints": torch.arange(51, dtype=torch.int32),
             "mask": torch.arange(23) % 2 == 0,
             "scalar": torch.tensor(7, dtype=torch.int32)}
    paths = {}
    for name, tree in (("repro_torch", state), ("repro", state_to_reference(state))):
        ns = _ns(name)
        svc = ns.TransferService(tmp_path / f"svc-{name}",
                                 svc_config(ns, chunk_bytes=8192, pipeline=pipeline))
        try:
            rep = ns.submit_checkpoint(svc, tmp_path / name, 2, tree).wait(60)
        finally:
            svc.close()
        paths[name] = pathlib.Path(rep.path)
    port, theirs = paths["repro_torch"], paths["repro"]
    a = (port / "MANIFEST.json").read_bytes()
    b = (theirs / "MANIFEST.json").read_bytes()
    assert a == b
    man = json.loads(a)
    assert man["leaves"]["layer0/b"]["dtype"] == "bfloat16"
    assert man["leaves"]["scalar"]["shape"] == []
    assert len(man["leaves"]["layer0/w"]["chunks"]) > 1
    for leaf in man["leaves"].values():
        assert (port / leaf["file"]).read_bytes() == (theirs / leaf["file"]).read_bytes()


def test_delta_save_against_a_reference_full_save(tmp_path):
    """Step 1 saved in full by the reference bridge; step 2 (one leaf's first
    rows changed, all in its first chunk) saved as a delta by the port into the same root, and by the
    reference into a copy: the same chunks move, the same ones dedup, and
    both MANIFESTs and leaf files are equal."""
    gen = torch.Generator().manual_seed(11)
    state = {"wi": torch.randn(64, 512, generator=gen),
             "wo": torch.randn(512, 64, generator=gen),
             "ln": torch.randn(2048, generator=gen)}
    ref = _ns("repro")
    svc = ref.TransferService(tmp_path / "svc-ref1", svc_config(ref, chunk_bytes=8192))
    try:
        ref.submit_checkpoint(svc, tmp_path / "a", 1, state_to_reference(state)).wait(60)
    finally:
        svc.close()
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    mutated = {k: v.clone() for k, v in state.items()}
    mutated["wi"][:4] += 1.0                 # 4 rows of 2 KiB: chunk 0 of 16
    out = {}
    for name, root, tree in (("repro_torch", tmp_path / "a", mutated),
                             ("repro", tmp_path / "b", state_to_reference(mutated))):
        ns = _ns(name)
        svc = ns.TransferService(tmp_path / f"svc-{name}2", svc_config(ns))
        try:
            sub = ns.submit_checkpoint(svc, root, 2, tree, delta=True)
            rep = sub.wait(60)
            out[name] = (sub.status(), pathlib.Path(rep.path))
        finally:
            svc.close()
    (pst, ppath), (rst, rpath) = out["repro_torch"], out["repro"]
    assert pst.chunks_total == rst.chunks_total == 16 + 16 + 1
    assert pst.chunks_deduped == rst.chunks_deduped == 16 + 16 + 1 - 1
    assert pst.wire_bytes_saved == rst.wire_bytes_saved

    def by_leaf(st):      # the reference orders leaves by key, the port as given
        return sorted((os.path.basename(r.dst), r.digest_hex, r.chunks)
                      for r in st.item_reports)
    assert by_leaf(pst) == by_leaf(rst)
    assert (ppath / "MANIFEST.json").read_bytes() == (rpath / "MANIFEST.json").read_bytes()
    got, _ = port_restore(ppath, device="cpu")
    for k, v in mutated.items():
        assert torch.equal(got[k], v), k


# ---------------------------------------------------------------------------
# control plane: sharded store, bulk APIs, ordered events
# ---------------------------------------------------------------------------
def _spec(pkg, task_id, tenant):
    return pkg.TaskSpec(task_id=task_id, tenant=tenant, label="",
                        items=(pkg.TransferItem("s", "d", 1),))


def _fresh(pkg, root, **kw):
    kw.setdefault("auto_compact", False)
    return pkg.store.TaskStore(root, **kw)


def _snapshot(store):
    return {tid: (r.seq, r.state, r.error, r.spec.to_json())
            for tid, r in store.records.items()}


def test_next_task_id_concurrent_mint_unique(pkg, tmp_path):
    store = _fresh(pkg, tmp_path / "s")
    ids, lock = [], threading.Lock()
    start = threading.Barrier(8)

    def mint():
        start.wait()
        mine = [store.next_task_id("t") for _ in range(200)]
        with lock:
            ids.extend(mine)

    ts = [threading.Thread(target=mint) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len(set(ids)) == len(ids) == 1600
    store.close()


def test_task_id_width_survives_the_million_task_target(pkg, tmp_path):
    store = _fresh(pkg, tmp_path / "s")
    store._next_id = 10**6 - 1
    a = store.next_task_id("t")
    b = store.next_task_id("t")
    assert a != b and a < b
    assert len(a.split("-")[1]) == len(b.split("-")[1]) == pkg.store.ID_WIDTH
    store.close()


def test_concurrent_submit_hammer_unique_ids_replay_stable_seqs(pkg, tmp_path):
    root = tmp_path / "s"
    store = _fresh(pkg, root, n_shards=4)
    start = threading.Barrier(8)

    def worker(wid):
        rng = random.Random(wid)
        start.wait()
        for i in range(60):
            tenant = f"t{rng.randrange(12)}"
            if i % 3 == 0:
                store.append_submit_many(
                    [_spec(pkg, store.next_task_id(tenant), tenant) for _ in range(3)])
            else:
                store.append_submit(_spec(pkg, store.next_task_id(tenant), tenant))

    ts = [threading.Thread(target=worker, args=(w,)) for w in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    n = 8 * (20 * 3 + 40)
    live = _snapshot(store)
    store.close()
    assert len(live) == n
    assert sorted(r[0] for r in live.values()) == list(range(n))
    replayed = _fresh(pkg, root, n_shards=4)
    assert _snapshot(replayed) == live
    replayed.close()


def test_shard_torn_tail_truncated_at_every_byte(pkg, tmp_path):
    ref = tmp_path / "ref"
    store = _fresh(pkg, ref, n_shards=4)
    tenants = ["a", "b", "c", "d", "e", "f"]
    for i, tn in enumerate(tenants):
        store.append_submit(_spec(pkg, f"task-{i:09d}-{tn}", tn))
    for i, tn in enumerate(tenants):
        store.append_state(f"task-{i:09d}-{tn}", "ACTIVE")
    expect = _snapshot(store)
    store.close()
    shards = [p for p in store.shard_paths() if os.path.getsize(p)]
    assert len(shards) > 1
    for shard in shards:
        raw = pathlib.Path(shard).read_bytes()
        lines = raw.splitlines(keepends=True)
        last_start = len(raw) - len(lines[-1])
        body = json.loads(lines[-1])["body"]
        assert body["type"] == "state"
        victim = body["task_id"]
        for cut in range(last_start + 1, len(raw)):
            work = tmp_path / f"cut{os.path.basename(shard)}-{cut}"
            shutil.copytree(ref, work)
            target = os.path.join(work, "tasks", os.path.basename(shard))
            with open(target, "r+b") as fh:
                fh.truncate(cut)
            st = _fresh(pkg, work, n_shards=4)
            want = dict(expect)
            want[victim] = (want[victim][0], "PENDING", None, want[victim][3])
            assert _snapshot(st) == want, (shard, cut)
            assert st.torn_tail_bytes == cut - last_start
            assert os.path.getsize(target) == last_start
            st.append_state(victim, "CANCELED")
            st.close()
            st2 = _fresh(pkg, work, n_shards=4)
            assert st2.records[victim].state == "CANCELED"
            assert st2.torn_tail_bytes == 0
            st2.close()
            shutil.rmtree(work)


def test_compaction_preserves_replayed_state_bit_for_bit(pkg, tmp_path):
    root = tmp_path / "s"
    store = _fresh(pkg, root, n_shards=4)
    rng = random.Random(7)
    for i in range(40):
        tn = f"t{i % 10}"
        store.append_submit(_spec(pkg, store.next_task_id(tn), tn))
    for tid in list(store.records):
        for st in rng.choices(["ACTIVE", "PENDING", "PAUSED", "ACTIVE"], k=5):
            store.append_state(tid, st)
        if rng.random() < 0.3:
            store.append_state(tid, "FAILED", error="boom")
    live = _snapshot(store)
    totals = store.compact()
    assert totals["records"] == 40
    assert totals["bytes_after"] < totals["bytes_before"]
    assert _snapshot(store) == live
    store.close()
    replayed = _fresh(pkg, root, n_shards=4)
    assert _snapshot(replayed) == live
    replayed.compact()
    replayed.close()
    first = [pathlib.Path(p).read_bytes() for p in store.shard_paths()]
    again = _fresh(pkg, root, n_shards=4)
    again.compact()
    again.close()
    second = [pathlib.Path(p).read_bytes() for p in again.shard_paths()]
    assert first == second
    final = _fresh(pkg, root, n_shards=4)
    assert _snapshot(final) == live
    final.close()


def test_compacted_shards_equal_across_packages(tmp_path):
    """The same records appended by either package's store, then compacted,
    leave byte-equal shard files, and each package replays the other's."""
    rng = random.Random(3)
    ops = [(f"t{i % 7}", rng.choice(["ACTIVE", "PAUSED", "SUCCEEDED"]))
           for i in range(30)]
    shards = {}
    for name in PKGS:
        ns = _ns(name)
        store = _fresh(ns, tmp_path / name, n_shards=4)
        for tn, state in ops:
            tid = store.next_task_id(tn)
            store.append_submit(_spec(ns, tid, tn))
            store.append_state(tid, state)
        store.compact()
        live = _snapshot(store)
        store.close()
        shards[name] = ([pathlib.Path(p).read_bytes() for p in store.shard_paths()], live)
    # records carry their submit times: equal up to those, replay must agree
    for name, other in (("repro", "repro_torch"), ("repro_torch", "repro")):
        back = _fresh(_ns(other), tmp_path / name, n_shards=4)
        assert _snapshot(back) == shards[name][1]
        back.close()
    strip = [{k: {kk: vv for kk, vv in v[3].items() if kk != "submitted_s"}
              for k, v in shards[n][1].items()} for n in PKGS]
    assert strip[0] == strip[1]


def test_legacy_single_log_migrates_into_shards(pkg, tmp_path):
    root = tmp_path / "s"
    os.makedirs(root)
    specs = [_spec(pkg, f"task-{i:06d}-t{i % 3}", f"t{i % 3}") for i in range(9)]
    with open(root / "tasks.log", "w", encoding="utf-8") as fh:
        for sp in specs:
            fh.write(pkg.checked_line({"type": "submit", "spec": sp.to_json()}) + "\n")
        fh.write(pkg.checked_line({"type": "state", "task_id": specs[4].task_id,
                                   "state": "SUCCEEDED", "error": None}) + "\n")
    store = _fresh(pkg, root, n_shards=4)
    assert not os.path.exists(root / "tasks.log")
    assert os.path.exists(root / "tasks.log.migrated")
    assert len(store.records) == 9
    assert [store.records[sp.task_id].seq for sp in specs] == list(range(9))
    assert store.records[specs[4].task_id].state == "SUCCEEDED"
    assert store.next_task_id("t0").startswith("task-000000009-")
    live = _snapshot(store)
    store.close()
    reopened = _fresh(pkg, root, n_shards=4)
    assert _snapshot(reopened) == live
    reopened.close()


def test_replay_survives_shard_count_change(pkg, tmp_path):
    root = tmp_path / "s"
    store = _fresh(pkg, root, n_shards=4)
    for i in range(20):
        tn = f"t{i % 5}"
        store.append_submit(_spec(pkg, store.next_task_id(tn), tn))
    live = _snapshot(store)
    store.close()
    wider = _fresh(pkg, root, n_shards=8, group_commit=False)
    assert _snapshot(wider) == live
    wider.append_submit(_spec(pkg, wider.next_task_id("t0"), "t0"))
    assert len(wider.records) == 21 and wider.fsyncs >= 1
    wider.close()


def _tenant_where(pred):
    return next(t for t in (f"t{i}" for i in range(100_000)) if pred(t))


def test_state_survives_shard_narrowing(pkg, tmp_path):
    root = tmp_path / "s"
    shard_of = pkg.store.shard_of
    tenant = _tenant_where(lambda t: shard_of(t, 8) >= 4)
    wide = _fresh(pkg, root, n_shards=8)
    tid = wide.next_task_id(tenant)
    wide.append_submit(_spec(pkg, tid, tenant))
    wide.close()
    narrow = _fresh(pkg, root, n_shards=4)
    assert narrow.records[tid].state == "PENDING"
    narrow.append_state(tid, "SUCCEEDED")
    narrow.close()
    again = _fresh(pkg, root, n_shards=4)
    assert again.records[tid].state == "SUCCEEDED"
    again.close()


def test_state_survives_arbitrary_shard_resize(pkg, tmp_path):
    root = tmp_path / "s"
    shard_of = pkg.store.shard_of
    tenant = _tenant_where(
        lambda t: shard_of(t, 6) < 4 and shard_of(t, 4) < shard_of(t, 6))
    old = _fresh(pkg, root, n_shards=6)
    tid = old.next_task_id(tenant)
    old.append_submit(_spec(pkg, tid, tenant))
    old.close()
    cur = _fresh(pkg, root, n_shards=4)
    cur.append_state(tid, "FAILED", error="boom")
    cur.close()
    again = _fresh(pkg, root, n_shards=4)
    assert again.records[tid].state == "FAILED"
    assert again.records[tid].error == "boom"
    again.close()


def test_compaction_does_not_deadlock_with_group_commit(pkg, tmp_path):
    st = _fresh(pkg, tmp_path / "s", n_shards=1, group_commit=True)
    st.append_submit(_spec(pkg, st.next_task_id("t"), "t"))
    sh = st._shards[0]
    with sh.cond:
        sh.syncing = True
    done = threading.Event()

    def committer():
        time.sleep(0.1)
        with sh.lock:
            fd = sh.fh.fileno()
        os.fsync(fd)
        with sh.cond:
            sh.syncing = False
            sh.cond.notify_all()
        done.set()

    threading.Thread(target=committer, daemon=True).start()
    compactor = threading.Thread(target=lambda: st.compact_shard(sh), daemon=True)
    compactor.start()
    compactor.join(timeout=10.0)
    assert not compactor.is_alive(), "compact_shard deadlocked vs group commit"
    assert done.wait(10.0)
    st.close()


def test_group_commit_append_hammer_with_auto_compaction(pkg, tmp_path):
    root = tmp_path / "s"
    st = pkg.store.TaskStore(root, n_shards=2, group_commit=True,
                             auto_compact=True, compact_slack=4)

    def worker(wid):
        for _ in range(40):
            tn = f"t{wid}"
            tid = st.next_task_id(tn)
            st.append_submit(_spec(pkg, tid, tn))
            st.append_state(tid, "ACTIVE")
            st.append_state(tid, "SUCCEEDED")

    ts = [threading.Thread(target=worker, args=(w,), daemon=True) for w in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60.0)
    assert not any(t.is_alive() for t in ts), "appends wedged behind compaction"
    deadline = time.monotonic() + 10.0
    while st.compactions == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert st.compactions >= 1
    live = _snapshot(st)
    st.close()
    assert len(live) == 160
    replayed = _fresh(pkg, root, n_shards=2)
    assert _snapshot(replayed) == live
    replayed.close()


def test_event_bus_delivery_order_across_threads(pkg):
    bus = pkg.EventBus()
    seen, stall = [], threading.Event()

    def sub(ev):
        if ev.seq == 0:
            stall.wait(5.0)
        seen.append(ev.seq)

    bus.subscribe(sub)
    t = threading.Thread(target=lambda: bus.emit("SUBMITTED", "t0", "a"))
    t.start()
    while bus.next_seq == 0:
        time.sleep(0.001)
    t2 = threading.Thread(target=lambda: bus.emit("SUBMITTED", "t1", "a"))
    t2.start()
    time.sleep(0.05)
    assert seen == []
    stall.set()
    t.join(5.0)
    t2.join(5.0)
    assert seen == [0, 1]


def test_event_bus_global_order_under_emit_storm(pkg):
    bus = pkg.EventBus()
    seen = []
    bus.subscribe(lambda ev: seen.append(ev.seq))
    start = threading.Barrier(8)

    def emitter(wid):
        start.wait()
        for _ in range(100):
            bus.emit("PROGRESS", f"t{wid}", "a")

    ts = [threading.Thread(target=emitter, args=(w,)) for w in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert seen == list(range(800))


def test_event_cursor_resume_after_gap(pkg, tmp_path):
    spill = str(tmp_path / "events.log")
    bus = pkg.EventBus(history=4, spill_path=spill)
    for i in range(20):
        bus.emit("PROGRESS", f"t{i}", "a", i=i)
    assert [e.seq for e in bus.history()] == [16, 17, 18, 19]
    assert [e.seq for e in bus.read_from(0)] == list(range(20))
    assert [e.seq for e in bus.read_from(17)] == [17, 18, 19]
    assert [e.seq for e in bus.read_from(5, limit=3)] == [5, 6, 7]
    got = []
    bus.subscribe(lambda ev: got.append(ev.seq), from_seq=10)
    assert got == list(range(10, 20))
    bus.emit("PROGRESS", "t20", "a")
    assert got == list(range(10, 21))
    bus.close()


def test_event_seq_resumes_across_reopen(pkg, tmp_path):
    spill = str(tmp_path / "events.log")
    bus = pkg.EventBus(spill_path=spill)
    for i in range(5):
        bus.emit("PROGRESS", f"t{i}", "a")
    bus.close()
    bus2 = pkg.EventBus(spill_path=spill)
    assert bus2.next_seq == 5
    assert bus2.emit("SUCCEEDED", "t5", "a").seq == 5
    assert [e.seq for e in bus2.read_from(0)] == list(range(6))
    bus2.close()


def test_event_log_read_across_packages(tmp_path):
    """The event spill log one package wrote is read, and numbered on, by
    the other."""
    spill = str(tmp_path / "events.log")
    ref, port = _ns("repro"), _ns("repro_torch")
    bus = ref.EventBus(spill_path=spill)
    for i in range(4):
        bus.emit("PROGRESS", f"t{i}", "a", i=i)
    bus.close()
    bus2 = port.EventBus(spill_path=spill)
    assert [(e.seq, e.task_id, e.payload) for e in bus2.read_from(0)] == [
        (i, f"t{i}", {"i": i}) for i in range(4)]
    assert bus2.emit("SUCCEEDED", "t4", "a").seq == 4
    bus2.close()
    bus3 = ref.EventBus(spill_path=spill)
    assert [e.seq for e in bus3.read_from(0)] == list(range(5)) and bus3.next_seq == 5
    bus3.close()


def test_event_seq_resumes_past_oversized_tail_line(pkg, tmp_path):
    spill = str(tmp_path / "events.log")
    bus = pkg.EventBus(spill_path=spill)
    bus.emit("PROGRESS", "t0", "a")
    bus.emit("PROGRESS", "t1", "a", blob="x" * 200_000)
    bus.close()
    bus2 = pkg.EventBus(spill_path=spill)
    assert bus2.next_seq == 2
    assert bus2.emit("SUCCEEDED", "t2", "a").seq == 2
    bus2.close()


def test_subscribe_from_seq_no_gap_no_dup_under_concurrent_emits(pkg, tmp_path):
    bus = pkg.EventBus(history=8, spill_path=str(tmp_path / "events.log"))
    for i in range(50):
        bus.emit("PROGRESS", f"t{i}", "a")
    stop = threading.Event()

    def emitter():
        i = 50
        while not stop.is_set():
            bus.emit("PROGRESS", f"t{i}", "a")
            i += 1

    t = threading.Thread(target=emitter)
    t.start()
    try:
        got = []
        bus.subscribe(lambda ev: got.append(ev.seq), from_seq=0)
        while len(got) < 120:
            time.sleep(0.001)
    finally:
        stop.set()
        t.join(5.0)
    bus.close()
    assert got[:120] == list(range(120))


def test_activation_index_matches_reference_policy(pkg):
    rng = random.Random(0)
    for trial in range(60):
        tenants = [f"t{i}" for i in range(rng.randrange(1, 8))]
        pending = []
        seq = 0
        for tn in tenants:
            for _ in range(rng.randrange(0, 6)):
                pending.append((seq, f"task-{seq:09d}-{tn}", tn))
                seq += 1
        rng.shuffle(pending)
        active = {tn: rng.randrange(0, 3) for tn in tenants}
        served = {tn: rng.randrange(0, 4) for tn in tenants}
        quotas = {tn: pkg.TenantQuota(max_active=rng.choice([None, 1, 2]))
                  for tn in tenants if rng.random() < 0.5}
        free = rng.randrange(0, 8)
        want = pkg.select_activations(
            pending, dict(active), free_slots=free, quotas=quotas,
            served_by_tenant=dict(served))
        idx = pkg.ActivationIndex(served=dict(served))
        for s, tid, tn in pending:
            idx.add(s, tid, tn)
        for tn, n in active.items():
            idx.active_delta(tn, n)
        assert idx.select(free, quotas=quotas) == want, trial


def test_bulk_apis_and_cursor_pagination(pkg, tmp_path):
    svc = pkg.TransferService(tmp_path / "svc", svc_config(
        pkg, default_quota=pkg.TenantQuota(max_active=0)))
    try:
        ids = []
        for tn in ("alice", "bob", "carol"):
            out = svc.submit_many(
                [[("s", "d", 1)] for _ in range(10)], tenant=tn, batch=False)
            assert len(out) == 10 and all(len(x) == 1 for x in out)
            ids.extend(tid for x in out for tid in x)
        assert len(set(ids)) == 30
        sts = svc.status_many(ids)
        assert [s.task_id for s in sts] == ids
        assert all(s.state == "PENDING" for s in sts)
        full = [s.task_id for s in svc.tasks()]
        assert full == sorted(ids)
        walked, cursor = [], None
        while True:
            page = svc.tasks(cursor=cursor, limit=7)
            if not page:
                break
            assert len(page) <= 7
            walked.extend(s.task_id for s in page)
            cursor = page[-1].task_id
        assert walked == full
        bob = [s.task_id for s in svc.tasks(tenant="bob")]
        assert len(bob) == 10 and all("-bob" in t for t in bob)
        assert [s.task_id for s in svc.tasks(tenant="bob", limit=3)] == bob[:3]
        assert svc.tasks(state="ACTIVE") == []
        with pytest.raises(KeyError):
            svc.tasks(cursor="task-999999999-nope")
    finally:
        svc.close()


def test_service_events_from_and_restart_seq(pkg, tmp_path):
    items = make_files(tmp_path, 2, 50_000)
    svc = pkg.TransferService(tmp_path / "svc", svc_config(pkg))
    [tid] = svc.submit(items, tenant="alice", batch=False)
    svc.wait(tid, timeout=30)
    evs = svc.events_from(0)
    assert [e.seq for e in evs] == list(range(len(evs)))
    kinds = [e.kind for e in evs]
    assert kinds[0] == "SUBMITTED" and "SUCCEEDED" in kinds
    n = len(evs)
    svc.close()
    svc2 = pkg.TransferService(tmp_path / "svc", svc_config(pkg))
    try:
        [tid2] = svc2.submit(items, tenant="alice", batch=False)
        svc2.wait(tid2, timeout=30)
        evs2 = svc2.events_from(0)
        assert [e.seq for e in evs2][:n] == list(range(n))
        assert len(evs2) > n and [e.seq for e in evs2] == list(range(len(evs2)))
    finally:
        svc2.close()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_cuda_service_verifies_on_the_card(cuda_device, tmp_path):
    """Pipelined tasks on the card: tile-aligned 64 KiB chunks through
    ``checksum_many_words`` (and ``checksum_words`` for batches of one), a
    9 MiB oversize task and a ragged one through ``checksum_words``."""
    from repro_torch.core.integrity import fingerprint_bytes
    from repro_torch.kernels import checksum as tck

    files = {"aligned": 32 * 64 * KiB, "oversize": 2 * 9 * MiB, "ragged": 777_777}
    for i, (name, n) in enumerate(files.items()):
        (tmp_path / name).write_bytes(np.random.default_rng(i).bytes(n))
    tck.reset_launch_counts()
    svc = TransferService(tmp_path / "svc", ServiceConfig(
        pipeline="pipelined", integrity_workers=2, mover_budget=8,
        max_concurrent_tasks=3, tick_s=0.002), device=cuda_device)
    try:
        tids = {name: svc.submit([(str(tmp_path / name), str(tmp_path / name) + ".out")],
                                 chunk_bytes=9 * MiB if name == "oversize" else 64 * KiB)[0]
                for name in files}
        sts = {name: svc.wait(t, timeout=120) for name, t in tids.items()}
        stats = {name: svc.integrity_stats(t) for name, t in tids.items()}
    finally:
        svc.close()
    torch.cuda.synchronize()
    for name in files:
        data = (tmp_path / name).read_bytes()
        assert sts[name].state == "SUCCEEDED", sts[name].error
        assert (tmp_path / f"{name}.out").read_bytes() == data
        assert sts[name].item_reports[0].digest_hex == fingerprint_bytes(data).hexdigest()
        assert stats[name].per_job == 0, name
    assert stats["aligned"].host_rows == 0
    assert stats["oversize"].device_jobs == 2
    counts = tck.launch_counts()
    assert counts["checksum_words"] >= 2
    assert counts["checksum_many_words"] >= 1 or stats["aligned"].device_jobs == 32


@pytest.mark.gpu
def test_cuda_bridge_digests_card_leaves_at_submit(cuda_device, tmp_path):
    """Leaves on the card, updated right after submit: the save holds the
    weights of the submit, restores bit-equal to them, and ``wait()`` holds
    each leaf's on-card digest to the landed digest."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    state = {"wq": torch.randn(640, 320, generator=gen, device=cuda_device).to(torch.bfloat16),
             "ln": torch.randn(320, generator=gen, device=cuda_device)}
    before = {k: v.clone() for k, v in state.items()}
    svc = TransferService(tmp_path / "svc", ServiceConfig(
        pipeline="pipelined", chunk_bytes=64 * KiB, tick_s=0.002), device=cuda_device)
    try:
        sub = submit_checkpoint(svc, tmp_path / "ckpt", 1, state)
        for v in state.values():
            v.add_(1.0)                               # training goes on
        rep = sub.wait(60)
    finally:
        svc.close()
    assert set(sub.card_digests) == set(state)
    got, _ = port_restore(rep.path, device=cuda_device)
    for k, v in before.items():
        assert torch.equal(got[k], v), k
        assert not torch.equal(got[k], state[k]), k
