"""The port's intra-chunk striping and fused batch integrity, against the
reference's.

Every test of ``tests/test_stripe.py`` runs here on the port (its engine,
integrity engine and service with ``device="cpu"``, so the kernels' plain
versions digest): stripe planning, the merge law over stripes, striped
transfers on every pipeline, kill-restart custody, the fused drain, the
off-POSIX fallback, the buffer pool, the stripe ladder and the service's
stripe band. The twin of ``test_tuner_drives_engine_stripe_count`` feeds
the controller fixed-rate samples, so it does not depend on wall time.

Then the checks across packages, on the same seeded inputs:

  * 1, 2 and 4 stripes on each pipeline, vectored writes on and off, buffer
    and file endpoints: equal file digests, stripe counts, striped and
    skipped chunks, and equal sets of journal records (several movers); one
    mover and one integrity worker write byte-identical journals;
  * a striped transfer killed after 6 journaled stripes by one package is
    resumed by the other without re-moving a journaled byte;
  * the fused drain's verdicts on a corrupted stripe, fuse on and off;
  * the stripe ladder under fixed samples: equal replans and stripe counts;
  * a striped service task: equal item digests, stripe and striped-chunk
    counts.

The reference is imported inside the tests (``_ns``), so the card's
machine, which has no JAX, can collect this file.
"""
import functools
import importlib
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                                   # pragma: no cover
    from _hypofallback import given, settings, strategies as st

import repro_torch.core.transfer as port_transfer
from repro_torch.convert import plan_from_reference
from repro_torch.core.chunker import Chunk, MiB, plan_chunks, plan_stripes
from repro_torch.core.dataplane import BufferPool, VerifyJob
from repro_torch.core.dataplane import IntegrityEngine as _PortEngine
from repro_torch.core.integrity import fingerprint_bytes, fingerprint_many, merge_all
from repro_torch.core.journal import ChunkJournal
from repro_torch.core.transfer import (
    STRIPE_INDEX_BASE,
    BufferDest,
    BufferSource,
    FileDest,
    FileSource,
)
from repro_torch.core.transfer import ChunkedTransfer as _PortTransfer
from repro_torch.tune.controller import ChunkController
from repro_torch.tune.probe import ChunkSample

KiB = 1024
PKGS = ("repro", "repro_torch")

# the port's engines digest on the CPU here (the kernels' plain versions)
ChunkedTransfer = functools.partial(_PortTransfer, device="cpu")
IntegrityEngine = functools.partial(_PortEngine, device="cpu")


@functools.lru_cache(maxsize=None)
def _ns(name: str) -> SimpleNamespace:
    """One package's striping surface under one set of names; the port's
    engines are bound to ``device="cpu"``."""
    core = importlib.import_module(f"{name}.core")
    transfer = importlib.import_module(f"{name}.core.transfer")
    dataplane = importlib.import_module(f"{name}.core.dataplane")
    svc = importlib.import_module(f"{name}.service.service")
    tune = importlib.import_module(f"{name}.tune")
    port = name == "repro_torch"
    bind = (lambda f: functools.partial(f, device="cpu")) if port else (lambda f: f)
    return SimpleNamespace(
        name=name, core=core,
        ChunkedTransfer=bind(transfer.ChunkedTransfer),
        IntegrityEngine=bind(dataplane.IntegrityEngine),
        TransferService=bind(svc.TransferService), ServiceConfig=svc.ServiceConfig,
        ChunkController=tune.ChunkController, ChunkSample=tune.ChunkSample,
        STRIPE_INDEX_BASE=transfer.STRIPE_INDEX_BASE,
        plan=(plan_from_reference if port else (lambda p: p)),
    )


def _payload(seed, nbytes):
    return np.random.default_rng(seed).integers(
        0, 256, nbytes, dtype=np.uint8).tobytes()


def _key(d):
    return (tuple(int(v) for v in d.h), int(d.length))


# ---------------------------------------------------------------------------
# stripe planning algebra
# ---------------------------------------------------------------------------
@given(
    st.integers(1, 1 << 26),      # chunk length
    st.integers(1, 16),           # requested stripes
    st.integers(1, 4 * MiB),      # stripe_min_bytes
    st.integers(0, 12),           # alignment exponent
)
@settings(max_examples=60, deadline=None)
def test_plan_stripes_tiles_parent_exactly(length, stripes, min_bytes, align_pow):
    align = 1 << align_pow
    chunk = Chunk(index=3, offset=7, length=length, mover=1)
    plan = plan_stripes(chunk, stripes,
                        stripe_min_bytes=min_bytes, alignment=align)
    plan.validate()
    assert 1 <= plan.n_stripes <= stripes
    for s in plan.stripes:
        if s.seq > 0:
            assert (s.offset - chunk.offset) % align == 0
    if plan.n_stripes > 1:
        for s in plan.stripes[:-1]:
            assert s.length >= min_bytes


def test_plan_stripes_validates_params():
    c = Chunk(index=0, offset=0, length=MiB, mover=0)
    with pytest.raises(ValueError):
        plan_stripes(c, 0)
    with pytest.raises(ValueError):
        plan_stripes(c, 2, stripe_min_bytes=0)
    with pytest.raises(ValueError):
        plan_stripes(c, 2, alignment=0)


@given(st.binary(min_size=1, max_size=1 << 14), st.integers(1, 8),
       st.integers(1, 512))
@settings(max_examples=40, deadline=None)
def test_stripe_digest_fold_matches_whole_chunk(payload, stripes, min_bytes):
    chunk = Chunk(index=0, offset=0, length=len(payload), mover=0)
    plan = plan_stripes(chunk, stripes, stripe_min_bytes=min_bytes)
    parts = [fingerprint_bytes(payload[s.offset:s.end]) for s in plan.stripes]
    assert merge_all(parts) == fingerprint_bytes(payload)


@given(st.binary(min_size=0, max_size=4096),
       st.lists(st.integers(0, 4096), max_size=8))
@settings(max_examples=40, deadline=None)
def test_any_partition_folds_to_whole_digest(payload, cuts):
    pts = sorted({c % (len(payload) + 1) for c in cuts} | {0, len(payload)})
    pieces = [payload[a:b] for a, b in zip(pts, pts[1:])] or [b""]
    assert merge_all(fingerprint_bytes(p) for p in pieces) == \
        fingerprint_bytes(payload)


# ---------------------------------------------------------------------------
# striped transfers end-to-end (the port)
# ---------------------------------------------------------------------------
def test_stripe_engine_param_validation():
    payload = b"x" * 1024
    plan = plan_chunks(1024, 1, chunk_bytes=1024, min_chunk=1, max_chunk=1 << 20)
    with pytest.raises(ValueError):
        ChunkedTransfer(BufferSource(payload), BufferDest(1024), plan, stripes=0)
    with pytest.raises(ValueError):
        ChunkedTransfer(BufferSource(payload), BufferDest(1024), plan,
                        stripes=2, speculative_factor=0.5)
    with pytest.raises(ValueError):
        ChunkedTransfer(BufferSource(payload), BufferDest(1024), plan,
                        stripe_min_bytes=0)


@pytest.mark.parametrize("mode", ["serial", "single_pass", "pipelined"])
@pytest.mark.parametrize("iov", [1, 4])
def test_striped_roundtrip_all_pipeline_modes(mode, iov):
    payload = _payload(11, 3 * MiB)
    plan = plan_chunks(len(payload), 2, chunk_bytes=MiB,
                       min_chunk=1, max_chunk=1 << 30)
    dst = BufferDest(len(payload))
    rep = ChunkedTransfer(
        BufferSource(payload), dst, plan, pipeline=mode,
        integrity_workers=2, stripes=4, stripe_min_bytes=128 * KiB,
        iov_batch=iov,
    ).run()
    assert bytes(dst.buf) == payload
    assert rep.file_digest == fingerprint_bytes(payload)
    assert rep.stripes == 4
    assert rep.striped_chunks == plan.n_chunks
    assert all(i >= STRIPE_INDEX_BASE for i in rep.outcomes)
    assert len(rep.outcomes) == 4 * plan.n_chunks


def test_sub_minimum_chunks_are_never_striped():
    payload = _payload(5, 256 * KiB)
    plan = plan_chunks(len(payload), 2, chunk_bytes=64 * KiB,
                       min_chunk=1, max_chunk=1 << 30)
    dst = BufferDest(len(payload))
    rep = ChunkedTransfer(BufferSource(payload), dst, plan,
                          stripes=4, stripe_min_bytes=MiB).run()
    assert bytes(dst.buf) == payload
    assert rep.striped_chunks == 0
    assert rep.file_digest == fingerprint_bytes(payload)


class _HostCrash(Exception):
    """Unclassified crash: propagates out of run() like a host death."""


def _bomb_after(survivors):
    calls = [0]

    def bomb(_chunk, _attempt):
        calls[0] += 1
        if calls[0] > survivors:
            raise _HostCrash("host died mid-stripe")
    return bomb


def test_striped_kill_restart_never_removes_journaled(tmp_path):
    payload = _payload(21, 2 * MiB)
    plan = plan_chunks(len(payload), 1, chunk_bytes=512 * KiB,
                       min_chunk=1, max_chunk=1 << 30)
    jpath = str(tmp_path / "stripe.journal")
    survivors = 6
    dst = BufferDest(len(payload))
    j = ChunkJournal(jpath)
    try:
        with pytest.raises(_HostCrash):
            ChunkedTransfer(BufferSource(payload), dst, plan, journal=j,
                            fault_injector=_bomb_after(survivors), max_retries=0,
                            stripes=4, stripe_min_bytes=64 * KiB).run()
    finally:
        j.close()

    j2 = ChunkJournal(jpath)
    journaled = [(r.offset, r.length) for r in j2.records.values()]
    assert len(journaled) == survivors
    assert all(g >= STRIPE_INDEX_BASE for g in j2.records)

    moved = []
    rep = ChunkedTransfer(
        BufferSource(payload), dst, plan, journal=j2,
        fault_injector=lambda c, _a: moved.append((c.offset, c.length)),
        stripes=4, stripe_min_bytes=64 * KiB,
    ).run()
    j2.close()
    assert bytes(dst.buf) == payload
    assert rep.file_digest == fingerprint_bytes(payload)
    assert rep.skipped_chunks == survivors
    overlaps = [
        m for m in set(moved)
        if any(m[0] < jo + jl and jo < m[0] + m[1] for jo, jl in journaled)
    ]
    assert overlaps == []
    assert moved


# ---------------------------------------------------------------------------
# fused batch integrity (engine drain)
# ---------------------------------------------------------------------------
def _engine(record, engine_cls=IntegrityEngine, **kw):
    lock = threading.Lock()

    def ok(job, _lag, _ck):
        with lock:
            record["ok"].append(job.key)

    def bad(job, _actual, _lag):
        with lock:
            record["bad"].append(job.key)

    def err(job, exc):
        with lock:
            record["err"].append((job.key, exc))

    return engine_cls(on_verified=ok, on_corrupt=bad, on_error=err, **kw)


def _corrupt_stripe_run(ns, fuse):
    """128 granules, the 17th corrupted, through one package's engine;
    returns (verdicts, stats)."""
    granule, jobs = 4 * KiB, 128
    payload = _payload(31, granule * jobs)
    dst = ns.core.BufferDest(len(payload))
    dst.write(0, payload)
    dst.buf[17 * granule + granule // 2] ^= 0xFF
    expected = ns.core.fingerprint_many(
        [payload[i * granule:(i + 1) * granule] for i in range(jobs)])
    record = {"ok": [], "bad": [], "err": []}
    eng = _engine(record, ns.IntegrityEngine, workers=1, fuse=fuse, batch=32)
    try:
        t0 = time.monotonic()
        for i in range(jobs):
            assert eng.submit(ns.core.VerifyJob(key=i, offset=i * granule,
                                                length=granule, expected=expected[i],
                                                dest=dst, enqueued_s=t0))
        assert eng.drain(timeout=60.0)
    finally:
        eng.close()
    return record, eng.stats


@pytest.mark.parametrize("fuse", [True, False])
def test_fused_drain_catches_corrupted_stripe(fuse):
    record, stats = _corrupt_stripe_run(_ns("repro_torch"), fuse)
    assert record["bad"] == [17]
    assert sorted(record["ok"]) == [i for i in range(128) if i != 17]
    assert record["err"] == []
    # the port's engine digests on its device: nothing on the host
    assert stats.host_rows == 0 and stats.per_job == 0
    if fuse:
        assert stats.fused_batches >= 1
        assert stats.fused_jobs > 0
        assert stats.device_rows > 0


def test_drain_return_is_authoritative_under_concurrent_submit():
    granule, per_thread, threads_n = 2 * KiB, 100, 3
    payload = _payload(41, granule * per_thread * threads_n)
    dst = BufferDest(len(payload))
    dst.write(0, payload)
    expected = fingerprint_many(
        [payload[i * granule:(i + 1) * granule]
         for i in range(per_thread * threads_n)])
    record = {"ok": [], "bad": [], "err": []}
    eng = _engine(record, workers=2, fuse=True, batch=16)
    stop = threading.Event()

    def submitter(base):
        for i in range(base, base + per_thread):
            assert eng.submit(VerifyJob(key=i, offset=i * granule,
                                        length=granule, expected=expected[i],
                                        dest=dst, enqueued_s=0.0))

    def hammer():
        while not stop.is_set():
            eng.drain(timeout=0.002)

    try:
        ts = [threading.Thread(target=submitter, args=(k * per_thread,))
              for k in range(threads_n)]
        hz = threading.Thread(target=hammer)
        hz.start()
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        stop.set()
        hz.join()
        assert eng.drain(timeout=60.0)
        assert len(record["ok"]) == per_thread * threads_n
        assert record["bad"] == [] and record["err"] == []
        assert eng.pending == 0
    finally:
        eng.close()


# ---------------------------------------------------------------------------
# the batched checksum kernel's plain version against the host digest
# ---------------------------------------------------------------------------
def test_checksum_many_words_matches_per_stream_and_host():
    from repro_torch.kernels.checksum import (TILE_BYTES, checksum_many_words,
                                              checksum_words)
    rng = np.random.default_rng(3)
    k, nbytes = 4, 2 * TILE_BYTES
    raw = rng.integers(0, 256, (k, nbytes), dtype=np.uint8)
    words = torch.from_numpy(np.ascontiguousarray(raw).view(np.int32))
    got = checksum_many_words(words)
    assert got.shape[0] == k
    for i in range(k):
        per = checksum_words(words[i])
        assert got[i].tolist() == per.tolist()
        assert tuple(int(v) for v in got[i]) == \
            fingerprint_bytes(raw[i].tobytes()).h


def test_checksum_many_words_equals_the_reference_host_digest():
    """Per stream, the port's batched digest equals the reference's host
    digest and, where JAX is installed, the reference kernel's residues."""
    ref_integrity = importlib.import_module("repro.core.integrity")
    from repro_torch.kernels.checksum import TILE_BYTES, checksum_many_words
    rng = np.random.default_rng(13)
    k, nbytes = 3, 3 * TILE_BYTES
    raw = rng.integers(0, 256, (k, nbytes), dtype=np.uint8)
    words = np.ascontiguousarray(raw).view(np.int32)
    got = checksum_many_words(torch.from_numpy(words)).tolist()
    for i in range(k):
        assert tuple(got[i]) == ref_integrity.fingerprint_bytes(raw[i].tobytes()).h
    jnp = pytest.importorskip("jax.numpy")
    ref_kernel = importlib.import_module("repro.kernels.checksum")
    want = np.asarray(ref_kernel.checksum_many_words(jnp.asarray(words))).tolist()
    assert got == want


# ---------------------------------------------------------------------------
# fingerprint_many length validation
# ---------------------------------------------------------------------------
def test_fingerprint_many_expect_equal_rejects_ragged():
    with pytest.raises(ValueError) as ei:
        fingerprint_many([b"aaaa", b"bb", b"cccc"], expect_equal=True)
    msg = str(ei.value)
    assert "items [1] have 2 bytes" in msg
    assert "items [0, 2] have 4 bytes" in msg


def test_fingerprint_many_ragged_falls_back_per_item():
    chunks = [b"", b"a", b"ab", _payload(1, 777), _payload(2, 777), b"a"]
    got = fingerprint_many(chunks)
    assert got == [fingerprint_bytes(c) for c in chunks]


def test_fingerprint_many_equal_lengths_match_per_chunk():
    chunks = [_payload(i, 4096) for i in range(9)]
    assert fingerprint_many(chunks, expect_equal=True) == \
        [fingerprint_bytes(c) for c in chunks]


# ---------------------------------------------------------------------------
# off-POSIX fallback under a concurrent mover pool
# ---------------------------------------------------------------------------
def test_fallback_file_endpoints_concurrent_movers(tmp_path, monkeypatch):
    monkeypatch.setattr(port_transfer, "_HAS_PREAD", False)
    payload = _payload(51, 2 * MiB)
    spath, dpath = str(tmp_path / "src.bin"), str(tmp_path / "dst.bin")
    with open(spath, "wb") as fh:
        fh.write(payload)
    src, dst = FileSource(spath), FileDest(dpath, len(payload))
    assert src._fd is None and dst._fd is None
    try:
        plan = plan_chunks(len(payload), 4, chunk_bytes=128 * KiB,
                           min_chunk=1, max_chunk=1 << 30)
        rep = ChunkedTransfer(src, dst, plan, pipeline="pipelined",
                              integrity_workers=2, stripes=2,
                              stripe_min_bytes=32 * KiB, iov_batch=4).run()
        assert rep.file_digest == fingerprint_bytes(payload)
    finally:
        src.close()
        dst.close()
    with open(dpath, "rb") as fh:
        assert fh.read() == payload
    assert src._fallback._all == [] and dst._fallback._all == []


def test_fallback_concurrent_reads_are_isolated(tmp_path, monkeypatch):
    monkeypatch.setattr(port_transfer, "_HAS_PREAD", False)
    payload = _payload(52, 512 * KiB)
    spath = str(tmp_path / "s.bin")
    with open(spath, "wb") as fh:
        fh.write(payload)
    src = FileSource(spath)
    errors = []

    def reader(seed):
        rng = np.random.default_rng(seed)
        for _ in range(60):
            off = int(rng.integers(0, len(payload) - 64))
            if src.read(off, 64) != payload[off:off + 64]:
                errors.append(off)
                return

    ts = [threading.Thread(target=reader, args=(i,)) for i in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    src.close()
    assert errors == []


# ---------------------------------------------------------------------------
# BufferPool lease audit
# ---------------------------------------------------------------------------
def test_buffer_pool_rejects_negative_length():
    pool = BufferPool(1024, capacity=2)
    with pytest.raises(ValueError):
        pool.acquire(-1)


def test_buffer_pool_oversize_one_shot_never_pooled():
    pool = BufferPool(1024, capacity=2)
    buf = pool.acquire(4096)
    assert len(buf.view) == 4096
    assert pool.stats.oversize == 1
    buf.release()
    assert pool._free == []
    b2 = pool.acquire(100)
    b2.release()
    assert len(pool._free) == 1


def test_buffer_pool_double_release_is_noop():
    pool = BufferPool(1024, capacity=4)
    buf = pool.acquire(64)
    buf.release()
    buf.release()
    assert len(pool._free) == 1


def test_buffer_pool_exit_is_idempotent_and_exception_safe():
    pool = BufferPool(1024, capacity=4)
    with pool.acquire(64) as buf:
        buf.release()
    assert len(pool._free) == 1
    with pytest.raises(RuntimeError):
        with pool.acquire(64):
            raise RuntimeError("mover died mid-lease")
    assert len(pool._free) == 1
    b = pool.acquire(64)
    assert pool.stats.reuses >= 1
    b.release()


# ---------------------------------------------------------------------------
# tuner: the stripe ladder actuator
# ---------------------------------------------------------------------------
def _sample(length, secs, ck=0.0, lag=0.0):
    return ChunkSample(offset=0, length=length, seconds=secs,
                       attempt_seconds=secs, cksum_seconds=ck, cksum_lag_s=lag)


def test_stripe_ladder_escalates_only_when_pinned_at_max_chunk():
    c = ChunkController(chunk_bytes=MiB, min_chunk=64 * KiB, max_chunk=MiB,
                        epoch_chunks=1, hold_patience=1,
                        stripe_ladder=(1, 2, 4))
    assert c.target_stripes() == 1
    rungs = []
    for _ in range(4):
        c.observe(_sample(MiB, 1.0))
        rungs.append(c.target_stripes())
    assert rungs == [1, 2, 4, 4]


def test_stripe_ladder_deescalates_on_multiplicative_decrease():
    c = ChunkController(chunk_bytes=MiB, min_chunk=64 * KiB, max_chunk=MiB,
                        epoch_chunks=1, hold_patience=1,
                        stripe_ladder=(1, 2, 4))
    for _ in range(3):
        c.observe(_sample(MiB, 1.0))
    assert c.target_stripes() == 4
    c.observe(_sample(MiB, 10.0))
    assert c.target_stripes() == 2
    c.observe(_sample(MiB, 100.0))
    assert c.target_stripes() == 1


def test_default_ladder_never_moves():
    c = ChunkController(chunk_bytes=MiB, min_chunk=64 * KiB, max_chunk=MiB,
                        epoch_chunks=1, hold_patience=1)
    for _ in range(6):
        c.observe(_sample(MiB, 1.0))
        assert c.target_stripes() == 1


def test_stripe_ladder_validation():
    for bad in [(), (0,), (2, 1), (1, 1, 2)]:
        with pytest.raises(ValueError):
            ChunkController(chunk_bytes=MiB, stripe_ladder=bad)


RATE_BPS = 1e9     # the fixed rate the ladder's samples report


def _fixed_rate_tuner(ns, chunk, ladder):
    """A controller of ``ns`` whose every sample reports ``RATE_BPS``: the
    engine's outcomes keep their lengths, their seconds are length / rate,
    so every decision follows from the plan alone, not from wall time."""
    class FixedRate(ns.ChunkController):
        def observe_outcome(self, out):
            c = out.chunk
            s = c.length / RATE_BPS
            return self.observe(ns.ChunkSample(offset=c.offset, length=c.length,
                                               seconds=s, attempt_seconds=s))
    return FixedRate(chunk_bytes=chunk, min_chunk=chunk, max_chunk=chunk,
                     epoch_chunks=1, hold_patience=1, stripe_ladder=ladder)


def _ladder_run(ns, ladder=(1, 2)):
    payload = _payload(61, 4 * MiB)
    plan = ns.core.plan_chunks(len(payload), 1, chunk_bytes=256 * KiB,
                               min_chunk=1, max_chunk=1 << 30)
    tuner = _fixed_rate_tuner(ns, 256 * KiB, ladder)
    dst = ns.core.BufferDest(len(payload))
    rep = ns.ChunkedTransfer(ns.core.BufferSource(payload), dst, plan, tuner=tuner,
                             stripes=1, stripe_min_bytes=64 * KiB).run()
    return payload, dst, rep, tuner


def test_tuner_drives_engine_stripe_count():
    """End-to-end: the controller's ladder decision changes the engine's
    live stripe count mid-flight. Fixed-rate samples make the decisions a
    function of the plan: the seed epoch, then one pinned grow probe that
    climbs to 2 stripes."""
    payload, dst, rep, tuner = _ladder_run(_ns("repro_torch"))
    assert bytes(dst.buf) == payload
    assert rep.file_digest == fingerprint_bytes(payload)
    assert rep.stripes == 2
    assert rep.stripe_replans >= 1
    assert rep.striped_chunks > 0
    assert [d.action for d in tuner.decisions][:2] == ["seed", "stripe"]


# ---------------------------------------------------------------------------
# service layer: journal-id bands and config validation
# ---------------------------------------------------------------------------
def test_service_stripe_band_routing():
    from repro_torch.service.service import (STRIPE_GID_BASE, STRIPE_ITEM_STRIDE,
                                             TUNE_GID_BASE, _Task)
    from repro_torch.service.task import TaskSpec, TransferItem

    assert STRIPE_GID_BASE > TUNE_GID_BASE
    spec = TaskSpec(task_id="t1", tenant="x", label="",
                    items=(TransferItem("a", "b", 5 * MiB),
                           TransferItem("c", "d", 3 * MiB)))
    t = _Task(spec, 0, chunk_bytes=MiB)
    for item in (0, 1):
        for seq in (0, 1, STRIPE_ITEM_STRIDE - 1):
            g = t.stripe_gidx(item, seq)
            assert g >= STRIPE_GID_BASE
            assert t.item_of_gidx(g) == item
    assert not t.static_record_ok(t.stripe_gidx(0, 0), None)


def test_service_config_validates_stripe_params():
    from repro_torch.service.service import ServiceConfig
    with pytest.raises(ValueError):
        ServiceConfig(stripes=0)
    with pytest.raises(ValueError):
        ServiceConfig(stripe_min_bytes=0)


def _striped_service_task(ns, root, payload):
    spath = os.path.join(str(root), "big.bin")
    with open(spath, "wb") as fh:
        fh.write(payload)
    cfg = ns.ServiceConfig(mover_budget=4, max_concurrent_tasks=2,
                           chunk_bytes=512 * KiB, tick_s=0.002,
                           stripes=4, stripe_min_bytes=64 * KiB)
    svc = ns.TransferService(os.path.join(str(root), "svc"), cfg)
    try:
        [tid] = svc.submit([(spath, spath + ".out")], batch=False)
        status = svc.wait(tid, timeout=60)
    finally:
        svc.close()
    with open(spath + ".out", "rb") as fh:
        return status, fh.read()


def test_service_striped_transfer_end_to_end(tmp_path):
    payload = np.random.default_rng(71).integers(
        0, 256, 1_500_000, dtype=np.uint8).tobytes()
    status, out = _striped_service_task(_ns("repro_torch"), tmp_path, payload)
    assert status.state == "SUCCEEDED"
    assert status.stripes == 4
    assert status.striped_chunks > 0
    assert out == payload
    [report] = status.item_reports
    assert report.digest_hex == fingerprint_bytes(payload).hexdigest()


def test_service_stripe_band_constants_equal_the_reference():
    ref = importlib.import_module("repro.service.service")
    port = importlib.import_module("repro_torch.service.service")
    for name in ("STRIPE_GID_BASE", "STRIPE_ITEM_STRIDE", "TUNE_GID_BASE"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port_transfer.STRIPE_INDEX_BASE == \
        importlib.import_module("repro.core.transfer").STRIPE_INDEX_BASE


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------
XPAYLOAD = 1 * MiB + 12345      # four 256 KiB chunks and a ragged tail
XCHUNK = 256 * KiB
XSTRIPE_MIN = 32 * KiB


@pytest.fixture(scope="module")
def xpayload():
    return _payload(81, XPAYLOAD)


def _records(path):
    j = importlib.import_module("repro.core.journal").ChunkJournal(path)
    try:
        return {(i, r.offset, r.length, r.digest_hex) for i, r in j.records.items()}
    finally:
        j.close()


def _striped_run(ns, payload, root, *, mode, stripes, iov, endpoint, movers,
                 integrity_workers):
    """One striped, journaled transfer by package ``ns``; returns the report
    and the journal's path."""
    ref_plan = importlib.import_module("repro.core").plan_chunks(
        len(payload), movers, chunk_bytes=XCHUNK, min_chunk=1, max_chunk=1 << 40)
    os.makedirs(root, exist_ok=True)
    jpath = os.path.join(root, "x.journal")
    journal = ns.core.ChunkJournal(jpath)
    if endpoint == "file":
        spath, dpath = os.path.join(root, "src.bin"), os.path.join(root, "dst.bin")
        with open(spath, "wb") as fh:
            fh.write(payload)
        src, dst = ns.core.FileSource(spath), ns.core.FileDest(dpath, len(payload))
    else:
        src, dst = ns.core.BufferSource(payload), ns.core.BufferDest(len(payload))
    try:
        rep = ns.ChunkedTransfer(src, dst, ns.plan(ref_plan), journal=journal,
                                 pipeline=mode, integrity_workers=integrity_workers,
                                 stripes=stripes, stripe_min_bytes=XSTRIPE_MIN,
                                 iov_batch=iov).run()
    finally:
        journal.close()
        if endpoint == "file":
            src.close()
            dst.close()
    if endpoint == "file":
        with open(dpath, "rb") as fh:
            assert fh.read() == payload
    else:
        assert bytes(dst.buf) == payload
    return rep, jpath


def _summary(rep):
    return (_key(rep.file_digest), rep.stripes, rep.striped_chunks, rep.skipped_chunks,
            sorted(rep.outcomes), sorted(_key(o.digest) for o in rep.outcomes.values()))


@pytest.mark.parametrize("endpoint", ["buffer", "file"])
@pytest.mark.parametrize("iov", [1, 4])
@pytest.mark.parametrize("stripes", [1, 2, 4])
@pytest.mark.parametrize("mode", ["serial", "single_pass", "pipelined"])
def test_striped_transfer_equal_across_packages(xpayload, tmp_path, mode, stripes, iov,
                                                endpoint):
    """Three movers, two integrity workers: equal digests and counts, and
    equal sets of journal records (the lines' order follows the threads)."""
    got = {}
    for name in PKGS:
        rep, jpath = _striped_run(_ns(name), xpayload, str(tmp_path / name), mode=mode,
                                  stripes=stripes, iov=iov, endpoint=endpoint, movers=3,
                                  integrity_workers=2)
        got[name] = (_summary(rep), _records(jpath))
    assert got["repro_torch"] == got["repro"]
    summary, records = got["repro"]
    assert summary[0] == _key(importlib.import_module(
        "repro.core.integrity").fingerprint_bytes(xpayload))
    if stripes > 1:
        # the four whole chunks stripe; the 12345-byte tail is under the minimum
        assert summary[1] == stripes and summary[2] == 4
        assert len(records) == 4 * stripes + 1
    else:
        assert summary[2] == 0 and len(records) == 5


@pytest.mark.parametrize("stripes", [2, 4])
@pytest.mark.parametrize("mode", ["serial", "single_pass", "pipelined"])
def test_striped_journals_are_byte_identical(xpayload, tmp_path, mode, stripes):
    """One mover and one integrity worker: stripes land, verify and journal
    in plan order, so both packages write the same journal bytes."""
    raw = {}
    for name in PKGS:
        rep, jpath = _striped_run(_ns(name), xpayload, str(tmp_path / name), mode=mode,
                                  stripes=stripes, iov=1, endpoint="buffer", movers=1,
                                  integrity_workers=1)
        with open(jpath, "rb") as fh:
            raw[name] = fh.read()
        assert rep.striped_chunks == 4
    assert raw["repro_torch"] == raw["repro"]
    assert len(raw["repro"].splitlines()) == 4 * stripes + 1   # the tail stays whole


@pytest.mark.parametrize("first, second", [("repro", "repro_torch"),
                                           ("repro_torch", "repro")])
def test_striped_kill_restart_across_packages(tmp_path, first, second):
    """The kill after 6 journaled stripes (serial, one mover), resumed by the
    other package's engine on the same journal: zero journaled bytes are
    re-moved and the destination equals the payload."""
    payload = _payload(21, 2 * MiB)
    ref_plan = importlib.import_module("repro.core").plan_chunks(
        len(payload), 1, chunk_bytes=512 * KiB, min_chunk=1, max_chunk=1 << 30)
    jpath = str(tmp_path / "stripe.journal")
    survivors = 6
    buf = bytearray(len(payload))

    ns = _ns(first)
    dst = ns.core.BufferDest(len(payload))
    dst.buf = buf
    j = ns.core.ChunkJournal(jpath)
    try:
        with pytest.raises(_HostCrash):
            ns.ChunkedTransfer(ns.core.BufferSource(payload), dst, ns.plan(ref_plan),
                               journal=j, fault_injector=_bomb_after(survivors),
                               max_retries=0, stripes=4, stripe_min_bytes=64 * KiB).run()
    finally:
        j.close()

    ns = _ns(second)
    j2 = ns.core.ChunkJournal(jpath)
    journaled = [(r.offset, r.length) for r in j2.records.values()]
    assert len(journaled) == survivors
    assert all(g >= ns.STRIPE_INDEX_BASE for g in j2.records)
    moved = []
    dst = ns.core.BufferDest(len(payload))
    dst.buf = buf
    rep = ns.ChunkedTransfer(
        ns.core.BufferSource(payload), dst, ns.plan(ref_plan), journal=j2,
        fault_injector=lambda c, _a: moved.append((c.offset, c.length)),
        stripes=4, stripe_min_bytes=64 * KiB).run()
    j2.close()
    assert bytes(buf) == payload
    assert _key(rep.file_digest) == _key(fingerprint_bytes(payload))
    assert rep.skipped_chunks == survivors
    assert not [m for m in set(moved)
                if any(m[0] < jo + jl and jo < m[0] + m[1] for jo, jl in journaled)]
    assert sum(n for _o, n in set(moved)) + sum(n for _o, n in journaled) == len(payload)


@pytest.mark.parametrize("fuse", [True, False])
def test_fused_drain_verdicts_equal_across_packages(fuse):
    got = {name: _corrupt_stripe_run(_ns(name), fuse) for name in PKGS}
    (ref_rec, ref_stats), (port_rec, port_stats) = got["repro"], got["repro_torch"]
    assert port_rec["bad"] == ref_rec["bad"] == [17]
    assert sorted(port_rec["ok"]) == sorted(ref_rec["ok"])
    assert port_rec["err"] == ref_rec["err"] == []
    assert port_stats.verified == ref_stats.verified
    assert port_stats.corrupt == ref_stats.corrupt == 1


def test_tuner_ladder_equal_across_packages():
    """Under the same fixed-rate samples both engines climb the ladder at
    the same chunk and stripe the same chunks."""
    got = {}
    for name in PKGS:
        payload, dst, rep, tuner = _ladder_run(_ns(name), ladder=(1, 2, 4))
        assert bytes(dst.buf) == payload
        got[name] = (_summary(rep), rep.stripe_replans, rep.replans,
                     [(d.epoch, d.action, d.chunk_bytes, d.direction) for d in tuner.decisions])
    assert got["repro_torch"] == got["repro"]
    summary, stripe_replans, _replans, _decisions = got["repro"]
    assert stripe_replans >= 1 and summary[1] == 4


def test_service_striped_task_equal_across_packages(tmp_path):
    payload = np.random.default_rng(71).integers(
        0, 256, 1_500_000, dtype=np.uint8).tobytes()
    got = {}
    for name in PKGS:
        root = tmp_path / name
        root.mkdir()
        status, out = _striped_service_task(_ns(name), root, payload)
        assert status.state == "SUCCEEDED" and out == payload
        [rep] = status.item_reports
        got[name] = (rep.digest_hex, status.stripes, status.striped_chunks,
                     status.chunks_total, status.bytes_done)
    assert got["repro_torch"] == got["repro"]
    assert got["repro"][0] == fingerprint_bytes(payload).hexdigest()
    assert got["repro"][1] == 4 and got["repro"][2] > 0
