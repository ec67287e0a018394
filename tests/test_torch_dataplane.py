"""The port's integrity engine against the reference engine, on the CPU.

The same jobs — tile-aligned and ragged, with deferred source fingerprints
and one corrupted granule in each kind — go through
``repro_torch.core.dataplane.IntegrityEngine(device="cpu")`` (fused drain
through ``checksum_many_words``'s plain version) and through the reference
``repro.core.dataplane.IntegrityEngine`` with ``backend="pallas"`` (Pallas in
interpret mode) and ``backend="host"``. Verdicts and digests must be equal.
The per-job verifies — a batch of one, and jobs over ``fuse_max_bytes`` —
go through ``checksum_words``'s plain version (``device_jobs``) and must
give the reference host engine's verdicts: given and deferred source
digests, lengths that are not a multiple of 4, corrupt and short landings.
The test marked ``gpu`` runs them on the card.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import dataplane as jdp
from repro_torch.core import dataplane as tdp
# the port's tile (equal to the reference's): ``repro.kernels`` imports JAX,
# which the card's machine, where the gpu test of this file runs, lacks
from repro_torch.kernels.checksum import TILE_BYTES

KiB = 1024


class _Src:
    """View-capable source over one payload (deferred source digests)."""

    def __init__(self, data: bytes):
        self._mv = memoryview(data)

    def read_view(self, offset, length):
        return self._mv[offset:offset + length]


class _Dest:
    """Landed bytes with a zero-copy read-back view."""

    def __init__(self, data: bytes):
        self.buf = bytearray(data)

    def read_back_view(self, offset, length):
        return memoryview(self.buf)[offset:offset + length]


class _GateDest:
    """Holds the worker inside one job's read-back until ``release`` is set,
    so that every later job is queued before the worker drains again: that
    drain then fuses the whole batch, on every run."""

    def __init__(self, data: bytes):
        self._data = data
        self.entered = threading.Event()
        self.release = threading.Event()

    def read_back(self, offset, length):
        self.entered.set()
        assert self.release.wait(30.0)
        return self._data[offset:offset + length]


def _jobs():
    """(payload, job specs): 6 tile-aligned jobs, 3 ragged ones."""
    aligned, ragged = 2 * TILE_BYTES, 10_007
    specs, pos = [], 0
    for i in range(6):
        specs.append((i, pos, aligned))
        pos += aligned
    for i in range(6, 9):
        specs.append((i, pos, ragged))
        pos += ragged
    payload = np.random.default_rng(23).integers(0, 256, pos, dtype=np.uint8).tobytes()
    return payload, specs


def _run(mod, specs, payload, corrupt_at, **engine_kw):
    """Verify every job through one engine; returns verdicts and digests."""
    landed = bytearray(payload)
    for off in corrupt_at:
        landed[off] ^= 0x5A
    dest = _Dest(bytes(landed))
    src = _Src(payload)
    gate = _GateDest(payload)
    lock = threading.Lock()
    rec = {"ok": {}, "bad": {}, "err": []}

    def ok(job, _lag, _ck):
        with lock:
            rec["ok"][job.key] = (job.expected.h, job.expected.length)

    def bad(job, actual, _lag):
        with lock:
            rec["bad"][job.key] = ((job.expected.h, job.expected.length),
                                   (actual.h, actual.length))

    def err(job, exc):
        with lock:
            rec["err"].append((job.key, repr(exc)))

    eng = mod.IntegrityEngine(workers=1, batch=32, on_verified=ok, on_corrupt=bad,
                              on_error=err, **engine_kw)
    try:
        t0 = time.perf_counter()
        # the gate job is taken alone (per-job path) and holds the worker
        # until every real job is queued behind it
        eng.submit(mod.VerifyJob(key="gate", offset=0, length=16,
                                 expected=None, source=src, dest=gate,
                                 enqueued_s=t0))
        assert gate.entered.wait(30.0)
        for key, off, ln in specs:
            eng.submit(mod.VerifyJob(key=key, offset=off, length=ln, expected=None,
                                     source=src, dest=dest, enqueued_s=t0))
        gate.release.set()
        assert eng.drain(timeout=120.0)
    finally:
        eng.close()
    return rec, eng.stats


@pytest.fixture(scope="module")
def case():
    payload, specs = _jobs()
    # one flipped byte in aligned job 2 and in ragged job 7
    corrupt_at = [specs[2][1] + 4 * KiB + 3, specs[7][1] + 5_000]
    port, port_stats = _run(tdp, specs, payload, corrupt_at, device="cpu")
    return payload, specs, corrupt_at, port, port_stats


def test_port_engine_catches_each_corruption(case):
    _, specs, _, port, stats = case
    assert sorted(port["bad"]) == [2, 7]
    assert sorted(k for k in port["ok"] if k != "gate") == [0, 1, 3, 4, 5, 6, 8]
    assert port["err"] == []
    # the drain fused, and every row (landed + deferred source) went to the
    # device path: the aligned rows through checksum_many_words, the ragged
    # rows through checksum_words
    assert stats.fused_jobs == len(specs) and stats.fused_batches == 1
    assert stats.device_rows == 18 and stats.host_rows == 0
    # the gate job, taken alone, verified per job on the device path
    assert stats.device_jobs == 1 and stats.per_job == 0


@pytest.mark.parametrize("backend", ["pallas", "host"])
def test_port_engine_matches_reference_engine(case, backend):
    payload, specs, corrupt_at, port, _ = case
    ref, ref_stats = _run(jdp, specs, payload, corrupt_at, backend=backend)
    assert ref_stats.fused_jobs == len(specs)
    assert port["ok"] == ref["ok"]
    assert port["bad"] == ref["bad"]
    assert port["err"] == ref["err"] == []


def test_port_engine_host_backend_matches_device_backend(case):
    payload, specs, corrupt_at, port, _ = case
    host, stats = _run(tdp, specs, payload, corrupt_at, backend="host")
    assert host["ok"] == port["ok"] and host["bad"] == port["bad"]
    assert stats.device_rows == 0 and stats.host_rows == 18


def test_failing_kernel_poisons_the_batch_not_a_quiet_fallback(monkeypatch):
    """A kernel that raises shows up as failed verifications, never as a
    silent host digest."""
    payload, specs = _jobs()

    def boom(*_a, **_k):
        raise RuntimeError("kernel launch failed")

    from repro_torch.kernels import checksum as tck
    monkeypatch.setattr(tck, "checksum_many_words", boom)
    rec, stats = _run(tdp, specs, payload, [], device="cpu")
    assert sorted(k for k, _ in rec["err"]) == list(range(len(specs)))
    assert rec["bad"] == {} and set(rec["ok"]) == {"gate"}
    assert stats.errors == len(specs)


def test_engine_without_device_needs_a_card():
    """The default is the card: without one the engine refuses to start
    instead of running on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default engine is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdp.IntegrityEngine(on_verified=lambda *a: None, on_corrupt=lambda *a: None)
    with pytest.raises(ValueError):
        tdp.IntegrityEngine(on_verified=lambda *a: None, on_corrupt=lambda *a: None,
                            backend="pallas")


# ---------------------------------------------------------------------------
# per-job verifies: a batch of one and oversize jobs, on the device path
# ---------------------------------------------------------------------------
def _single_jobs():
    """(payload, landed, jobs): one job per case — tile-aligned with its
    digest given, deferred source digest, a length not a multiple of 4, a
    corrupt landing (given and deferred), oversize (over a 3-tile
    fuse_max_bytes), oversize and corrupt, and a short read-back."""
    from repro.core.integrity import fingerprint_bytes
    lengths = [2 * TILE_BYTES, 2 * TILE_BYTES, 10_007, TILE_BYTES, 5_001,
               5 * TILE_BYTES, 4 * TILE_BYTES + 13, 3 * TILE_BYTES + 2]
    deferred = [False, True, True, False, True, True, False, True]
    payload = np.random.default_rng(31).integers(
        0, 256, sum(lengths), dtype=np.uint8).tobytes()
    landed = bytearray(payload)
    jobs, pos = [], 0
    for key, (ln, dfr) in enumerate(zip(lengths, deferred)):
        want = None if dfr else fingerprint_bytes(payload[pos:pos + ln])
        jobs.append((key, pos, ln, want))
        pos += ln
    for key in (3, 4, 6):                              # corrupt landings
        landed[jobs[key][1] + jobs[key][2] // 2] ^= 0x81
    return payload, bytes(landed), jobs


class _ShortDest(_Dest):
    """Landed bytes whose read-back of one job comes back short."""

    def __init__(self, data, short_at):
        super().__init__(data)
        self._short_at = short_at

    def read_back_view(self, offset, length):
        mv = super().read_back_view(offset, length)
        return mv[:-1] if offset == self._short_at else mv


def _run_single(mod, payload, landed, jobs, *, one_by_one, **engine_kw):
    """Every job through one engine: drained one by one (batches of one), or
    gated into one drain where every job is over ``fuse_max_bytes``."""
    dest = _ShortDest(landed, short_at=jobs[-1][1])
    src = _Src(payload)
    lock = threading.Lock()
    rec = {"ok": {}, "bad": {}, "err": []}

    def ok(job, _lag, _ck):
        with lock:
            rec["ok"][job.key] = (job.expected.h, job.expected.length)

    def bad(job, actual, _lag):
        with lock:
            rec["bad"][job.key] = ((job.expected.h, job.expected.length),
                                   (actual.h, actual.length))

    def err(job, exc):
        with lock:
            rec["err"].append((job.key, type(exc).__name__))

    def conv(d):          # each engine verifies against its own Digest type
        return None if d is None else mod.Digest(tuple(d.h), d.length)

    eng = mod.IntegrityEngine(workers=1, batch=32, fuse_max_bytes=1, on_verified=ok,
                              on_corrupt=bad, on_error=err, **engine_kw)
    try:
        gate = _GateDest(payload)
        if not one_by_one:
            eng.submit(mod.VerifyJob(key="gate", offset=0, length=16, expected=None,
                                     source=src, dest=gate, enqueued_s=time.perf_counter()))
            assert gate.entered.wait(30.0)
        for key, off, ln, want in jobs:
            eng.submit(mod.VerifyJob(key=key, offset=off, length=ln, expected=conv(want),
                                     source=src, dest=dest, enqueued_s=time.perf_counter()))
            if one_by_one:
                assert eng.drain(timeout=60.0)
        gate.release.set()
        assert eng.drain(timeout=60.0)
    finally:
        eng.close()
    rec["ok"].pop("gate", None)
    return rec, eng.stats


@pytest.mark.parametrize("one_by_one", [True, False], ids=["batch_of_one", "oversize"])
def test_per_job_device_verdicts_match_reference_host(one_by_one):
    """Per-job verifies on the device path (``device_jobs``) give the
    reference host engine's verdicts and digests, case by case."""
    payload, landed, jobs = _single_jobs()
    port, stats = _run_single(tdp, payload, landed, jobs, one_by_one=one_by_one,
                              device="cpu")
    ref, ref_stats = _run_single(jdp, payload, landed, jobs, one_by_one=one_by_one,
                                 backend="host")
    assert port == ref
    assert sorted(port["ok"]) == [0, 1, 2, 5]
    assert sorted(port["bad"]) == [3, 4, 6, 7]          # 7: short read-back
    assert port["err"] == []
    gate = 0 if one_by_one else 1
    assert stats.device_jobs == len(jobs) + gate and stats.per_job == 0
    assert stats.fused_jobs == 0 and stats.device_rows == stats.host_rows == 0
    assert ref_stats.fused_jobs == 0 and ref_stats.verified == 4 + gate
    host, host_stats = _run_single(tdp, payload, landed, jobs, one_by_one=one_by_one,
                                   backend="host")
    assert host == port
    assert host_stats.per_job == len(jobs) + gate and host_stats.device_jobs == 0


def test_failing_kernel_routes_the_per_job_verify_to_on_error(monkeypatch):
    """A per-job verify whose kernel raises reaches ``on_error``: no quiet
    host digest, no verdict."""
    from repro_torch.kernels import checksum as tck

    def boom(*_a, **_k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(tck, "checksum_words", boom)
    payload, landed, jobs = _single_jobs()
    rec, stats = _run_single(tdp, payload, landed, jobs, one_by_one=True, device="cpu")
    assert rec["ok"] == {} and rec["bad"] == {}
    assert sorted(k for k, _ in rec["err"]) == list(range(len(jobs)))
    assert stats.errors == len(jobs) and stats.device_jobs == 0 and stats.per_job == 0


@pytest.mark.gpu
def test_cuda_per_job_verify_on_the_card():
    """Oversize jobs verified one by one by ``checksum_words`` on the card,
    staged through pinned memory: the host engine's verdicts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import checksum as tck

    payload, landed, jobs = _single_jobs()
    tck.reset_launch_counts()
    card, stats = _run_single(tdp, payload, landed, jobs, one_by_one=False, device="cuda")
    launched = tck.launch_counts()["checksum_words"]
    host, _ = _run_single(tdp, payload, landed, jobs, one_by_one=False, backend="host")
    assert card == host
    assert stats.device_jobs == len(jobs) + 1 and stats.per_job == 0
    # one launch a landing, one more a deferred source digest (gate included)
    assert launched == len(jobs) + 1 + sum(1 for j in jobs if j[3] is None) + 1
