"""The port's integrity engine against the reference engine, on the CPU.

The same jobs — tile-aligned and ragged, with deferred source fingerprints
and one corrupted granule in each kind — go through
``repro_torch.core.dataplane.IntegrityEngine(device="cpu")`` (fused drain
through ``checksum_many_words``'s plain version) and through the reference
``repro.core.dataplane.IntegrityEngine`` with ``backend="pallas"`` (Pallas in
interpret mode) and ``backend="host"``. Verdicts and digests must be equal.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import dataplane as jdp
from repro.kernels.checksum import TILE_BYTES
from repro_torch.core import dataplane as tdp

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
    # the drain fused, and the aligned rows (landed + deferred source) went
    # through checksum_many_words, the ragged rows to the host stack
    assert stats.fused_jobs == len(specs) and stats.fused_batches == 1
    assert stats.device_rows == 12 and stats.host_rows == 6
    assert stats.per_job == 1


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
