"""The port's chunked transfer engine against the reference's.

Every test of ``tests/test_transfer.py`` runs here on both packages
(``pkg`` is "repro" or "repro_torch"; the port's ``ChunkedTransfer`` and
``transfer_verified`` run with ``device="cpu"``, so every digest they take
goes through the digest kernels' plain versions): buffer and file
round trips on every pipeline mode, a transient fault retried and a
persistent one raised, a corrupt landing healed by one re-fetch, a killed
transfer restarted from its journal, a torn final journal append, the
pipelined refusal of speculation, the positional file endpoints, the
pipelined custody rule under a lagging verifier, and speculative straggler
duplication. The port's slow read-back double is its own
(``PortSlowReadBackDest``), built on the port's ``BufferDest``.

Then the checks across packages, on the same seeded payload, plan and
injector: destination bytes, file digests, retries, re-fetches, quarantine
records, skipped chunks and journals (byte for byte with one mover and one
integrity worker, as sets of records with several); a killed transfer
resumed by the other package; a torn journal repaired alike; every
refusal of ``ChunkedTransfer.__init__`` with the same type and message; the
endpoints' zero-copy reads. Counts that depend on timing (``speculated``,
``cksum_lag_s``) are checked as the reference checks them, never for
equality between the packages.

The reference is imported inside the tests (``_ns``), so the card's machine,
which has no JAX, can collect this file.
"""
import functools
import importlib
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from _doubles import SlowReadBackDest
from repro_torch.core import BufferDest as _PortBufferDest

PKGS = ("repro", "repro_torch")


class PortSlowReadBackDest(_PortBufferDest):
    """The port's ``BufferDest`` with a read-back that sleeps, forcing the
    pipelined verifier to lag movement. The zero-copy variants are pinned
    to None, as ``tests/_doubles.py`` explains: the data plane prefers them,
    and a double that inherited them would stop lagging."""

    read_back_into = None
    read_back_view = None

    def __init__(self, total_bytes: int, delay_s: float = 0.005):
        super().__init__(total_bytes)
        self.delay_s = delay_s

    def read_back(self, offset, length):
        time.sleep(self.delay_s)
        return super().read_back(offset, length)


@functools.lru_cache(maxsize=None)
def _ns(name: str) -> SimpleNamespace:
    """One package's engine surface under one set of names; the port's
    ``ChunkedTransfer`` and ``transfer_verified`` run with ``device="cpu"``."""
    core = importlib.import_module(f"{name}.core")
    journal = importlib.import_module(f"{name}.core.journal")
    engine, verified = core.ChunkedTransfer, core.transfer_verified
    slow = SlowReadBackDest
    if name == "repro_torch":
        engine = functools.partial(engine, device="cpu")
        verified = functools.partial(verified, device="cpu")
        slow = PortSlowReadBackDest
    return SimpleNamespace(
        name=name, core=core,
        BufferDest=core.BufferDest, BufferSource=core.BufferSource,
        FileDest=core.FileDest, FileSource=core.FileSource,
        ChunkJournal=core.ChunkJournal, JournalRecord=journal.JournalRecord,
        ChunkedTransfer=engine, transfer_verified=verified,
        IntegrityError=core.IntegrityError, fingerprint_bytes=core.fingerprint_bytes,
        plan_chunks=core.plan_chunks, SlowReadBackDest=slow,
    )


@pytest.fixture(params=PKGS)
def pkg(request):
    return _ns(request.param)


def _key(d):
    return (tuple(int(v) for v in d.h), int(d.length))


# ---------------------------------------------------------------------------
# the tests of tests/test_transfer.py, on both packages
# ---------------------------------------------------------------------------
@pytest.fixture
def payload(rng):
    return rng.integers(0, 256, 3 * 1024 * 1024 + 17, dtype=np.uint8).tobytes()


def make_plan(pkg, n, movers=8, chunk=256 * 1024):
    return pkg.plan_chunks(n, movers, chunk_bytes=chunk, min_chunk=1, max_chunk=1 << 40)


def test_roundtrip_buffer(pkg, payload):
    plan = make_plan(pkg, len(payload))
    dst = pkg.BufferDest(len(payload))
    rep = pkg.transfer_verified(pkg.BufferSource(payload), dst, plan,
                                expected=pkg.fingerprint_bytes(payload))
    assert bytes(dst.buf) == payload
    assert rep.skipped_chunks == 0 and rep.retries == 0
    assert rep.file_digest == pkg.fingerprint_bytes(payload)


def test_roundtrip_files(pkg, payload, tmp_path):
    src_path = tmp_path / "src.bin"
    src_path.write_bytes(payload)
    plan = make_plan(pkg, len(payload))
    dst = pkg.FileDest(tmp_path / "dst.bin", len(payload))
    pkg.transfer_verified(pkg.FileSource(src_path), dst, plan,
                          expected=pkg.fingerprint_bytes(payload))
    assert (tmp_path / "dst.bin").read_bytes() == payload


def test_transient_fault_retry(pkg, payload):
    plan = make_plan(pkg, len(payload))
    fails = {"n": 0}

    def inject(chunk, attempt):
        if chunk.index in (1, 5) and attempt == 1:
            fails["n"] += 1
            raise IOError("injected transient")

    dst = pkg.BufferDest(len(payload))
    rep = pkg.transfer_verified(pkg.BufferSource(payload), dst, plan,
                                expected=pkg.fingerprint_bytes(payload),
                                fault_injector=inject)
    assert bytes(dst.buf) == payload
    assert fails["n"] == 2 and rep.retries == 2


def test_persistent_fault_raises(pkg, payload):
    plan = make_plan(pkg, len(payload))

    def inject(chunk, attempt):
        if chunk.index == 2:
            raise IOError("dead OST")

    with pytest.raises(IOError):
        pkg.ChunkedTransfer(pkg.BufferSource(payload), pkg.BufferDest(len(payload)), plan,
                            fault_injector=inject, max_retries=2).run()


def test_corruption_detected_and_healed_by_retry(pkg, payload):
    plan = make_plan(pkg, len(payload))
    corrupted = {"n": 0}

    class FlippyDest(pkg.BufferDest):
        def write(self, offset, data):
            if offset == plan.chunks[3].offset and corrupted["n"] == 0:
                corrupted["n"] += 1
                data = bytes([data[0] ^ 0xFF]) + data[1:]   # silent bit flip
            super().write(offset, data)

    dst = FlippyDest(len(payload))
    rep = pkg.transfer_verified(pkg.BufferSource(payload), dst, plan,
                                expected=pkg.fingerprint_bytes(payload))
    assert corrupted["n"] == 1          # corruption happened...
    assert rep.retries >= 1             # ...was caught by the chunk digest...
    assert bytes(dst.buf) == payload    # ...and healed by chunk-level retry


class Bomb(Exception):
    pass


def test_journal_partial_restart(pkg, payload, tmp_path):
    plan = make_plan(pkg, len(payload))
    jpath = tmp_path / "transfer.journal"
    count = {"n": 0}

    def crash_mid_transfer(chunk, attempt):
        count["n"] += 1
        if count["n"] == 7:
            raise Bomb("host died")

    dst = pkg.BufferDest(len(payload))
    j = pkg.ChunkJournal(jpath)
    with pytest.raises(Bomb):
        pkg.ChunkedTransfer(pkg.BufferSource(payload), dst, plan, journal=j,
                            fault_injector=crash_mid_transfer, max_retries=0).run()
    j.close()

    j2 = pkg.ChunkJournal(jpath)
    done_before = len(j2.records)
    assert 0 < done_before < plan.n_chunks
    rep = pkg.ChunkedTransfer(pkg.BufferSource(payload), dst, plan, journal=j2).run()
    assert rep.skipped_chunks == done_before          # partial restart
    assert bytes(dst.buf) == payload
    assert rep.file_digest == pkg.fingerprint_bytes(payload)
    j2.close()


def _torn_journal(pkg, jpath):
    """Two records, then a torn final append (the reference's torn write)."""
    j = pkg.ChunkJournal(jpath)
    j.append(pkg.JournalRecord(0, 0, 100, pkg.fingerprint_bytes(b"x" * 100).hexdigest()))
    j.append(pkg.JournalRecord(1, 100, 100, pkg.fingerprint_bytes(b"y" * 100).hexdigest()))
    j.close()
    with open(jpath, "a") as fh:               # simulate torn final append
        fh.write('{"body": {"chunk_index": 2, "off')


def test_journal_survives_torn_write(pkg, tmp_path):
    jpath = tmp_path / "j.journal"
    _torn_journal(pkg, jpath)
    j2 = pkg.ChunkJournal(jpath)
    assert set(j2.records) == {0, 1}
    j2.close()


@pytest.mark.parametrize("mode", ["single_pass", "pipelined"])
def test_roundtrip_pipeline_modes_buffer(pkg, payload, mode):
    plan = make_plan(pkg, len(payload))
    dst = pkg.BufferDest(len(payload))
    rep = pkg.transfer_verified(pkg.BufferSource(payload), dst, plan,
                                expected=pkg.fingerprint_bytes(payload), pipeline=mode)
    assert bytes(dst.buf) == payload
    assert rep.pipeline == mode
    assert rep.file_digest == pkg.fingerprint_bytes(payload)
    if mode == "pipelined":
        assert rep.cksum_lag_s > 0.0      # verification ran off the mover path


@pytest.mark.parametrize("mode", ["serial", "single_pass", "pipelined"])
def test_roundtrip_pipeline_modes_files(pkg, payload, tmp_path, mode):
    src_path = tmp_path / "src.bin"
    src_path.write_bytes(payload)
    plan = make_plan(pkg, len(payload))
    dst = pkg.FileDest(tmp_path / f"dst-{mode}.bin", len(payload))
    pkg.transfer_verified(pkg.FileSource(src_path), dst, plan,
                          expected=pkg.fingerprint_bytes(payload), pipeline=mode)
    assert (tmp_path / f"dst-{mode}.bin").read_bytes() == payload


def test_pipelined_rejects_speculation(pkg, payload):
    plan = make_plan(pkg, len(payload))
    with pytest.raises(ValueError, match="serial verification"):
        pkg.ChunkedTransfer(pkg.BufferSource(payload), pkg.BufferDest(len(payload)), plan,
                            pipeline="pipelined", speculative_factor=1.0)


def test_zero_copy_file_endpoints(pkg, payload, tmp_path):
    """read_into/read_back_into move bytes positionally (os.pread/os.preadv):
    concurrent movers on ONE file must neither serialize nor misread."""
    src_path = tmp_path / "src.bin"
    src_path.write_bytes(payload)
    src = pkg.FileSource(src_path)
    view = memoryview(bytearray(4099))
    assert src.read_into(17, view) == 4099
    assert bytes(view) == payload[17 : 17 + 4099]
    dst = pkg.FileDest(tmp_path / "dst.bin", len(payload))
    dst.write(100, payload[100:300])
    back = memoryview(bytearray(200))
    assert dst.read_back_into(100, back) == 200
    assert bytes(back) == payload[100:300]
    src.close()
    dst.close()


def test_pipelined_custody_kill_restart_lagging_verifier(pkg, payload, tmp_path):
    """Crash mid-transfer with verification lagging N chunks behind movement:
    the journal must hold ONLY verified chunks, and the restart must re-move
    exactly the unverified ones — 0 re-moved journaled-and-verified chunks."""
    plan = make_plan(pkg, len(payload), movers=4)
    jpath = tmp_path / "pipelined.journal"
    lock = threading.Lock()
    count = {"n": 0}

    def crash(chunk, attempt):
        with lock:
            count["n"] += 1
            if count["n"] == 9:
                raise Bomb("host died mid-transfer")

    dst = pkg.SlowReadBackDest(len(payload))
    j = pkg.ChunkJournal(jpath)
    with pytest.raises(Bomb):
        pkg.ChunkedTransfer(pkg.BufferSource(payload), dst, plan, journal=j,
                            fault_injector=crash, max_retries=0,
                            pipeline="pipelined", integrity_workers=1).run()
    j.close()

    j2 = pkg.ChunkJournal(jpath)
    journaled = {(r.offset, r.length) for r in j2.records.values()}
    done_before = len(j2.records)
    assert done_before < plan.n_chunks     # the crash landed mid-flight
    moved = []

    def record(chunk, attempt):
        with lock:
            moved.append((chunk.offset, chunk.length))

    rep = pkg.ChunkedTransfer(pkg.BufferSource(payload), dst, plan, journal=j2,
                              fault_injector=record, pipeline="pipelined").run()
    j2.close()
    assert rep.skipped_chunks == done_before       # partial restart honored
    # custody rule: nothing the first run journaled (== verified) was re-moved
    re_moved = [m for m in set(moved)
                if any(m[0] < jo + jl and jo < m[0] + m[1]
                       for jo, jl in journaled)]
    assert re_moved == []
    assert bytes(dst.buf) == payload
    assert rep.file_digest == pkg.fingerprint_bytes(payload)


def test_speculative_straggler_duplication(pkg, payload):
    plan = make_plan(pkg, len(payload), movers=4)

    def slow_chunk(chunk, attempt):
        if chunk.index == plan.n_chunks - 1:
            time.sleep(0.05)                   # straggler

    dst = pkg.BufferDest(len(payload))
    pkg.ChunkedTransfer(pkg.BufferSource(payload), dst, plan,
                        fault_injector=slow_chunk, speculative_factor=1.0).run()
    assert bytes(dst.buf) == payload


# ---------------------------------------------------------------------------
# speculation, without wall time: the straggler waits for its own twin
# ---------------------------------------------------------------------------
def _twin_straggler(last: int):
    """A fault injector whose straggler (chunk ``last``) blocks its first
    attempt until a speculated twin of it starts: the twin lands first on
    every run, however the threads are scheduled. Returns (injector,
    calls), ``calls[i]`` the attempts chunk i began."""
    lock = threading.Lock()
    twin = threading.Event()
    calls: dict[int, int] = {}

    def inject(chunk, attempt):
        with lock:
            calls[chunk.index] = calls.get(chunk.index, 0) + 1
            first = calls[chunk.index] == 1
        if chunk.index != last:
            return
        if first:
            assert twin.wait(timeout=60), "no speculated twin of the straggler started"
        else:
            twin.set()

    return inject, calls


def test_speculation_duplicates_the_straggler(pkg, payload):
    plan = make_plan(pkg, len(payload), movers=4)
    last = plan.n_chunks - 1
    inject, calls = _twin_straggler(last)
    dst = pkg.BufferDest(len(payload))
    rep = pkg.ChunkedTransfer(pkg.BufferSource(payload), dst, plan,
                              fault_injector=inject, speculative_factor=1.0).run()
    assert bytes(dst.buf) == payload
    assert rep.file_digest == pkg.fingerprint_bytes(payload)
    assert rep.speculated >= 1 and calls[last] == 2 and rep.retries == 0
    assert rep.outcomes[last].attempts == 1    # the twin's outcome, first to land


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------
XPAYLOAD = 1024 * 1024 + 12345      # four 256 KiB chunks and a ragged tail


@pytest.fixture(scope="module")
def xpayload():
    return np.random.default_rng(31).integers(0, 256, XPAYLOAD, dtype=np.uint8).tobytes()


def _ref_fp(data):
    return importlib.import_module("repro.core.integrity").fingerprint_bytes(data)


def _records(path):
    j = importlib.import_module("repro.core.journal").ChunkJournal(path)
    try:
        return {(i, r.offset, r.length, r.digest_hex) for i, r in j.records.items()}
    finally:
        j.close()


def _plans_equal(a, b):
    return ((a.total_bytes, a.chunk_bytes, a.movers, a.pipeline_depth)
            == (b.total_bytes, b.chunk_bytes, b.movers, b.pipeline_depth)
            and [(c.index, c.offset, c.length, c.mover) for c in a.chunks]
            == [(c.index, c.offset, c.length, c.mover) for c in b.chunks])


def _run(ns, payload, root, *, mode="serial", endpoint="buffer", movers=1,
         integrity_workers=1, injector=None, dest=None, journal=True, **kw):
    """One journaled transfer by package ``ns``. Returns (report, destination
    bytes, journal path)."""
    os.makedirs(root, exist_ok=True)
    plan = make_plan(ns, len(payload), movers=movers)
    jpath = os.path.join(root, "x.journal")
    j = ns.ChunkJournal(jpath) if journal else None
    if endpoint == "file":
        spath, dpath = os.path.join(root, "src.bin"), os.path.join(root, "dst.bin")
        with open(spath, "wb") as fh:
            fh.write(payload)
        src, dst = ns.FileSource(spath), ns.FileDest(dpath, len(payload))
    else:
        src, dst = ns.BufferSource(payload), (dest or ns.BufferDest)(len(payload))
    try:
        rep = ns.ChunkedTransfer(src, dst, plan, journal=j, pipeline=mode,
                                 integrity_workers=integrity_workers,
                                 fault_injector=injector, **kw).run()
    finally:
        if j is not None:
            j.close()
        if endpoint == "file":
            src.close()
            dst.close()
    if endpoint == "file":
        with open(dpath, "rb") as fh:
            out = fh.read()
    else:
        out = bytes(dst.buf)
    return rep, out, jpath


def _summary(rep):
    return {
        "digest": _key(rep.file_digest), "retries": rep.retries,
        "refetches": rep.refetches, "skipped": rep.skipped_chunks,
        "pipeline": rep.pipeline, "speculated_is_zero": rep.speculated == 0,
        "outcomes": sorted((i, o.chunk.offset, o.chunk.length, _key(o.digest))
                           for i, o in rep.outcomes.items()),
        "quarantined": sorted((q.chunk_index, q.offset, q.length, q.attempt,
                               q.expected_hex, q.actual_hex, q.detail)
                              for q in rep.quarantined),
    }


def test_plans_equal_across_packages(xpayload):
    for movers in (1, 3, 4, 8):
        a, b = (make_plan(_ns(n), len(xpayload), movers=movers) for n in PKGS)
        assert _plans_equal(a, b)


@pytest.mark.parametrize("endpoint", ["buffer", "file"])
@pytest.mark.parametrize("mode", ["serial", "single_pass", "pipelined"])
def test_journals_byte_identical_across_packages(xpayload, tmp_path, mode, endpoint):
    """One mover and one integrity worker: chunks land, verify and journal
    in plan order, so both packages write the same journal bytes, the same
    destination and the same report."""
    got = {}
    for name in PKGS:
        rep, out, jpath = _run(_ns(name), xpayload, str(tmp_path / name), mode=mode,
                               endpoint=endpoint)
        with open(jpath, "rb") as fh:
            got[name] = (_summary(rep), out, fh.read())
    assert got["repro_torch"] == got["repro"]
    summary, out, raw = got["repro"]
    assert out == xpayload and summary["digest"] == _key(_ref_fp(xpayload))
    assert len(raw.splitlines()) == 5


@pytest.mark.parametrize("mode", ["serial", "single_pass", "pipelined"])
def test_several_movers_equal_records_across_packages(xpayload, tmp_path, mode):
    """Four movers, two integrity workers: equal reports and equal sets of
    journal records (the lines' order follows the threads)."""
    got = {}
    for name in PKGS:
        rep, out, jpath = _run(_ns(name), xpayload, str(tmp_path / name), mode=mode,
                               movers=4, integrity_workers=2)
        assert out == xpayload
        got[name] = (_summary(rep), _records(jpath))
    assert got["repro_torch"] == got["repro"]


def _transient(chunk, attempt):
    if chunk.index in (1, 3) and attempt == 1:
        raise IOError("injected transient")


def test_transient_faults_equal_across_packages(xpayload, tmp_path):
    got = {}
    for name in PKGS:
        rep, out, jpath = _run(_ns(name), xpayload, str(tmp_path / name),
                               injector=_transient)
        with open(jpath, "rb") as fh:
            got[name] = (_summary(rep), out, fh.read())
    assert got["repro_torch"] == got["repro"]
    assert got["repro"][0]["retries"] == 2 and got["repro"][1] == xpayload


def test_persistent_fault_refused_alike(xpayload, tmp_path):
    """A chunk that always fails: both packages raise the injector's error
    after the same attempts, and journal the same chunks (one mover)."""
    got = {}
    for name in PKGS:
        attempts = []

        def dead(chunk, attempt, attempts=attempts):
            if chunk.index == 2:
                attempts.append(attempt)
                raise IOError("dead OST")

        with pytest.raises(IOError) as info:
            _run(_ns(name), xpayload, str(tmp_path / name), injector=dead, max_retries=2)
        got[name] = (type(info.value).__name__, str(info.value), attempts,
                     _records(str(tmp_path / name / "x.journal")))
    assert got["repro_torch"] == got["repro"]
    assert got["repro"][2] == [1, 2, 3] and len(got["repro"][3]) == 2


def _flippy(ns, target):
    flips = []

    class FlippyDest(ns.BufferDest):
        def write(self, offset, data):
            if offset == target and not flips:
                flips.append(offset)
                data = bytes([data[0] ^ 0xFF]) + bytes(data[1:])
            super().write(offset, data)

    return FlippyDest, flips


@pytest.mark.parametrize("mode", ["serial", "single_pass", "pipelined"])
def test_corruption_healed_alike(xpayload, tmp_path, mode):
    """One flipped landing of chunk 2: one quarantine record and one
    re-fetch in both packages, the same record, the same journal."""
    got = {}
    for name in PKGS:
        ns = _ns(name)
        target = make_plan(ns, len(xpayload), movers=1).chunks[2].offset
        dest, flips = _flippy(ns, target)
        rep, out, jpath = _run(ns, xpayload, str(tmp_path / name), mode=mode, dest=dest)
        assert flips == [target] and out == xpayload
        with open(jpath, "rb") as fh:
            got[name] = (_summary(rep), fh.read())
    assert got["repro_torch"] == got["repro"]
    summary = got["repro"][0]
    assert summary["refetches"] == 1 and len(summary["quarantined"]) == 1
    assert summary["quarantined"][0][0] == 2


def _bomb_at(n):
    lock = threading.Lock()
    count = {"n": 0}

    def crash(chunk, attempt):
        with lock:
            count["n"] += 1
            if count["n"] == n:
                raise Bomb("host died")

    return crash


@pytest.mark.parametrize("mode", ["serial", "pipelined"])
@pytest.mark.parametrize("first, second", [("repro", "repro_torch"),
                                           ("repro_torch", "repro")])
def test_kill_restart_across_packages(tmp_path, first, second, mode):
    """A transfer killed at its 7th mover call (one mover) by one package is
    resumed by the other from the journal: the journaled chunks are skipped,
    none of their bytes moves again, and the destination, the digest and
    the journal's records equal an uninterrupted run's."""
    payload = np.random.default_rng(41).integers(0, 256, 2 * 1024 * 1024 + 99,
                                                  dtype=np.uint8).tobytes()
    buf = bytearray(len(payload))
    jpath = str(tmp_path / "k.journal")

    ns = _ns(first)
    plan = make_plan(ns, len(payload), movers=1)
    dst = ns.SlowReadBackDest(len(payload))
    dst.buf = buf
    j = ns.ChunkJournal(jpath)
    with pytest.raises(Bomb):
        ns.ChunkedTransfer(ns.BufferSource(payload), dst, plan, journal=j,
                           fault_injector=_bomb_at(7), max_retries=0, pipeline=mode,
                           integrity_workers=1).run()
    j.close()

    ns = _ns(second)
    j2 = ns.ChunkJournal(jpath)
    journaled = {(r.offset, r.length) for r in j2.records.values()}
    assert 0 < len(journaled) < plan.n_chunks
    moved = []
    dst = ns.BufferDest(len(payload))
    dst.buf = buf
    rep = ns.ChunkedTransfer(ns.BufferSource(payload), dst, make_plan(ns, len(payload), 1),
                             journal=j2, pipeline=mode,
                             fault_injector=lambda c, _a: moved.append((c.offset, c.length))
                             ).run()
    j2.close()
    assert bytes(buf) == payload
    assert rep.file_digest == ns.fingerprint_bytes(payload)
    assert rep.skipped_chunks == len(journaled)
    assert not [m for m in set(moved)
                if any(m[0] < jo + jl and jo < m[0] + m[1] for jo, jl in journaled)]
    assert sum(n for _o, n in moved) + sum(n for _o, n in journaled) == len(payload)
    # the journal now holds every chunk, with the digests either package takes
    whole = {(c.index, c.offset, c.length, _ref_fp(payload[c.offset:c.offset + c.length])
              .hexdigest()) for c in plan.chunks}
    assert _records(jpath) == whole


@pytest.mark.parametrize("writer, reader", [("repro", "repro_torch"),
                                            ("repro_torch", "repro")])
def test_torn_journal_repaired_alike(tmp_path, writer, reader):
    """A torn final append written through one package is replayed by the
    other to the same records, and cut back to the same bytes."""
    raw = {}
    for name in PKGS:
        path = tmp_path / f"{name}.journal"
        _torn_journal(_ns(name), path)
        raw[name] = path.read_bytes()
    assert raw["repro"] == raw["repro_torch"]
    path = tmp_path / "cross.journal"
    _torn_journal(_ns(writer), path)
    j = _ns(reader).ChunkJournal(path)
    try:
        assert set(j.records) == {0, 1}
        assert j.torn_tail_bytes == len('{"body": {"chunk_index": 2, "off')
        assert [j.records[i].digest_hex for i in (0, 1)] == [
            _ref_fp(b"x" * 100).hexdigest(), _ref_fp(b"y" * 100).hexdigest()]
    finally:
        j.close()
    # the repaired file is the two whole records, and appends go on from it
    assert path.read_bytes() == raw["repro"][: raw["repro"].rindex(b"\n") + 1]


def test_speculation_equal_across_packages(xpayload, tmp_path):
    """The twin-gated straggler on both packages, journaled: the same
    destination, digest and journal records; ``speculated`` >= 1 in each
    (its exact count follows the threads)."""
    got = {}
    for name in PKGS:
        ns = _ns(name)
        last = make_plan(ns, len(xpayload), movers=4).n_chunks - 1
        inject, calls = _twin_straggler(last)
        rep, out, jpath = _run(ns, xpayload, str(tmp_path / name), movers=4,
                               injector=inject, speculative_factor=1.0)
        assert rep.speculated >= 1 and calls[last] == 2
        got[name] = (out, _key(rep.file_digest), rep.retries, rep.skipped_chunks,
                     _records(jpath))
    assert got["repro_torch"] == got["repro"]
    assert got["repro"][0] == xpayload


REFUSALS = {
    "pipelined-speculation": dict(pipeline="pipelined", speculative_factor=1.0),
    "tuner-speculation": dict(tuner=object(), speculative_factor=0.5),
    "stripes-speculation": dict(stripes=2, speculative_factor=1.0),
    "unknown-pipeline": dict(pipeline="eager"),
    "no-integrity-workers": dict(integrity_workers=0),
    "no-stripes": dict(stripes=0),
    "no-stripe-bytes": dict(stripe_min_bytes=0),
    "source-size": dict(short_source=True),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_constructor_refusals_equal_across_packages(xpayload, case):
    """Each refusal of ``ChunkedTransfer.__init__`` raises in both packages,
    with the same type and message."""
    got = {}
    for name in PKGS:
        ns = _ns(name)
        kw = dict(REFUSALS[case])
        data = xpayload[:-1] if kw.pop("short_source", False) else xpayload
        with pytest.raises(ValueError) as info:
            ns.ChunkedTransfer(ns.BufferSource(data), ns.BufferDest(len(xpayload)),
                               make_plan(ns, len(xpayload)), **kw)
        got[name] = (type(info.value).__name__, str(info.value))
    assert got["repro_torch"] == got["repro"]


def test_end_to_end_mismatch_refused_alike(xpayload):
    """``transfer_verified`` against a wrong expected digest: the same
    ``IntegrityError`` message in both packages."""
    got = {}
    for name in PKGS:
        ns = _ns(name)
        wrong = ns.fingerprint_bytes(xpayload[:-1] + b"\x00")
        with pytest.raises(ns.IntegrityError) as info:
            ns.transfer_verified(ns.BufferSource(xpayload), ns.BufferDest(len(xpayload)),
                                 make_plan(ns, len(xpayload), movers=2), expected=wrong)
        got[name] = str(info.value)
    assert got["repro_torch"] == got["repro"]
    assert "end-to-end digest mismatch" in got["repro"]


def test_endpoints_read_alike(xpayload, tmp_path):
    """The endpoints' reads, zero-copy and vectored, return the same bytes
    and counts in both packages, past the end of the file too."""
    spath = tmp_path / "src.bin"
    spath.write_bytes(xpayload)
    n = len(xpayload)
    got = {}
    for name in PKGS:
        ns = _ns(name)
        out = []
        fsrc, bsrc = ns.FileSource(spath), ns.BufferSource(xpayload)
        dst = ns.FileDest(tmp_path / f"{name}.bin", n)
        bdst = ns.BufferDest(n)
        try:
            for src in (fsrc, bsrc):
                for off, ln in ((0, 4096), (17, 4099), (n - 100, 4096)):
                    view = memoryview(bytearray(ln))
                    out.append((src.read_into(off, view), bytes(view)))
                    out.append(src.read(off, ln))
            out.append(bytes(bsrc.read_view(5, 300)))
            views = [memoryview(bytearray(1000)), memoryview(bytearray(3000))]
            out.append((fsrc.readv_into(123, views), [bytes(v) for v in views]))
            for d in (dst, bdst):
                d.write(100, xpayload[100:5000])
                back = memoryview(bytearray(4900))
                out.append((d.read_back_into(100, back), bytes(back)))
                out.append(d.read_back(100, 4900))
            out.append(dst.writev(8000, [memoryview(xpayload[8000:9000]),
                                         memoryview(xpayload[9000:12000])]))
            out.append(dst.read_back(8000, 4000))
            out.append(bytes(bdst.read_back_view(100, 4900)))
        finally:
            fsrc.close()
            dst.close()
        got[name] = out
    assert got["repro_torch"] == got["repro"]
    assert got["repro"][1] == xpayload[:4096]
    assert got["repro"][4][0] == 100          # a read past the end is short
