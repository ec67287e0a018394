"""Crash-consistency of the port's chunk journal and service task log,
against the reference's.

Every test of ``tests/test_journal_recovery.py`` runs here on the port:
replay keeps every self-checked record, truncates only the torn tail after
the last verified one and leaves the file appendable; a damaged line
mid-file loses only that record; a record this version cannot interpret
stops replay without truncating; ``faults.tear_journal_tail`` tears
deterministically; the task store repairs its shard logs; and a journaled
transfer (``device="cpu"``) torn and restarted re-moves nothing journaled.

Then the checks across packages: on the same torn or damaged journal and
task-store files (torn by the port's ``tear_journal_tail``), both packages'
replays keep the same records, truncate at the same byte and leave a file
that the other package appends to and replays. The reference is imported
inside the tests, so the card's machine, which has no JAX, can collect
this file.
"""
import functools
import importlib
import json
import os
import pathlib
import shutil
from types import SimpleNamespace

import numpy as np
import pytest

from repro_torch.core import BufferDest, BufferSource
from repro_torch.core import ChunkedTransfer as _PortTransfer
from repro_torch.core.integrity import fingerprint_bytes
from repro_torch.core.journal import ChunkJournal, JournalRecord
from repro_torch.faults import tear_journal_tail
from repro_torch.service.store import TaskStore
from repro_torch.service.task import TaskSpec, TransferItem

PKGS = ("repro", "repro_torch")
ChunkedTransfer = functools.partial(_PortTransfer, device="cpu")


@functools.lru_cache(maxsize=None)
def _ns(name: str) -> SimpleNamespace:
    journal = importlib.import_module(f"{name}.core.journal")
    return SimpleNamespace(
        name=name, ChunkJournal=journal.ChunkJournal, JournalRecord=journal.JournalRecord,
        fingerprint_bytes=importlib.import_module(f"{name}.core.integrity").fingerprint_bytes,
        TaskStore=importlib.import_module(f"{name}.service.store").TaskStore,
        TaskSpec=importlib.import_module(f"{name}.service.task").TaskSpec,
        TransferItem=importlib.import_module(f"{name}.service.task").TransferItem,
    )


def _write_journal(path, n=3, ns=None):
    rec, fp, jcls = ((JournalRecord, fingerprint_bytes, ChunkJournal) if ns is None
                     else (ns.JournalRecord, ns.fingerprint_bytes, ns.ChunkJournal))
    j = jcls(path)
    for i in range(n):
        j.append(rec(i, i * 100, 100, fp(bytes([i]) * 100).hexdigest()))
    j.close()


def test_truncation_at_every_byte_of_last_record(tmp_path):
    ref = tmp_path / "ref.journal"
    _write_journal(ref, n=3)
    raw = ref.read_bytes()
    lines = raw.splitlines(keepends=True)
    last_start = len(raw) - len(lines[-1])

    for cut in range(last_start, len(raw)):
        p = tmp_path / f"cut{cut}.journal"
        shutil.copyfile(ref, p)
        with open(p, "r+b") as fh:
            fh.truncate(cut)
        j = ChunkJournal(p)
        assert set(j.records) == {0, 1}, cut
        assert j.torn_tail_bytes == (cut - last_start)
        assert os.path.getsize(p) == last_start
        j.append(JournalRecord(7, 700, 100, fingerprint_bytes(b"z" * 100).hexdigest()))
        j.close()
        j2 = ChunkJournal(p)
        assert set(j2.records) == {0, 1, 7}, cut
        assert j2.torn_tail_bytes == 0
        j2.close()


def test_garbled_mid_file_record_skipped_without_data_loss(tmp_path):
    p = tmp_path / "j.journal"
    _write_journal(p, n=4)
    lines = p.read_bytes().splitlines(keepends=True)
    corrupt = bytearray(lines[1])
    corrupt[len(corrupt) // 2] ^= 0xFF
    raw = lines[0] + bytes(corrupt) + b"".join(lines[2:])
    p.write_bytes(raw)
    j = ChunkJournal(p)
    assert set(j.records) == {0, 2, 3}
    assert j.torn_tail_bytes == 0
    j.close()
    assert p.read_bytes() == raw


def test_legacy_glued_line_tolerated(tmp_path):
    p = tmp_path / "j.journal"
    _write_journal(p, n=2)
    j = ChunkJournal(p)
    j._fh.write('{"body": {"chunk_index": 9, "off')
    j._fh.flush()
    j.append(JournalRecord(5, 500, 100,
                           fingerprint_bytes(b"g" * 100).hexdigest()))
    j.append(JournalRecord(6, 600, 100,
                           fingerprint_bytes(b"h" * 100).hexdigest()))
    j.close()
    j2 = ChunkJournal(p)
    assert set(j2.records) == {0, 1, 6}
    j2.close()


def test_trailing_failed_self_check_record_dropped(tmp_path):
    p = tmp_path / "j.journal"
    _write_journal(p, n=2)
    body = {"chunk_index": 9, "offset": 900, "length": 100,
            "digest_hex": fingerprint_bytes(b"q" * 100).hexdigest(), "status": "done"}
    with open(p, "a", encoding="utf-8") as fh:
        fh.write(json.dumps({"body": body, "check": "0" * 16}) + "\n")
    j = ChunkJournal(p)
    assert set(j.records) == {0, 1}
    j.close()


def _future_record_line() -> str:
    from repro_torch.core.journal import _self_check

    body = {"chunk_index": 5, "offset": 500, "length": 100,
            "digest_hex": fingerprint_bytes(b"n" * 100).hexdigest(),
            "status": "done", "field_from_the_future": 1}
    return json.dumps(
        {"body": body, "check": _self_check(json.dumps(body, sort_keys=True))}) + "\n"


def test_semantic_apply_failure_stops_replay_without_truncation(tmp_path):
    p = tmp_path / "j.journal"
    _write_journal(p, n=2)
    with open(p, "a", encoding="utf-8") as fh:
        fh.write(_future_record_line())
    raw = p.read_bytes()
    j = ChunkJournal(p)
    assert set(j.records) == {0, 1}
    assert j.torn_tail_bytes == 0
    j.close()
    assert p.read_bytes()[: len(raw)] == raw


def test_tear_journal_tail_helper(tmp_path):
    p = tmp_path / "j.journal"
    _write_journal(p, n=3)
    size = os.path.getsize(p)
    removed = tear_journal_tail(p, seed=5)
    assert removed > 0 and os.path.getsize(p) == size - removed
    data = (tmp_path / "j.journal").read_bytes()
    assert not data.endswith(b"\n")
    j = ChunkJournal(p)
    assert set(j.records) == {0, 1}
    assert j.torn_tail_bytes > 0
    j.close()
    q = tmp_path / "k.journal"
    _write_journal(q, n=3)
    assert tear_journal_tail(q, seed=5) == removed


def _task_log(root, ns=None):
    """A task store with one task submitted and activated; returns its shard
    log's path and bytes."""
    store_cls, spec_cls, item_cls = ((TaskStore, TaskSpec, TransferItem) if ns is None
                                     else (ns.TaskStore, ns.TaskSpec, ns.TransferItem))
    store = store_cls(root)
    spec = spec_cls(task_id="task-000000000-a", tenant="a", label="",
                    items=(item_cls("s", "d", 10),), submitted_s=1.5)
    store.append_submit(spec)
    store.append_state("task-000000000-a", "ACTIVE")
    store.close()
    [log] = [pathlib.Path(p) for p in store.shard_paths() if os.path.getsize(p) > 0]
    return log, log.read_bytes()


def test_task_store_torn_tail_truncated_and_appendable(tmp_path):
    root = tmp_path / "svc"
    log, good = _task_log(root)
    with open(log, "ab") as fh:
        fh.write(b'{"body": {"type": "state", "task_')
    store2 = TaskStore(root)
    assert store2.torn_tail_bytes > 0
    assert os.path.getsize(log) == len(good)
    rec = store2.records["task-000000000-a"]
    assert rec.state == "ACTIVE"
    store2.append_state("task-000000000-a", "PENDING")
    store2.close()
    store3 = TaskStore(root)
    assert store3.records["task-000000000-a"].state == "PENDING"
    assert store3.torn_tail_bytes == 0
    store3.close()


def test_intact_journal_unchanged_by_replay(tmp_path):
    p = tmp_path / "j.journal"
    _write_journal(p, n=5)
    raw = p.read_bytes()
    j = ChunkJournal(p)
    assert set(j.records) == set(range(5)) and j.torn_tail_bytes == 0
    j.close()
    assert p.read_bytes() == raw


class _Crash(Exception):
    pass


def _dest(mod, buf):
    """A ``mod.BufferDest`` over the shared bytearray ``buf``."""
    dst = mod.BufferDest(len(buf))
    dst.buf = buf
    return dst


def _crash_then_tear(mod, transfer, payload, buf, jpath, n):
    """A journaled transfer by ``mod`` into ``buf`` that crashes half-way,
    its journal's tail torn by the port's ``tear_journal_tail``; returns the
    plan."""
    plan = mod.plan_chunks(len(payload), 4, chunk_bytes=64 * 1024, min_chunk=1,
                           max_chunk=1 << 40)
    count = {"n": 0}

    def bomb(chunk, attempt):
        count["n"] += 1
        if count["n"] > plan.n_chunks // 2:
            raise _Crash("host died")

    j = mod.ChunkJournal(jpath)
    with pytest.raises(_Crash):
        transfer(mod.BufferSource(payload), _dest(mod, buf), plan, journal=j,
                 fault_injector=bomb, max_retries=0).run()
    j.close()
    tear_journal_tail(jpath, seed=n)
    return plan


@pytest.mark.parametrize("n", [1, 2])
def test_tear_then_restart_transfer_no_rework(tmp_path, n):
    rng = np.random.default_rng(n)
    payload = rng.integers(0, 256, 512 * 1024 + 17, dtype=np.uint8).tobytes()
    jpath = tmp_path / "t.journal"
    import repro_torch.core as tc
    buf = bytearray(len(payload))
    plan = _crash_then_tear(tc, ChunkedTransfer, payload, buf, jpath, n)

    j2 = ChunkJournal(jpath)
    journaled = set(j2.records)
    assert journaled
    moved = []
    dst = BufferDest(len(payload))
    dst.buf = buf
    rep = ChunkedTransfer(BufferSource(payload), dst, plan, journal=j2,
                          fault_injector=lambda c, a: moved.append(c.index)).run()
    j2.close()
    assert not (set(moved) & journaled)
    assert rep.skipped_chunks == len(journaled)
    assert bytes(dst.buf) == payload


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------
def _replay(ns, path):
    """(records, torn bytes, size after replay) of one package's replay."""
    j = ns.ChunkJournal(path)
    try:
        recs = {i: (r.offset, r.length, r.digest_hex) for i, r in j.records.items()}
        return recs, j.torn_tail_bytes, os.path.getsize(path)
    finally:
        j.close()


def _damaged(kind, path, seed):
    """Write a 4-record journal with the port, then damage it: ``torn`` cuts
    the last line with the port's ``tear_journal_tail``, ``garbled`` flips a
    byte mid-record, ``glued`` writes a torn fragment an old appender glued a
    record onto, ``failed_check`` and ``future`` append a well-formed line
    that fails its self-check or that this version cannot interpret."""
    _write_journal(path, n=4)
    if kind == "torn":
        tear_journal_tail(path, seed=seed)
    elif kind == "garbled":
        lines = path.read_bytes().splitlines(keepends=True)
        bad = bytearray(lines[1 + seed % 2])
        bad[len(bad) // 2] ^= 0xFF
        lines[1 + seed % 2] = bytes(bad)
        path.write_bytes(b"".join(lines))
    elif kind == "glued":
        j = ChunkJournal(path)
        j._fh.write('{"body": {"chunk_index": 9, "off')
        j._fh.flush()
        j.append(JournalRecord(5, 500, 100, fingerprint_bytes(b"g" * 100).hexdigest()))
        j.append(JournalRecord(6, 600, 100, fingerprint_bytes(b"h" * 100).hexdigest()))
        j.close()
    elif kind == "failed_check":
        body = {"chunk_index": 9, "offset": 900, "length": 100,
                "digest_hex": fingerprint_bytes(b"q" * 100).hexdigest(), "status": "done"}
        with open(path, "a", encoding="utf-8") as fh:
            fh.write(json.dumps({"body": body, "check": "0" * 16}) + "\n")
    elif kind == "future":
        with open(path, "a", encoding="utf-8") as fh:
            fh.write(_future_record_line())


KINDS = ("torn", "garbled", "glued", "failed_check", "future")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_damaged_journal_replays_alike_in_both_packages(tmp_path, kind, seed):
    """The same damaged file: both replays keep the same records, truncate
    at the same byte and leave the same bytes on disk."""
    src = tmp_path / "src.journal"
    _damaged(kind, src, seed)
    got = {}
    for name in PKGS:
        p = tmp_path / f"{name}.journal"
        shutil.copyfile(src, p)
        got[name] = (_replay(_ns(name), p), p.read_bytes())
    assert got["repro_torch"] == got["repro"]


@pytest.mark.parametrize("writer, reader", [("repro", "repro_torch"),
                                            ("repro_torch", "repro")])
@pytest.mark.parametrize("kind", KINDS)
def test_repaired_journal_appendable_by_the_other_package(tmp_path, kind, writer, reader):
    """One package replays (and repairs) the damaged file and appends; the
    other replays the result and appends in turn; a third replay by the
    first agrees with the second's. A record this version cannot interpret
    stops replay in both packages, so appends after it stay unread."""
    p = tmp_path / "j.journal"
    _damaged(kind, p, seed=3)
    first, second = _ns(writer), _ns(reader)
    j = first.ChunkJournal(p)
    before = set(j.records)
    j.append(first.JournalRecord(7, 700, 100, first.fingerprint_bytes(b"z" * 100).hexdigest()))
    j.close()
    kept = before if kind == "future" else before | {7}
    j = second.ChunkJournal(p)
    assert set(j.records) == kept and j.torn_tail_bytes == 0
    j.append(second.JournalRecord(8, 800, 100,
                                  second.fingerprint_bytes(b"y" * 100).hexdigest()))
    j.close()
    assert _replay(first, p) == _replay(second, p)
    assert set(_replay(first, p)[0]) == (before if kind == "future" else before | {7, 8})


@pytest.mark.parametrize("cut", range(0, 40, 3))
def test_torn_task_log_repaired_alike_in_both_packages(tmp_path, cut):
    """A task log torn ``cut`` bytes into a fresh line's append: both stores
    truncate the same bytes, keep the same state, and the repaired log takes
    the other package's append."""
    src_root = tmp_path / "src"
    log, good = _task_log(src_root)
    frag = b'{"body": {"type": "state", "task_id": "task-000000000-a", "state": "PENDING"}'
    with open(log, "ab") as fh:
        fh.write(frag[:cut + 1])
    got = {}
    for name in PKGS:
        root = tmp_path / name
        shutil.copytree(src_root, root)
        ns = _ns(name)
        store = ns.TaskStore(root)
        mine = root / log.relative_to(src_root)
        got[name] = (store.torn_tail_bytes, store.records["task-000000000-a"].state,
                     mine.read_bytes())
        store.close()
    assert got["repro_torch"] == got["repro"]
    assert got["repro"][0] == cut + 1 and got["repro"][2] == good
    for writer, reader in (("repro", "repro_torch"), ("repro_torch", "repro")):
        root = tmp_path / writer
        store = _ns(writer).TaskStore(root)
        store.append_state("task-000000000-a", "PENDING" if writer == "repro" else "ACTIVE")
        store.close()
        back = _ns(reader).TaskStore(root)
        assert back.torn_tail_bytes == 0
        assert back.records["task-000000000-a"].state == (
            "PENDING" if writer == "repro" else "ACTIVE")
        back.close()


def test_task_logs_are_byte_identical(tmp_path):
    """The same submissions and transitions write the same shard-log bytes."""
    got = {}
    for name in PKGS:
        log, raw = _task_log(tmp_path / name, _ns(name))
        got[name] = (log.name, raw)
    assert got["repro_torch"] == got["repro"]


@pytest.mark.parametrize("seed", range(6))
def test_tear_journal_tail_cuts_alike(tmp_path, seed):
    """The port's ``tear_journal_tail`` picks the reference's cut on the same
    file and seed."""
    ref_tear = importlib.import_module("repro.faults").tear_journal_tail
    a, b = tmp_path / "a.journal", tmp_path / "b.journal"
    _write_journal(a, n=2 + seed)
    shutil.copyfile(a, b)
    assert tear_journal_tail(a, seed=seed) == ref_tear(b, seed=seed)
    assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("first, second", [("repro", "repro_torch"),
                                           ("repro_torch", "repro")])
def test_tear_then_restart_across_packages(tmp_path, first, second):
    """A transfer crashed by one package, its journal torn, restarts under
    the other without re-moving a journaled chunk."""
    payload = np.random.default_rng(5).integers(
        0, 256, 512 * 1024 + 17, dtype=np.uint8).tobytes()
    mods = {"repro": (importlib.import_module("repro.core"), None),
            "repro_torch": (importlib.import_module("repro_torch.core"), ChunkedTransfer)}
    jpath = tmp_path / "t.journal"
    buf = bytearray(len(payload))
    mod, transfer = mods[first]
    _crash_then_tear(mod, transfer or mod.ChunkedTransfer, payload, buf, jpath, 3)
    mod, transfer = mods[second]
    plan = mod.plan_chunks(len(payload), 4, chunk_bytes=64 * 1024, min_chunk=1,
                           max_chunk=1 << 40)
    j2 = mod.ChunkJournal(jpath)
    journaled = set(j2.records)
    assert journaled
    moved = []
    rep = (transfer or mod.ChunkedTransfer)(
        mod.BufferSource(payload), _dest(mod, buf), plan, journal=j2,
        fault_injector=lambda c, a: moved.append(c.index)).run()
    j2.close()
    assert not (set(moved) & journaled)
    assert rep.skipped_chunks == len(journaled)
    assert bytes(buf) == payload
