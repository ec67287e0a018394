"""The port's content-addressed chunk index and delta checkpoints, against
the reference's.

The index legs of ``tests/test_cas.py`` (semantics, replay and compaction
properties, torn-tail repair at every byte, garbled lines, stale backing,
seeding from a MANIFEST) and its service-dedup and delta-checkpoint legs run
here on both packages (``pkg`` is "repro" or "repro_torch"; the port's
service runs with ``device="cpu"``). Across packages: an index log written
by one package replays in the other, and a delta save by the port restores
bit-equal to a full save of the same state by either package. The reference
is imported inside the tests (``_ns``), so the card's machine, which has no
JAX, can collect this file.
"""
import functools
import importlib
import json
import os
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypofallback import given, settings, strategies as st

from repro_torch.ckpt import restore_checkpoint, save_checkpoint
from repro_torch.service import BatchConfig, ServiceConfig, TransferService, submit_checkpoint

PKGS = ("repro", "repro_torch")


@functools.lru_cache(maxsize=None)
def _ns(name: str) -> SimpleNamespace:
    """One package's content plane and service under one set of names. The
    port's ``TransferService`` and ``ChunkIndex`` are bound to
    ``device="cpu"``."""
    svc = importlib.import_module(f"{name}.service")
    cas = importlib.import_module(f"{name}.cas")
    svc_cls, index_cls = svc.TransferService, cas.ChunkIndex
    if name == "repro_torch":
        svc_cls = functools.partial(svc.TransferService, device="cpu")
        index_cls = functools.partial(cas.ChunkIndex, device="cpu")
    return SimpleNamespace(
        name=name, ChunkIndex=index_cls,
        seed_index_from_manifest=cas.seed_index_from_manifest,
        TransferService=svc_cls, ServiceConfig=svc.ServiceConfig,
        BatchConfig=svc.BatchConfig,
        fingerprint_bytes=importlib.import_module(
            f"{name}.core.integrity").fingerprint_bytes,
    )


@pytest.fixture(params=PKGS)
def pkg(request):
    return _ns(request.param)


def _payload(seed: int, nbytes: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, nbytes, dtype=np.uint8).tobytes()


def _digest_hex(data: bytes) -> str:
    return _ns("repro_torch").fingerprint_bytes(data).hexdigest()


# ---------------------------------------------------------------------------
# ChunkIndex: basic semantics
# ---------------------------------------------------------------------------
def test_index_put_lookup_discard(pkg, tmp_path):
    idx = pkg.ChunkIndex(tmp_path / "cas" / "index.log")
    d = _digest_hex(b"x" * 64)
    assert idx.put(d, 64, "/data/a.bin", 0) is True
    assert idx.put(d, 64, "/data/a.bin", 0) is False
    assert idx.put(d, 64, "/data/b.bin", 128) is True
    hits = idx.lookup(d, 64)
    assert {(e.path, e.offset) for e in hits} == {("/data/a.bin", 0), ("/data/b.bin", 128)}
    assert all(e.digest_hex == d and e.length == 64 for e in hits)
    assert idx.lookup(d, 65) == ()
    assert idx.discard(d, 64, "/data/a.bin", 0) is True
    assert idx.discard(d, 64, "/data/a.bin", 0) is False
    assert idx.n_digests == 1 and idx.n_locations == 1
    assert idx.discard(d, 64, "/data/b.bin", 128) is True
    assert idx.lookup(d, 64) == ()
    assert idx.n_digests == 0
    idx.close()


# ---------------------------------------------------------------------------
# ChunkIndex: property tests (round-trip replay, compaction)
# ---------------------------------------------------------------------------
def _apply_random_ops(idx, model: dict, rnd) -> None:
    digests = [_digest_hex(bytes([i]) * 8) for i in range(4)]
    paths = ["/p/a", "/p/b", "/p/c"]
    for _ in range(rnd.randint(5, 40)):
        d = rnd.choice(digests)
        ln = rnd.choice((8, 16))
        loc = (rnd.choice(paths), rnd.choice((0, 8, 16)))
        key = (d, ln)
        if rnd.random() < 0.7:
            idx.put(d, ln, loc[0], loc[1])
            model.setdefault(key, set()).add(loc)
        else:
            idx.discard(d, ln, loc[0], loc[1])
            if key in model:
                model[key].discard(loc)
                if not model[key]:
                    del model[key]


def _as_model(entries) -> dict:
    out: dict = {}
    for e in entries:
        out.setdefault((e.digest_hex, e.length), set()).add((e.path, e.offset))
    return out


@pytest.mark.parametrize("writer,reader", [("repro", "repro_torch"),
                                           ("repro_torch", "repro"),
                                           ("repro_torch", "repro_torch")])
@settings(max_examples=10, deadline=None)
@given(st.randoms())
def test_index_replay_roundtrip_property(writer, reader, rnd):
    """Replay rebuilds the live set — also in the other package: the index
    log's bytes are the same in both."""
    with tempfile.TemporaryDirectory(prefix="cas-prop-") as td:
        path = os.path.join(td, "index.log")
        model: dict = {}
        with _ns(writer).ChunkIndex(path, fsync=False) as idx:
            _apply_random_ops(idx, model, rnd)
            live = _as_model(idx.entries())
        with _ns(reader).ChunkIndex(path) as back:
            assert back.torn_tail_bytes == 0
            assert _as_model(back.entries()) == live == model


@pytest.mark.parametrize("name", PKGS)
@settings(max_examples=10, deadline=None)
@given(st.randoms())
def test_index_compaction_preserves_live_records_property(name, rnd):
    ns = _ns(name)
    with tempfile.TemporaryDirectory(prefix="cas-gc-") as td:
        path = os.path.join(td, "index.log")
        model: dict = {}
        with ns.ChunkIndex(path) as idx:
            _apply_random_ops(idx, model, rnd)
            before = _as_model(idx.entries())
            out = idx.compact()
            assert out["bytes_after"] <= out["bytes_before"]
            assert out["records"] == sum(len(v) for v in before.values())
            assert _as_model(idx.entries()) == before == model
            d = _digest_hex(b"post-compact")
            idx.put(d, 12, "/p/post", 0)
        with ns.ChunkIndex(path) as back:
            got = _as_model(back.entries())
            assert got.pop((d, 12)) == {("/p/post", 0)}
            assert got == before


def test_index_logs_equal_across_packages(tmp_path):
    """The same puts, discards and compaction leave byte-equal index logs."""
    logs = []
    for name in PKGS:
        path = tmp_path / name / "index.log"
        with _ns(name).ChunkIndex(path) as idx:
            for i in range(6):
                idx.put(_digest_hex(bytes([i]) * 32), 32, f"/p/{i % 2}", 32 * i)
            idx.discard(_digest_hex(bytes([3]) * 32), 32, "/p/1", 96)
            first = path.read_bytes()
            idx.compact()
        logs.append((first, path.read_bytes()))
    assert logs[0] == logs[1]


def test_index_torn_tail_truncation_at_every_byte(pkg, tmp_path):
    ref = tmp_path / "ref.log"
    with pkg.ChunkIndex(ref) as idx:
        for i in range(4):
            idx.put(_digest_hex(bytes([i]) * 8), 8, f"/p/{i}", i * 8)
        full = _as_model(idx.entries())
    data = ref.read_bytes()
    cut0 = len(data) - len(data.rstrip(b"\n").rsplit(b"\n", 1)[-1]) - 1
    for cut in range(cut0 + 1, len(data)):
        p = tmp_path / f"cut{cut}.log"
        p.write_bytes(data[:cut])
        with pkg.ChunkIndex(p) as idx:
            got = _as_model(idx.entries())
            assert len(got) == 3 and all(k in full for k in got)
            assert idx.torn_tail_bytes == cut - cut0
            idx.put(_digest_hex(b"appended"), 8, "/p/new", 0)
        with pkg.ChunkIndex(p) as back:
            assert back.torn_tail_bytes == 0
            assert len(_as_model(back.entries())) == 4


def test_index_garbled_mid_file_record_skipped(pkg, tmp_path):
    p = tmp_path / "index.log"
    with pkg.ChunkIndex(p) as idx:
        idx.put(_digest_hex(b"a"), 1, "/p/a", 0)
        idx.put(_digest_hex(b"b"), 1, "/p/b", 0)
    lines = p.read_bytes().splitlines(keepends=True)
    lines.insert(1, b'{"op": "put", "garbled\n')
    p.write_bytes(b"".join(lines))
    with pkg.ChunkIndex(p) as idx:
        assert len(idx.entries()) == 2
        assert idx.torn_tail_bytes == 0


def test_verify_entry_detects_stale_backing(pkg, tmp_path):
    backing = tmp_path / "backing.bin"
    region = _payload(1, 256)
    backing.write_bytes(b"\0" * 64 + region + b"\0" * 32)
    idx = pkg.ChunkIndex(tmp_path / "index.log")
    idx.put(_digest_hex(region), 256, str(backing), 64)
    [entry] = idx.entries()
    assert idx.verify_entry(entry) == region
    with open(backing, "r+b") as fh:
        fh.seek(64 + 17)
        fh.write(b"\xff" if region[17] != 0xff else b"\x00")
    assert idx.verify_entry(entry) is None
    backing.write_bytes(b"\0" * 80)
    assert idx.verify_entry(entry) is None
    os.unlink(backing)
    assert idx.verify_entry(entry) is None
    idx.close()


def test_index_stats(pkg, tmp_path):
    path = str(tmp_path / "cas" / "index.log")
    with pkg.ChunkIndex(path) as idx:
        for i in range(6):
            idx.put(_digest_hex(bytes([i])), 100, f"/p/{i}", 0)
        for i in range(4):
            idx.discard(_digest_hex(bytes([i])), 100, f"/p/{i}", 0)
        s = idx.stats()
        assert s["digests"] == 2 and s["locations"] == 2
        assert s["indexed_bytes"] == 200
        log_before = s["log_bytes"]
        idx.compact()
        assert idx.stats()["log_bytes"] < log_before
    with pkg.ChunkIndex(path) as idx:
        assert idx.n_locations == 2


def test_seed_index_from_manifest(tmp_path):
    """A MANIFEST the port's ``save_checkpoint`` wrote seeds either
    package's index with every chunk, each verifying against the save."""
    tree = {"w": torch.arange(4096, dtype=torch.float32),
            "b": torch.arange(128, dtype=torch.float32)}
    rep = save_checkpoint(str(tmp_path / "ck"), 1, tree, chunk_bytes=4096, device="cpu")
    with open(os.path.join(rep.path, "MANIFEST.json")) as fh:
        manifest = json.load(fh)
    n_chunks = sum(len(lv["chunks"]) for lv in manifest["leaves"].values())
    for name in PKGS:
        ns = _ns(name)
        idx = ns.ChunkIndex(tmp_path / name / "index.log")
        n = ns.seed_index_from_manifest(idx, manifest, rep.path)
        assert n == n_chunks == idx.n_locations
        for entry in idx.entries():
            assert idx.verify_entry(entry) is not None
        assert ns.seed_index_from_manifest(idx, manifest, rep.path) == 0
        idx.close()


# ---------------------------------------------------------------------------
# service dedup: counters, events, per-task policy
# ---------------------------------------------------------------------------
def _service(ns, tmp_path, **over):
    cfg = dict(mover_budget=4, max_concurrent_tasks=2, chunk_bytes=16 * 1024,
               tick_s=0.002, batch=ns.BatchConfig(direct_bytes=1 << 30, batch_files=64))
    cfg.update(over)
    return ns.TransferService(str(tmp_path / "svc"), ns.ServiceConfig(**cfg))


@pytest.mark.parametrize("pipeline", ["serial", "pipelined"])
def test_service_dedup_counters_and_events(pkg, tmp_path, pipeline):
    nbytes = 64 * 1024 + 3
    payload = _payload(6, nbytes)
    src = str(tmp_path / "data.bin")
    with open(src, "wb") as fh:
        fh.write(payload)
    svc = _service(pkg, tmp_path, dedup="on", pipeline=pipeline)
    events = []
    svc.subscribe(lambda e: events.append(e))
    try:
        [t1] = svc.submit([(src, src + ".v1")], batch=False)
        st1 = svc.wait(t1, timeout=60)
        [t2] = svc.submit([(src, src + ".v2")], batch=False)
        st2 = svc.wait(t2, timeout=60)
    finally:
        svc.close()
    assert st1.state == st2.state == "SUCCEEDED"
    assert st1.chunks_deduped == 0
    assert st2.chunks_deduped == st2.chunks_total
    assert st2.wire_bytes_saved == st2.bytes_total == nbytes
    assert st2.dedup_demoted == 0
    with open(src + ".v2", "rb") as fh:
        assert fh.read() == payload
    dedup_evs = [e for e in events if e.kind == "DEDUP"]
    assert dedup_evs and dedup_evs[-1].task_id == t2
    pay = dedup_evs[-1].payload
    assert pay["chunks"] == st2.chunks_total
    assert pay["bytes_saved"] == nbytes and pay["demoted"] == 0
    assert (st1.item_reports[0].digest_hex
            == st2.item_reports[0].digest_hex == _digest_hex(payload))


def test_service_dedup_off_bypasses_index(pkg, tmp_path):
    nbytes = 48 * 1024
    payload = _payload(7, nbytes)
    src = str(tmp_path / "data.bin")
    with open(src, "wb") as fh:
        fh.write(payload)
    svc = _service(pkg, tmp_path, dedup="on")
    try:
        [t1] = svc.submit([(src, src + ".v1")], batch=False)
        svc.wait(t1, timeout=60)
        [t2] = svc.submit([(src, src + ".v2")], batch=False, dedup="off")
        st2 = svc.wait(t2, timeout=60)
    finally:
        svc.close()
    assert st2.state == "SUCCEEDED"
    assert st2.chunks_deduped == 0 and st2.wire_bytes_saved == 0
    with open(src + ".v2", "rb") as fh:
        assert fh.read() == payload


def test_service_index_log_replays_across_packages(tmp_path):
    """The reference service populates ``<root>/cas/index.log``; the port's
    service on the same root dedups a re-submission from it."""
    nbytes = 80 * 1024 + 9
    payload = _payload(12, nbytes)
    src = str(tmp_path / "data.bin")
    with open(src, "wb") as fh:
        fh.write(payload)
    ref, port = _ns("repro"), _ns("repro_torch")
    svc = _service(ref, tmp_path, dedup="on")
    try:
        [t1] = svc.submit([(src, src + ".v1")], batch=False)
        assert svc.wait(t1, timeout=60).state == "SUCCEEDED"
    finally:
        svc.close()
    svc = _service(port, tmp_path, dedup="on", pipeline="pipelined")
    try:
        [t2] = svc.submit([(src, src + ".v2")], batch=False)
        st2 = svc.wait(t2, timeout=60)
        assert svc.status(t1).state == "SUCCEEDED"      # replayed from the store
    finally:
        svc.close()
    assert st2.state == "SUCCEEDED"
    assert st2.chunks_deduped == st2.chunks_total and st2.wire_bytes_saved == nbytes
    with open(src + ".v2", "rb") as fh:
        assert fh.read() == payload


# ---------------------------------------------------------------------------
# delta checkpoints of torch state
# ---------------------------------------------------------------------------
def _torch_tree():
    gen = torch.Generator().manual_seed(8)
    return {
        "layer0/w": torch.randn(2048, generator=gen),
        "layer0/b": torch.randn(128, generator=gen),
        "emb": torch.randint(0, 255, (1024,), generator=gen, dtype=torch.int32),
    }


@pytest.mark.parametrize("pipeline", ["serial", "pipelined"])
def test_delta_checkpoint_equivalence(tmp_path, pipeline):
    """The reference's delta leg on the port: an unchanged re-save moves
    nothing, a one-leaf change moves only that leaf's chunks, and the delta
    save restores bit-equal to a full save — the port's and the
    reference's — with equal leaf files and MANIFEST digests."""
    from repro.ckpt import restore_checkpoint as ref_restore
    from repro.ckpt import save_checkpoint as ref_save
    from repro_torch.convert import state_to_reference

    tree = _torch_tree()
    ck = str(tmp_path / "saves")
    svc = _service(_ns("repro_torch"), tmp_path, pipeline=pipeline)
    try:
        submit_checkpoint(svc, ck, 1, tree, chunk_bytes=4096).wait(60)
        sub2 = submit_checkpoint(svc, ck, 2, tree, delta=True)
        rep2 = sub2.wait(60)
        st2 = sub2.status()
        assert st2.chunks_deduped == st2.chunks_total
        assert st2.wire_bytes_saved == st2.bytes_total
        tree2 = dict(tree)
        tree2["layer0/b"] = tree["layer0/b"] + 1.0
        sub3 = submit_checkpoint(svc, ck, 3, tree2, delta=True)
        rep3 = sub3.wait(60)
        st3 = sub3.status()
        assert 0 < st3.chunks_deduped < st3.chunks_total
        assert st3.chunks_total - st3.chunks_deduped == 1     # b: one 512-byte chunk
    finally:
        svc.close()

    full = save_checkpoint(str(tmp_path / "full"), 3, tree2, chunk_bytes=4096, device="cpu")
    theirs = ref_save(str(tmp_path / "ref"), 3, state_to_reference(tree2), chunk_bytes=4096)
    td, sd = restore_checkpoint(rep3.path, device="cpu")
    tf, sf = restore_checkpoint(full.path, device="cpu")
    assert sd == sf == 3
    for k, v in tree2.items():
        a, b = k.split("/") if "/" in k else (k, None)
        got = td[a][b] if b else td[a]
        want = tf[a][b] if b else tf[a]
        assert torch.equal(got, v) and torch.equal(got, want), k
    rt, _ = ref_restore(rep3.path)
    assert np.array_equal(rt["layer0"]["b"], tree2["layer0/b"].numpy())
    manifests = []
    for path in (rep3.path, full.path, theirs.path):
        with open(os.path.join(path, "MANIFEST.json")) as fh:
            manifests.append(json.load(fh))
    md = manifests[0]
    for other, path in zip(manifests[1:], (full.path, theirs.path)):
        assert set(md["leaves"]) == set(other["leaves"])
        for key, lv in md["leaves"].items():
            assert lv["digest"] == other["leaves"][key]["digest"]
            with open(os.path.join(rep3.path, lv["file"]), "rb") as fh:
                delta_bytes = fh.read()
            with open(os.path.join(path, other["leaves"][key]["file"]), "rb") as fh:
                assert delta_bytes == fh.read()
    t2r, s2 = restore_checkpoint(rep2.path, device="cpu")
    assert s2 == 2 and torch.equal(t2r["emb"], tree["emb"])


def test_delta_without_previous_save_is_full_save(tmp_path):
    tree = {"w": torch.arange(512, dtype=torch.float32)}
    svc = _service(_ns("repro_torch"), tmp_path)
    try:
        sub = submit_checkpoint(svc, str(tmp_path / "saves"), 1, tree, delta=True)
        rep = sub.wait(60)
        assert sub.status().chunks_deduped == 0
    finally:
        svc.close()
    td, step = restore_checkpoint(rep.path, device="cpu")
    assert step == 1 and torch.equal(td["w"], tree["w"])


def test_bridge_without_a_card_needs_device_cpu(tmp_path):
    """No card: the bridge's service refuses the default device, and with
    ``device="cpu"`` the save runs on the kernels' plain versions."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default service is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransferService(tmp_path / "svc", ServiceConfig(chunk_bytes=4096))
    svc = TransferService(tmp_path / "svc", ServiceConfig(
        chunk_bytes=4096, pipeline="pipelined", batch=BatchConfig()), device="cpu")
    try:
        rep = submit_checkpoint(svc, tmp_path / "ck", 1,
                                {"w": torch.arange(3000, dtype=torch.int32)}).wait(60)
        assert svc.device.type == "cpu"
    finally:
        svc.close()
    got, _ = restore_checkpoint(rep.path, device="cpu")
    assert torch.equal(got["w"], torch.arange(3000, dtype=torch.int32))
