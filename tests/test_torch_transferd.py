"""The port's ``transferd`` CLI against the reference's, and the slice as a
whole: every digest the service, the content index, the scrubber, the
relay and the campaigns take goes through the device helper.

Across packages, on the same arguments:

  * every virtual mode — the testbed (``--tune`` too), ``trace --export``
    without ``--real``, ``fabric plan`` and ``fabric campaign`` (with a
    chaos scenario) — prints the same stdout (the testbed's "s wall"
    timings aside), and the testbed's metrics and its exported trace JSON
    are byte-identical for one seed (the properties of
    ``tests/test_determinism.py`` across packages);
  * ``--real`` (run twice on one directory: restart and log replay) and
    ``fabric replicate`` land every task and replica alike, and ``scrub``
    after the same seeded rot of the same landed files reports alike.

The port alone: ``--device cpu`` runs the real modes on the kernels' plain
versions; without it and without a card each real mode raises before it
writes anything, while ``cas stats`` and ``cas gc``, which take no digest,
run with no device flag and print what the reference prints. With the host digests patched to raise in every module
the slice routed to the card (and in the data plane below them), a serial,
a single-pass and a pipelined task, a delta checkpoint, a scrub, a relay
(whole-chunk and tuned) and a campaign (wire and index edges) all succeed.
The ``gpu`` tests run the serial, single-pass and dedup paths on the card.

The reference is imported inside the tests, so the card's machine,
which has no JAX, can collect this file.
"""
import importlib
import os
import re

import numpy as np
import pytest
import torch

from repro_torch.launch import transferd as port_cli

PKGS = ("repro", "repro_torch")
KiB, MiB = 1024, 1024 * 1024

TESTBED = ["--policy", "all", "--small", "60", "--small-mb", "100", "--large", "2",
           "--large-gb", "100", "--tenants", "2", "--movers", "16", "--concurrent", "4"]
VIRTUAL_MODES = {
    "testbed": TESTBED,
    "testbed_tune": TESTBED + ["--tune", "--policy", "marginal"],
    "plan": ["fabric", "plan", "--topology", "chain", "--dst", "d0"],
    "plan_fat_tree": ["fabric", "plan", "--topology", "fat_tree", "--dst", "d2", "-k", "4"],
    "campaign": ["fabric", "campaign", "--topology", "chain", "--fanout", "4", "--gb", "100",
                 "--chaos", "link_outage_at_50pct+degrade_hop"],
    "campaign_star": ["fabric", "campaign", "--topology", "star", "--fanout", "3",
                      "--gb", "10", "--seed", "3"],
}


def _cli(name):
    return importlib.import_module(f"{name}.launch.transferd")


def _run(capsys, name, argv):
    _cli(name).main(argv)
    return capsys.readouterr().out


def _masked(out: str) -> str:
    return re.sub(r"\(\d+\.\ds wall\)", "(_ wall)", out)


# ---------------------------------------------------------------------------
# virtual modes: the same stdout
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", sorted(VIRTUAL_MODES))
def test_virtual_mode_prints_what_the_reference_prints(capsys, mode):
    argv = VIRTUAL_MODES[mode]
    ref = _run(capsys, "repro", argv)
    port = _run(capsys, "repro_torch", argv)
    assert ref.strip()
    assert _masked(port) == _masked(ref)


def test_trace_export_is_byte_identical_across_packages(capsys, tmp_path):
    argv = ["trace", "--chaos", "--small", "30", "--seed", "7"]
    outs = {}
    for name in PKGS:
        path = tmp_path / f"{name}.json"
        outs[name] = _run(capsys, name, argv + ["--export", str(path)]).replace(str(path), "F")
    assert outs["repro_torch"] == outs["repro"]
    assert (tmp_path / "repro_torch.json").read_bytes() == (tmp_path / "repro.json").read_bytes()


def _testbed_rows(name, seed):
    svc = importlib.import_module(f"{name}.service")
    faults = importlib.import_module(f"{name}.faults")
    obs = importlib.import_module(f"{name}.obs")
    tracer = obs.Tracer(clock=obs.Clock(lambda: 0.0, virtual=True))
    rep = svc.run_load(
        svc.mixed_workload(n_small=40, n_large=2),
        scenario=faults.parse_scenario("corrupt_1_per_TiB+kill_2_movers+outage_at_50pct"),
        policy="marginal", mover_budget=8, max_concurrent=4, seed=seed, tracer=tracer)
    rows = [("agg_gbps", rep.aggregate_gbps), ("makespan_s", rep.makespan_s),
            ("p50_s", rep.p50_s), ("p99_s", rep.p99_s),
            ("amplification", rep.retry_amplification),
            ("corruptions", rep.faults.corruptions)]
    return repr(rows), repr(rep), tracer.export_json()


@pytest.mark.parametrize("seed", [7, 11])
def test_testbed_report_and_trace_byte_identical_across_packages(seed):
    assert _testbed_rows("repro_torch", seed) == _testbed_rows("repro", seed)


# ---------------------------------------------------------------------------
# real modes: no card, no device flag -> refused before any write
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("argv", [
    ["--real", "{d}"],
    ["top", "--root", "{d}", "--frames", "1"],
    ["trace", "--export", "{d}/t.json", "--real", "{d}"],
    ["scrub", "--root", "{d}"],
    ["fabric", "replicate", "--root", "{d}", "--fanout", "2", "--kb", "64"],
], ids=["real", "top", "trace", "scrub", "replicate"])
def test_real_modes_without_a_card_refuse_before_writing(tmp_path, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    d = tmp_path / "root"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main([a.format(d=d) for a in argv])
    assert not d.exists()


def test_index_without_a_card_refuses_only_at_verify(tmp_path):
    """The index resolves its device at the first ``verify_entry``: with no
    card, the default index records, reads, counts and compacts, and raises
    only when asked to digest."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from repro_torch.cas import ChunkIndex
    from repro_torch.core.integrity import fingerprint_bytes

    data = tmp_path / "f.bin"
    data.write_bytes(b"x" * 5000)
    hexd = fingerprint_bytes(data.read_bytes()).hexdigest()
    with ChunkIndex(tmp_path / "cas" / "index.log") as idx:
        assert idx.put(hexd, 5000, str(data), 0)
        [entry] = idx.lookup(hexd, 5000)
        assert idx.read_region(entry) == data.read_bytes()
        assert idx.stats()["locations"] == 1 and idx.compact()["records"] == 1
        with pytest.raises(RuntimeError, match="no CUDA device"):
            idx.verify_entry(entry)


def _index_log(name, path):
    """The same puts, repeats and discards through one package's index."""
    cas = importlib.import_module(f"{name}.cas")
    with cas.ChunkIndex(path) as idx:
        for i in range(6):
            idx.put(f"{i:064x}", 4096 * (i + 1), f"/data/f{i % 2}.bin", 4096 * i)
            idx.put(f"{i:064x}", 4096 * (i + 1), f"/replica/f{i % 2}.bin", 4096 * i)
        idx.put(f"{0:064x}", 4096, "/data/f0.bin", 0)          # already indexed
        for i in (1, 4):
            idx.discard(f"{i:064x}", 4096 * (i + 1), f"/replica/f{i % 2}.bin", 4096 * i)
        idx.discard(f"{5:064x}", 6 * 4096, "/data/f1.bin", 5 * 4096)


@pytest.mark.parametrize("cmd", ["stats", "gc"])
def test_cas_mode_without_a_device_flag_prints_what_the_reference_prints(
        capsys, tmp_path, cmd):
    """``cas stats`` and ``cas gc`` take no digest: with no device flag they
    run anywhere, the port's default index included, and print what the
    reference prints (then ``stats`` again, after ``gc``)."""
    outs = {}
    for name in PKGS:
        path = tmp_path / name / f"cas-{cmd}" / "index.log"
        _index_log(name, path)
        out = _run(capsys, name, ["cas", cmd, "--index", str(path)])
        out += _run(capsys, name, ["cas", "stats", "--index", str(path)])
        outs[name] = out.replace(str(path), "INDEX")
    assert outs["repro_torch"] == outs["repro"]
    assert "digests        6" in outs["repro"] and "locations      9" in outs["repro"]
    if cmd == "gc":
        assert "compacted INDEX: 9 live records" in outs["repro"]
        assert (tmp_path / "repro_torch" / "cas-gc" / "index.log").read_bytes() == \
            (tmp_path / "repro" / "cas-gc" / "index.log").read_bytes()


# ---------------------------------------------------------------------------
# real modes on the CPU, against the reference
# ---------------------------------------------------------------------------
def _task_lines(out):
    return [re.sub(r"latency=\S+", "latency=_", ln) for ln in out.splitlines()
            if ln.startswith("  task-")]


def test_real_mode_twice_lands_every_task_like_the_reference(capsys, tmp_path):
    ref = _task_lines(_run(capsys, "repro", ["--real", str(tmp_path / "ref")]))
    first = _task_lines(_run(capsys, "repro_torch",
                             ["--real", str(tmp_path / "port"), "--device", "cpu"]))
    assert first == ref and len(ref) == 4
    assert all(" SUCCEEDED " in ln for ln in ref)
    # the same root again: the store replays, numbering continues
    again = _run(capsys, "repro_torch", ["--real", str(tmp_path / "port"), "--device", "cpu"])
    lines = _task_lines(again)
    assert [ln.split()[0] for ln in lines] == [f"task-00000000{i}-tenant{(i - 4) // 2}"
                                               for i in range(4, 8)]
    assert all(" SUCCEEDED " in ln for ln in lines)
    for f in os.listdir(tmp_path / "port" / "data"):
        if f.endswith(".bin"):
            p = tmp_path / "port" / "data" / f
            assert (p.parent / (f + ".out")).read_bytes() == p.read_bytes()
    # every landed region checks out: scrub and cas on the same root
    out = _run(capsys, "repro_torch", ["scrub", "--root", str(tmp_path / "port" / "state"),
                                       "--device", "cpu"])
    assert "0 detected, 0 repaired, 0 quarantined" in out
    assert "176 regions" in out
    out = _run(capsys, "repro_torch", ["cas", "stats", "--index",
                                       str(tmp_path / "port" / "state" / "cas" / "index.log")])
    assert "digests        0" in out


def test_top_and_real_trace_on_the_cpu(capsys, tmp_path):
    out = _run(capsys, "repro_torch", ["top", "--root", str(tmp_path / "top"),
                                       "--frames", "2", "--device", "cpu"])
    assert out.count("--- transferd top") >= 1 and "tenants active" in out
    path = tmp_path / "real.json"
    out = _run(capsys, "repro_torch", ["trace", "--export", str(path), "--real",
                                       str(tmp_path / "tr"), "--device", "cpu"])
    assert out.startswith("exported ") and "(2 tasks)" in out and path.exists()


def _replicate(capsys, name, root, *extra):
    out = _run(capsys, name, ["fabric", "replicate", "--root", str(root), "--fanout", "3",
                              "--kb", "300", *extra])
    return re.sub(r", \d+\.\d+s$", ", _s", out.strip(), flags=re.M)


def test_fabric_replicate_equal_replicas_across_packages(capsys, tmp_path):
    ref = _replicate(capsys, "repro", tmp_path / "ref")
    port = _replicate(capsys, "repro_torch", tmp_path / "port", "--device", "cpu")
    assert port == ref
    assert "3/3 replicas verified, 0 escapes" in port
    fp = importlib.import_module("repro.core.integrity").fingerprint_bytes
    origin = (tmp_path / "ref" / "src" / "replica.bin").read_bytes()
    for d in ("d0", "d1", "d2"):
        for root in ("ref", "port"):
            got = (tmp_path / root / d / "replica.bin").read_bytes()
            assert fp(got) == fp(origin), (root, d)


def _rotted_root(name, root, seed):
    """A service root with three landed files, then seeded bit-rot in them."""
    svc_mod = importlib.import_module(f"{name}.service")
    kw = {"device": "cpu"} if name == "repro_torch" else {}
    rng = np.random.default_rng(seed)
    os.makedirs(root / "data")
    items = []
    for i in range(3):
        p = root / "data" / f"f{i}.bin"
        p.write_bytes(rng.integers(0, 256, 100_000 + 977 * i, dtype=np.uint8).tobytes())
        items.append((str(p), str(p) + ".out"))
    svc = svc_mod.TransferService(str(root / "state"), svc_mod.ServiceConfig(
        mover_budget=2, max_concurrent_tasks=1, chunk_bytes=32 * KiB, tick_s=0.002,
        batch=svc_mod.BatchConfig(direct_bytes=1 << 30, batch_files=8)), **kw)
    try:
        [tid] = svc.submit(items)
        assert svc.wait(tid, timeout=60).state == "SUCCEEDED"
        regions = [(t.path, t.offset, t.length) for t in svc.scrub_targets()]
    finally:
        svc.close()
    importlib.import_module(f"{name}.faults").corrupt_landed_regions(
        regions, count=3, seed=seed)


@pytest.mark.parametrize("seed", [1, 5])
def test_scrub_after_the_same_rot_reports_alike(capsys, tmp_path, seed):
    outs = {}
    for name in PKGS:
        root = tmp_path / name
        _rotted_root(name, root, seed)
        extra = ["--device", "cpu"] if name == "repro_torch" else []
        with pytest.raises(SystemExit) as exc:          # quarantine: no donor
            _run(capsys, name, ["scrub", "--root", str(root / "state"), *extra])
        assert exc.value.code == 1
        outs[name] = capsys.readouterr().out.replace(str(root), "ROOT")
    assert outs["repro_torch"] == outs["repro"]
    assert "3 detected, 0 repaired, 3 quarantined" in outs["repro"]
    assert outs["repro"].count("QUARANTINE") == 3


# ---------------------------------------------------------------------------
# the slice as a whole: no site falls back to a host digest
# ---------------------------------------------------------------------------
ROUTED = ("repro_torch.service.service", "repro_torch.cas.index",
          "repro_torch.resil.scrub", "repro_torch.fabric.relay",
          "repro_torch.fabric.campaign")


@pytest.fixture
def host_digests_raise(monkeypatch):
    """Every host digest the routed sites could reach raises: the names in
    the five routed modules, the data plane's and the digest module's host
    digests below them, and the running (streaming) host fingerprint."""
    def host_digest(*_a, **_k):
        raise AssertionError("a host digest ran")

    for mod in ROUTED:
        m = importlib.import_module(mod)
        monkeypatch.setattr(m, "fingerprint_bytes", host_digest, raising=False)
        monkeypatch.setattr(m, "fingerprint_many", host_digest, raising=False)
    dp = importlib.import_module("repro_torch.core.dataplane")
    for fn in ("fingerprint_bytes", "fingerprint_many", "fingerprint_view"):
        monkeypatch.setattr(dp, fn, host_digest)
    integrity = importlib.import_module("repro_torch.core.integrity")
    for fn in ("fingerprint_bytes", "fingerprint_many"):
        monkeypatch.setattr(integrity, fn, host_digest)
    monkeypatch.setattr(integrity.RunningFingerprint, "update", host_digest)


def _files(root, sizes, seed=0):
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    items = []
    for i, n in enumerate(sizes):
        p = os.path.join(str(root), f"f{i}.bin")
        with open(p, "wb") as fh:
            fh.write(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
        items.append((p, p + ".out"))
    return items


def test_every_routed_site_digests_on_the_device(host_digests_raise, tmp_path):
    from repro_torch.core import BufferSource, FileDest
    from repro_torch.fabric import (CampaignRunner, RelayTransfer, RoutePlanner,
                                    shared_trunk_topology)
    from repro_torch.cas import ChunkIndex
    from repro_torch.service import (BatchConfig, ServiceConfig, TransferService,
                                     submit_checkpoint)
    from repro_torch.ckpt import restore_checkpoint

    cfg = dict(mover_budget=4, max_concurrent_tasks=3, chunk_bytes=32 * KiB,
               tick_s=0.002, batch=BatchConfig(direct_bytes=1 << 30, batch_files=8))
    # single-pass: ragged tails (checksum_words); pipelined: tile-aligned
    # rows (the fused drain's checksum_many_words) and a ragged tail (its
    # checksum_words rows); serial below
    for i, (pipeline, sizes) in enumerate((("single_pass", [77_777, 64 * KiB]),
                                           ("pipelined", [4 * 32 * KiB, 2 * 32 * KiB,
                                                          50_001]))):
        svc = TransferService(tmp_path / f"svc-{pipeline}",
                              ServiceConfig(pipeline=pipeline, **cfg), device="cpu")
        try:
            [tid] = svc.submit(_files(tmp_path / pipeline, sizes, seed=i), batch=False)
            st = svc.wait(tid, timeout=60)
        finally:
            svc.close()
        assert st.state == "SUCCEEDED", (pipeline, st.error)
    svc = TransferService(tmp_path / "svc", ServiceConfig(dedup="on", **cfg), device="cpu")
    try:
        [tid] = svc.submit(_files(tmp_path / "serial", [100_003, 64 * KiB], seed=2),
                           batch=False)
        st = svc.wait(tid, timeout=60)
        assert st.state == "SUCCEEDED", st.error
        # a delta checkpoint: dedup probes, donor checks, landing checks
        gen = torch.Generator().manual_seed(3)
        state = {"w": torch.randn(96, 512, generator=gen), "b": torch.randn(700, generator=gen)}
        submit_checkpoint(svc, tmp_path / "ckpt", 1, state).wait(60)
        state["w"][:4] += 1.0
        sub = submit_checkpoint(svc, tmp_path / "ckpt", 2, state, delta=True)
        rep = sub.wait(60)
        assert sub.status().chunks_deduped > 0
        got, step = restore_checkpoint(rep.path, device="cpu")
        assert step == 2 and all(torch.equal(got[k], v) for k, v in state.items())
        # a scrub over the transfer task's landed chunks
        srep = svc.scrub(tid)
        assert srep.scanned > 0 and srep.rot_detected == 0
    finally:
        svc.close()

    payload = np.random.default_rng(4).integers(0, 256, 200_000 + 13, dtype=np.uint8).tobytes()
    topo = shared_trunk_topology(1, trunk_hops=2)
    route = RoutePlanner(topo).best_route("src", "d0", len(payload))
    for tuned in (False, True):
        out = tmp_path / f"relay{int(tuned)}.bin"
        rep = RelayTransfer(route, BufferSource(payload), FileDest(str(out), len(payload)),
                            workdir=str(tmp_path / f"wd{int(tuned)}"), chunk_bytes=32 * KiB,
                            movers=2, tuning=tuned, granule_min=8 * KiB, tune_epoch_chunks=1,
                            device="cpu").run()
        assert out.read_bytes() == payload
        assert tuned == any(0 < h.granule_bytes < 32 * KiB for h in rep.hops)  # granule hops

    topo = shared_trunk_topology(2, trunk_hops=1)
    dirs = {n: str(tmp_path / "fab" / n) for n in topo.endpoints}
    for d in dirs.values():
        os.makedirs(d)
    with open(os.path.join(dirs["src"], "data.bin"), "wb") as fh:
        fh.write(payload)
    indexes = {n: ChunkIndex(tmp_path / "idx" / n / "index.log", device="cpu")
               for n in topo.endpoints}
    svc = TransferService(tmp_path / "svc2", ServiceConfig(**cfg), device="cpu")
    try:
        runner = CampaignRunner(svc, topo, dirs, indexes=indexes)
        assert runner.device == svc.device
        first = runner.replicate("data.bin", "src", ["d0", "d1"], timeout=60)
        second = runner.replicate("data.bin", "src", ["d0", "d1"], timeout=60)
    finally:
        svc.close()
        for idx in indexes.values():
            idx.close()
    assert first.state == second.state == "SUCCEEDED"
    assert second.edges_deduped == len(second.edge_states) > 0
    assert second.replicas_verified == 2 and second.integrity_escapes == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("pipeline", ["serial", "single_pass"])
def test_cuda_movers_digest_on_the_card(cuda_device, tmp_path, pipeline):
    """Serial and single-pass tasks on the card: tile-aligned chunks, a
    ragged tail and a file under one tile; the item digests equal the host
    digests and the movers launched the checksum kernels."""
    from repro_torch.core.integrity import fingerprint_bytes
    from repro_torch.kernels import checksum as tck
    from repro_torch.service import ServiceConfig, TransferService

    items = _files(tmp_path / "data", [8 * 32 * KiB, 300_001, 5_000], seed=9)
    tck.reset_launch_counts()
    svc = TransferService(tmp_path / "svc", ServiceConfig(
        mover_budget=8, max_concurrent_tasks=2, chunk_bytes=64 * KiB, tick_s=0.002,
        pipeline=pipeline), device=cuda_device)
    try:
        [tid] = svc.submit(items, batch=False)
        st = svc.wait(tid, timeout=120)
    finally:
        svc.close()
    counts = tck.launch_counts()
    assert st.state == "SUCCEEDED", st.error
    for (src, dst), rep in zip(items, st.item_reports):
        data = open(src, "rb").read()
        assert open(dst, "rb").read() == data
        assert rep.digest_hex == fingerprint_bytes(data).hexdigest()
    assert counts["checksum_words"] > 0
    if pipeline == "serial":
        assert counts["checksum_many_words"] > 0


@pytest.mark.gpu
def test_cuda_dedup_probes_digest_on_the_card(cuda_device, tmp_path):
    """A delta checkpoint on the card: the dedup probes (source, donor,
    landing) launch the kernels, the unchanged chunks dedup and the save
    restores bit-equal."""
    from repro_torch.ckpt import restore_checkpoint
    from repro_torch.kernels import checksum as tck
    from repro_torch.service import ServiceConfig, TransferService, submit_checkpoint

    gen = torch.Generator().manual_seed(5)
    state = {"w": torch.randn(256, 1024, generator=gen), "b": torch.randn(3001, generator=gen)}
    svc = TransferService(tmp_path / "svc", ServiceConfig(
        chunk_bytes=64 * KiB, tick_s=0.002), device=cuda_device)
    try:
        submit_checkpoint(svc, tmp_path / "ckpt", 1, state).wait(60)
        state["w"][:8] += 1.0
        tck.reset_launch_counts()
        sub = submit_checkpoint(svc, tmp_path / "ckpt", 2, state, delta=True)
        rep = sub.wait(60)
        deduped = sub.status().chunks_deduped
    finally:
        svc.close()
    counts = tck.launch_counts()
    assert deduped > 0
    assert counts["checksum_many_words"] + counts["checksum_words"] >= 3 * deduped
    got, step = restore_checkpoint(rep.path, device="cpu")
    assert step == 2 and all(torch.equal(got[k], v) for k, v in state.items())
