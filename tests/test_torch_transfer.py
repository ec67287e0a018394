"""The port's slice as a whole: a chunked, integrity-checked transfer.

The same seeded payload and the same plan go through the reference
``repro.core.ChunkedTransfer`` and the port's (pipelined, fused verification
through ``checksum_many_words`` — its plain version on the CPU). File digest,
per-chunk digests, destination bytes and journals must be equal. The journal
crosses between the packages both ways. A guard keeps JAX and the reference
package out of the port.
"""
import ast
import os

import numpy as np
import pytest
import torch

import repro.core as jc
import repro_torch.core as tc
from repro_torch.convert import digest_from_reference, plan_from_reference

KiB, MiB = 1024, 1024 * 1024
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def payload():
    # 2 MiB + 17: 32 tile-aligned 64 KiB chunks and a ragged 17-byte tail
    return np.random.default_rng(101).bytes(2 * MiB + 17)


def _plan(n):
    return jc.plan_chunks(n, 4, chunk_bytes=64 * KiB, min_chunk=1, max_chunk=1 << 40)


def _key(d):
    return (tuple(d.h), d.length)


def test_port_transfer_matches_reference(payload):
    ref_plan = _plan(len(payload))
    ref_dst = jc.BufferDest(len(payload))
    ref = jc.ChunkedTransfer(jc.BufferSource(payload), ref_dst, ref_plan,
                             pipeline="pipelined", integrity_workers=2).run()
    port_dst = tc.BufferDest(len(payload))
    xfer = tc.ChunkedTransfer(tc.BufferSource(payload), port_dst,
                              plan_from_reference(ref_plan), pipeline="pipelined",
                              integrity_workers=2, device="cpu")
    port = xfer.run()
    assert bytes(port_dst.buf) == bytes(ref_dst.buf) == payload
    assert _key(port.file_digest) == _key(ref.file_digest)
    assert port.file_digest == digest_from_reference(ref.file_digest)
    assert port.file_digest == tc.fingerprint_bytes(payload)
    assert sorted(port.outcomes) == sorted(ref.outcomes)
    for i, out in ref.outcomes.items():
        assert _key(port.outcomes[i].digest) == _key(out.digest)
    assert port.pipeline == "pipelined" and port.retries == 0


def test_port_transfer_heals_a_flipped_landing(payload):
    """A bit flipped in one chunk's first write is caught by the deferred
    verifier and healed by exactly one re-fetch."""
    plan = plan_from_reference(_plan(len(payload)))
    target = plan.chunks[5].offset
    flips = {"n": 0}

    class FlippyDest(tc.BufferDest):
        def write(self, offset, data):
            if offset == target and flips["n"] == 0:
                flips["n"] += 1
                data = bytes([data[0] ^ 0x01]) + bytes(data[1:])
            super().write(offset, data)

    dst = FlippyDest(len(payload))
    rep = tc.ChunkedTransfer(tc.BufferSource(payload), dst, plan,
                             pipeline="pipelined", device="cpu").run()
    assert flips["n"] == 1
    assert rep.refetches == 1 and len(rep.quarantined) == 1
    assert rep.quarantined[0].chunk_index == 5
    assert bytes(dst.buf) == payload
    assert rep.file_digest == tc.fingerprint_bytes(payload)


@pytest.mark.parametrize("pipeline", ["serial", "pipelined"])
def test_journals_are_byte_identical(payload, tmp_path, pipeline):
    """One mover, chunks in plan order: both packages write the same
    journal, byte for byte."""
    plan = jc.plan_chunks(len(payload), 1, chunk_bytes=256 * KiB,
                          min_chunk=1, max_chunk=1 << 40)
    paths = []
    for name, mod, kw in (("ref", jc, {}), ("port", tc, {"device": "cpu"})):
        path = tmp_path / f"{name}.journal"
        j = mod.ChunkJournal(path)
        p = plan if mod is jc else plan_from_reference(plan)
        # one integrity worker keeps verdicts (and so journal lines) in order
        mod.ChunkedTransfer(mod.BufferSource(payload), mod.BufferDest(len(payload)), p,
                            journal=j, pipeline=pipeline, integrity_workers=1,
                            **(kw if pipeline == "pipelined" else {})).run()
        j.close()
        paths.append(path)
    ref_bytes, port_bytes = paths[0].read_bytes(), paths[1].read_bytes()
    assert len(ref_bytes.splitlines()) == plan.n_chunks
    assert port_bytes == ref_bytes


class _Bomb(Exception):
    pass


@pytest.mark.parametrize("first, second", [("ref", "port"), ("port", "ref")])
def test_journal_resume_across_packages(payload, tmp_path, first, second):
    """A transfer killed under one package resumes under the other and
    re-moves none of the journaled chunks."""
    mods = {"ref": (jc, {}), "port": (tc, {"device": "cpu"})}
    ref_plan = _plan(len(payload))
    plans = {"ref": ref_plan, "port": plan_from_reference(ref_plan)}
    jpath = tmp_path / "x.journal"
    calls = {"n": 0}

    def crash(_chunk, _attempt):
        calls["n"] += 1
        if calls["n"] > 9:
            raise _Bomb("host died")

    mod, kw = mods[first]
    dst = bytearray(len(payload))
    d1 = mod.BufferDest(len(payload))
    d1.buf = dst
    j = mod.ChunkJournal(jpath)
    with pytest.raises(_Bomb):
        mod.ChunkedTransfer(mod.BufferSource(payload), d1, plans[first], journal=j,
                            fault_injector=crash, max_retries=0,
                            pipeline="pipelined", **kw).run()
    j.close()

    mod, kw = mods[second]
    j2 = mod.ChunkJournal(jpath)
    journaled = {(r.offset, r.length) for r in j2.records.values()}
    assert 0 < len(journaled) < ref_plan.n_chunks
    moved = []
    d2 = mod.BufferDest(len(payload))
    d2.buf = dst
    rep = mod.ChunkedTransfer(
        mod.BufferSource(payload), d2, plans[second], journal=j2,
        fault_injector=lambda c, _a: moved.append((c.offset, c.length)),
        pipeline="pipelined", **kw).run()
    j2.close()
    assert rep.skipped_chunks == len(journaled)
    assert not journaled & set(moved)          # 0 journaled chunks re-moved
    assert bytes(dst) == payload
    assert _key(rep.file_digest) == _key(jc.fingerprint_bytes(payload))


def test_transfer_without_device_needs_a_card(payload):
    """Pipelined transfers verify on the card by default: with no card they
    refuse to start rather than run on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default transfer is valid here")
    plan = plan_from_reference(_plan(len(payload)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.ChunkedTransfer(tc.BufferSource(payload), tc.BufferDest(len(payload)),
                           plan, pipeline="pipelined")
    # the serial engine builds no integrity engine and needs no card
    rep = tc.ChunkedTransfer(tc.BufferSource(payload), tc.BufferDest(len(payload)),
                             plan).run()
    assert rep.file_digest == tc.fingerprint_bytes(payload)


def _port_files():
    root = os.path.join(REPO, "src", "repro_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_neither_jax_nor_the_reference():
    banned = ("jax", "jaxlib", "repro", "ml_dtypes")
    bad = []
    files = list(_port_files())
    assert len(files) >= 56
    # every subpackage of the port is walked, the service's and the CLI's included
    walked = {os.path.relpath(f, os.path.join(REPO, "src", "repro_torch")) for f in files}
    for module in ("service/service.py", "service/ckpt_bridge.py", "service/store.py",
                   "cas/index.py", "resil/scrub.py", "tune/controller.py",
                   "tune/simtune.py", "core/vclock.py", "core/simulator.py",
                   "core/scheduler.py", "obs/recorder.py", "service/testbed.py",
                   "faults/scenarios.py", "faults/injectors.py", "resil/health.py",
                   "tune/harness.py", "obs/attr.py", "fabric/topology.py",
                   "fabric/relay.py", "fabric/campaign.py", "fabric/virtual.py",
                   "launch/transferd.py"):
        assert module in walked, module
    for path in files:
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in banned:
                    bad.append(f"{os.path.relpath(path, REPO)}:{node.lineno} {name}")
    assert bad == []
