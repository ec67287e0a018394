"""The port's chunked checkpoints of torch state, against the reference's.

Every test of ``tests/test_checkpoint.py`` again on the port (on the CPU:
``device="cpu"``), then the checks across packages: a port save restores
bit-equal with ``repro.ckpt.restore_checkpoint``, a reference save restores
bit-equal with the port, and the two MANIFEST.json files of one tree are
equal byte for byte (dtype strings are numpy's names: "bfloat16", not
"torch.bfloat16"; a 0-d leaf has shape []). The reference is imported inside
the tests that use it, so the card's machine, which has no JAX, can collect
this file; the test marked ``gpu`` runs there.
"""
import json
import shutil

import numpy as np
import pytest
import torch

from repro.core.integrity import fingerprint_bytes
from repro_torch.ckpt import CheckpointManager, CorruptionError, restore_checkpoint, save_checkpoint
from repro_torch.convert import state_from_reference, state_to_reference


def _ref():
    import ml_dtypes
    from repro import ckpt as jckpt
    return ml_dtypes, jckpt


@pytest.fixture
def tree():
    """The reference test's tree, as torch tensors."""
    return {
        "layer0": {"w": torch.arange(512 * 256, dtype=torch.float32).reshape(512, 256),
                   "b": torch.ones(256, dtype=torch.bfloat16)},
        "emb": torch.full((1000, 64), 2.5, dtype=torch.bfloat16),
        "step_scalar": torch.tensor(7, dtype=torch.int32),
    }


def ref_tree():
    """A reference pytree of numpy arrays: seeded values, every MANIFEST dtype."""
    ml_dtypes, _ = _ref()
    rng = np.random.default_rng(0)
    return {
        "layer0": {"w": rng.standard_normal((300, 70)).astype(np.float32),
                   "b": rng.standard_normal(4099).astype(ml_dtypes.bfloat16)},
        "emb": rng.standard_normal((513, 33)).astype(ml_dtypes.bfloat16),
        "ints": {name: rng.integers(0, 100, (17, 3)).astype(name)
                 for name in ("int32", "int8", "uint8", "int16", "uint32", "int64")},
        "f16": rng.standard_normal((9, 5)).astype(np.float16),
        "f64": rng.standard_normal(11),
        "mask": rng.integers(0, 2, 23).astype(bool),
        "step_scalar": np.int32(7),
        "empty": np.zeros((0, 4), np.float32),
    }


def byte_image(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat(v, key + "/"))
        else:
            out[key] = v
    return out


def assert_same_leaves(got, want):
    """Same keys, shapes and bytes; torch dtypes checked by the caller."""
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w)
    for key in w:
        assert tuple(g[key].shape) == tuple(w[key].shape), key
        assert byte_image(g[key]) == byte_image(w[key]), key


# ---------------------------------------------------------------------------
# the reference's tests, on the port
# ---------------------------------------------------------------------------
def test_roundtrip(tree, tmp_path):
    mgr = CheckpointManager(tmp_path, device="cpu")
    mgr.save(3, tree)
    got, step = mgr.restore()
    assert step == 3
    assert torch.equal(got["layer0"]["w"], tree["layer0"]["w"])
    assert got["emb"].dtype == torch.bfloat16 and torch.equal(got["emb"], tree["emb"])
    assert got["step_scalar"].shape == () and int(got["step_scalar"]) == 7
    assert all(t.device.type == "cpu" for t in flat(got).values())


def test_detects_corruption_by_chunk(tree, tmp_path):
    mgr = CheckpointManager(tmp_path, device="cpu")
    mgr.save(1, tree)
    target = tmp_path / "step_00000001" / "emb.bin"
    with open(target, "r+b") as fh:
        fh.seek(4321)
        b = fh.read(1)
        fh.seek(4321)
        fh.write(bytes([b[0] ^ 0x01]))       # single bit flip
    with pytest.raises(CorruptionError) as ei:
        mgr.restore()
    assert ei.value.leaf == "emb"
    assert ei.value.bad_chunks == [0]
    # unverified restore still loads (operator escape hatch)
    got, _ = mgr.restore(verify_chunks=False)
    assert got["emb"].shape == (1000, 64)


def test_detects_truncation(tree, tmp_path):
    mgr = CheckpointManager(tmp_path, device="cpu")
    mgr.save(1, tree)
    target = tmp_path / "step_00000001" / "layer0__w.bin"
    data = target.read_bytes()
    target.write_bytes(data[:-8])
    with pytest.raises(CorruptionError):
        mgr.restore()


def test_retention(tree, tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, device="cpu")
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_restore_or_init(tmp_path, tree):
    mgr = CheckpointManager(tmp_path, device="cpu")
    got, step = mgr.restore_or_init(lambda: {"x": torch.zeros(3)})
    assert step == 0 and "x" in got
    mgr.save(5, tree)
    got, step = mgr.restore_or_init(lambda: None)
    assert step == 5 and "emb" in got


def test_incomplete_save_not_visible_then_resumable(tree, tmp_path):
    """A checkpoint is only visible after atomic rename; re-saving resumes
    journaled chunks instead of rewriting them."""
    mgr = CheckpointManager(tmp_path, device="cpu")
    rep1 = mgr.save(2, tree)
    assert rep1.resumed_chunks == 0
    final = tmp_path / "step_00000002"
    tmp = tmp_path / "step_00000002.tmp"
    shutil.copytree(final, tmp)
    shutil.rmtree(final)
    assert mgr.latest_step() is None          # incomplete save invisible
    rep2 = mgr.save(2, tree)                  # re-save resumes from journal
    assert rep2.resumed_chunks > 0
    got, step = mgr.restore()
    assert step == 2
    assert torch.equal(got["layer0"]["w"], tree["layer0"]["w"])


def test_manifest_digests_cover_every_chunk(tree, tmp_path):
    save_checkpoint(tmp_path, 9, tree, device="cpu")
    with open(tmp_path / "step_00000009" / "MANIFEST.json") as fh:
        man = json.load(fh)
    for key, entry in man["leaves"].items():
        assert all(c["digest"] for c in entry["chunks"]), key
        total = sum(c["length"] for c in entry["chunks"])
        assert total == entry["nbytes"], key
    assert man["leaves"]["emb"]["dtype"] == "bfloat16"
    assert man["leaves"]["step_scalar"]["shape"] == []


def test_card_request_without_a_card_raises(tree, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        save_checkpoint(tmp_path, 1, tree)
    save_checkpoint(tmp_path, 1, tree, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        restore_checkpoint(tmp_path / "step_00000001")


# ---------------------------------------------------------------------------
# across packages: bytes and MANIFESTs agree both ways
# ---------------------------------------------------------------------------
def test_state_conversion_round_trips():
    ml_dtypes, _ = _ref()
    ref = ref_tree()
    state = state_from_reference(ref)
    assert state["emb"].dtype == torch.bfloat16 and state["step_scalar"].shape == ()
    assert state["mask"].dtype == torch.bool and state["ints/uint32"].dtype == torch.uint32
    back = state_to_reference(state)
    assert back["emb"].dtype == ml_dtypes.bfloat16
    for key, want in flat(ref).items():
        got = flat(back)[key]
        assert got.dtype == np.asarray(want).dtype, key
        np.testing.assert_array_equal(got, want)


def test_port_save_restores_with_reference(tmp_path):
    _, jckpt = _ref()
    ref = ref_tree()
    save_checkpoint(tmp_path, 4, state_from_reference(ref), device="cpu", chunk_bytes=4096)
    got, step = jckpt.restore_checkpoint(tmp_path / "step_00000004")
    assert step == 4
    assert_same_leaves(got, ref)
    for key, want in flat(ref).items():
        assert flat(got)[key].dtype == np.asarray(want).dtype, key


def test_reference_save_restores_with_port(tmp_path):
    _, jckpt = _ref()
    ref = ref_tree()
    jckpt.save_checkpoint(tmp_path, 6, ref, chunk_bytes=4096)
    got, step = restore_checkpoint(tmp_path / "step_00000006", device="cpu")
    assert step == 6
    assert_same_leaves(got, ref)
    assert_same_leaves(state_to_reference(got), ref)


def test_manifests_are_equal(tmp_path):
    _, jckpt = _ref()
    ref = ref_tree()
    jckpt.save_checkpoint(tmp_path / "ref", 2, ref, chunk_bytes=4096)
    save_checkpoint(tmp_path / "port", 2, state_from_reference(ref), device="cpu",
                    chunk_bytes=4096)
    a = (tmp_path / "ref" / "step_00000002" / "MANIFEST.json").read_bytes()
    b = (tmp_path / "port" / "step_00000002" / "MANIFEST.json").read_bytes()
    assert json.loads(b) == json.loads(a)
    assert b == a
    man = json.loads(a)
    assert man["leaves"]["layer0/b"]["dtype"] == "bfloat16"
    assert man["leaves"]["step_scalar"]["shape"] == []
    assert len(man["leaves"]["emb"]["chunks"]) > 1
    port, theirs = tmp_path / "port" / "step_00000002", tmp_path / "ref" / "step_00000002"
    for name in ("layer0__b", "emb", "ints__int64"):
        assert (port / f"{name}.bin").read_bytes() == (theirs / f"{name}.bin").read_bytes()
        # journal records land in the order the movers finish: same set of lines
        lines = [sorted((d / f"{name}.journal").read_text().splitlines()) for d in (port, theirs)]
        assert lines[0] == lines[1], name


@pytest.mark.parametrize("first", ["ref", "port"])
def test_resaved_files_are_byte_identical(tmp_path, first):
    """A checkpoint saved by one package, restored by the other and saved
    again there, has the same MANIFEST and leaf files, byte for byte."""
    _, jckpt = _ref()
    ref = ref_tree()
    a, b = tmp_path / "a", tmp_path / "b"
    if first == "ref":
        jckpt.save_checkpoint(a, 3, ref, chunk_bytes=4096)
        got, _ = restore_checkpoint(a / "step_00000003", device="cpu")
        save_checkpoint(b, 3, got, device="cpu", chunk_bytes=4096)
    else:
        save_checkpoint(a, 3, state_from_reference(ref), device="cpu", chunk_bytes=4096)
        got, _ = jckpt.restore_checkpoint(a / "step_00000003")
        jckpt.save_checkpoint(b, 3, got, chunk_bytes=4096)
    da, db = a / "step_00000003", b / "step_00000003"
    assert (db / "MANIFEST.json").read_bytes() == (da / "MANIFEST.json").read_bytes()
    bins = sorted(p.name for p in da.glob("*.bin"))
    assert bins == sorted(p.name for p in db.glob("*.bin")) and len(bins) == len(flat(ref))
    for name in bins:
        assert (db / name).read_bytes() == (da / name).read_bytes(), name


def _counting(monkeypatch):
    """Calls of the two digest wrappers (on the CPU their plain versions
    run and count no launch), with every host digest raising."""
    import importlib

    from repro_torch.kernels import checksum as ck

    def host_digest(*_a, **_k):
        raise AssertionError("a host digest ran")

    integrity = importlib.import_module("repro_torch.core.integrity")
    for fn in ("fingerprint_bytes", "fingerprint_many"):
        monkeypatch.setattr(integrity, fn, host_digest)
    monkeypatch.setattr(integrity.RunningFingerprint, "update", host_digest)
    for mod in ("repro_torch.core.dataplane", "repro_torch.core.transfer",
                "repro_torch.ckpt.checkpoint"):
        m = importlib.import_module(mod)
        for fn in ("fingerprint_bytes", "fingerprint_many", "fingerprint_view"):
            monkeypatch.setattr(m, fn, host_digest, raising=False)
    calls = {"checksum_words": 0, "checksum_many_words": 0}
    for name in calls:
        real = getattr(ck, name)

        def wrapped(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(ck, name, wrapped)
    return calls


def test_save_and_restore_take_no_host_digest(tmp_path, monkeypatch):
    """With every host digest raising, a save and a restore of torch state
    pass: the movers digest each chunk and its read-back on the device (one
    wrapper call each), and the restore digests each leaf's run of
    tile-aligned chunks in one ``checksum_many_words`` call and every other
    chunk in one ``checksum_words`` call. A flipped byte, in the aligned run
    and in the ragged last chunk, is still reported by chunk."""
    calls = _counting(monkeypatch)
    gen = torch.Generator().manual_seed(5)
    state = {"w": torch.randn(64, 4096, generator=gen),              # 8 aligned chunks
             "tail": torch.randn(100_003, generator=gen),            # 3 aligned + 1 ragged
             "b": torch.randn(777, generator=gen).to(torch.bfloat16),  # 1 ragged
             "step": torch.tensor(4, dtype=torch.int32)}             # 1 ragged
    mgr = CheckpointManager(tmp_path, device="cpu")
    mgr.save(4, state, chunk_bytes=128 * 1024)
    assert calls == {"checksum_many_words": 2 * (8 + 3), "checksum_words": 2 * 3}
    for name in calls:
        calls[name] = 0
    got, step = mgr.restore()
    assert calls == {"checksum_many_words": 2, "checksum_words": 3}
    assert step == 4
    for key, t in state.items():
        assert got[key].dtype == t.dtype and torch.equal(got[key], t), key
    man = json.loads((tmp_path / "step_00000004" / "MANIFEST.json").read_text())
    chunks = man["leaves"]["tail"]["chunks"]
    assert [c["length"] for c in chunks] == [128 * 1024] * 3 + [400_012 - 3 * 128 * 1024]
    with open(tmp_path / "step_00000004" / "tail.bin", "r+b") as fh:
        for c in (chunks[1], chunks[3]):
            fh.seek(c["offset"] + 7)
            byte = fh.read(1)
            fh.seek(c["offset"] + 7)
            fh.write(bytes([byte[0] ^ 0x04]))
    with pytest.raises(CorruptionError) as ei:
        mgr.restore()
    assert (ei.value.leaf, ei.value.bad_chunks) == ("tail", [1, 3])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_cuda_state_round_trips_and_digests_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core.integrity import Digest
    from repro_torch.kernels import digest_of

    gen = torch.Generator().manual_seed(3)
    state = {"wq": torch.randn(640, 320, generator=gen).to(torch.bfloat16),
             "ln": torch.randn(320, generator=gen),
             "step": torch.tensor(11, dtype=torch.int64)}
    state = {k: v.cuda() for k, v in state.items()}
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, state)
    got, _ = mgr.restore()
    man = json.loads((tmp_path / "step_00000001" / "MANIFEST.json").read_text())
    for key, t in state.items():
        assert got[key].device.type == "cuda" and torch.equal(got[key], t), key
        want = Digest.from_bytes(bytes.fromhex(man["leaves"][key]["digest"]))
        assert digest_of(got[key]) == want, key
        host = fingerprint_bytes(byte_image(t))           # the reference's oracle
        assert (host.h, host.length) == (want.h, want.length), key
