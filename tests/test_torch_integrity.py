"""The port's mergeable fingerprint algebra (``repro_torch.core.integrity``)
against the reference's.

Every test of ``tests/test_integrity.py`` runs here on the port, and each
case also runs the reference's function on the same draw: equal digests
(residues and length), equal byte serialisations, and equal refusals (the
same exception type and message). The pow-cache test counts the port's own
``pow_call_count``. Beside them, the device route the port's engine takes
for the same bytes (``core.dataplane.fingerprint_on_device`` and the fused
drain's ``_digest_rows_device``, the kernels' plain versions on the CPU) is
held to the reference's host digest.

``repro.core.integrity`` is plain numpy: it imports without JAX.
"""
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:      # optional dev dep: deterministic fallback examples
    from _hypofallback import given, settings, strategies as st

import repro.core.integrity as R
import repro_torch.core.integrity as T
from repro_torch.core.dataplane import _digest_rows_device, fingerprint_on_device
from repro_torch.core.integrity import (
    BASES, Digest, EMPTY_DIGEST, P,
    combine_at_offsets, fingerprint_bytes, merge_all, verify,
)

CPU = torch.device("cpu")


def _key(d):
    return (tuple(int(v) for v in d.h), int(d.length))


def _same(port_digest, ref_digest) -> bool:
    """One digest of each package: equal residues, length and bytes."""
    return (_key(port_digest) == _key(ref_digest)
            and port_digest.to_bytes() == ref_digest.to_bytes())


def _refusal(fn, *args):
    """``(exception type name, message)`` of a call that must raise."""
    with pytest.raises(Exception) as info:
        fn(*args)
    return type(info.value).__name__, str(info.value)


def brute(data: bytes) -> Digest:
    hs = []
    for r in BASES:
        h = 0
        for x in data:
            h = (h * r + x) % P
        hs.append(h)
    return Digest(tuple(hs), len(data))


def test_constants_equal_the_reference():
    assert (T.P, T.BASES, T.NBASES, T._BLOCK) == (R.P, R.BASES, R.NBASES, R._BLOCK)
    assert _same(T.EMPTY_DIGEST, R.EMPTY_DIGEST)


@given(st.binary(min_size=0, max_size=4096))
@settings(max_examples=80, deadline=None)
def test_matches_reference_polynomial(data):
    got = fingerprint_bytes(data)
    assert got == brute(data)
    assert _same(got, R.fingerprint_bytes(data))


def test_block_boundaries_exact():
    rng = np.random.default_rng(0)
    for n in (0, 1, 65535, 65536, 65537, 2 * 65536 + 13):
        d = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        got = fingerprint_bytes(d)
        assert got == brute(d)
        assert _same(got, R.fingerprint_bytes(d))


@given(st.binary(min_size=0, max_size=2000), st.data())
@settings(max_examples=60, deadline=None)
def test_merge_law_split_anywhere(data, dd):
    cut = dd.draw(st.integers(0, len(data)))
    full = fingerprint_bytes(data)
    left = fingerprint_bytes(data[:cut])
    right = fingerprint_bytes(data[cut:])
    assert left.merge(right) == full
    ref = R.fingerprint_bytes(data[:cut]).merge(R.fingerprint_bytes(data[cut:]))
    assert _same(left.merge(right), ref)
    assert left.shifted(len(data) - cut) == R.fingerprint_bytes(data[:cut]).shifted(
        len(data) - cut)


@given(st.lists(st.binary(min_size=0, max_size=300), min_size=1, max_size=8))
@settings(max_examples=50, deadline=None)
def test_merge_all_associative(parts):
    whole = b"".join(parts)
    got = merge_all(fingerprint_bytes(p) for p in parts)
    assert got == fingerprint_bytes(whole)
    assert _same(got, R.merge_all(R.fingerprint_bytes(p) for p in parts))


@given(st.lists(st.binary(min_size=1, max_size=200), min_size=1, max_size=8),
       st.randoms())
@settings(max_examples=50, deadline=None)
def test_combine_out_of_order(parts, rnd):
    whole = b"".join(parts)
    offs = []
    pos = 0
    for p in parts:
        offs.append((pos, p))
        pos += len(p)
    rnd.shuffle(offs)
    got = combine_at_offsets([(o, fingerprint_bytes(p)) for o, p in offs], len(whole))
    assert got == fingerprint_bytes(whole)
    want = R.combine_at_offsets([(o, R.fingerprint_bytes(p)) for o, p in offs], len(whole))
    assert _same(got, want)


@pytest.mark.parametrize("offsets, total", [
    ((0, 5), 9),        # gap at 4
    ((0, 3), 7),        # overlap
    ((0,), 5),          # wrong total
    ((4, 0), 12),       # out of order, then a gap at 8
    ((), 1),            # nothing covers a non-empty file
])
def test_combine_rejects_gaps_and_overlaps(offsets, total):
    """The reference's three refusals, and two more, refused alike: the same
    exception type and message in both packages."""
    a, ra = fingerprint_bytes(b"aaaa"), R.fingerprint_bytes(b"aaaa")
    got = _refusal(combine_at_offsets, [(o, a) for o in offsets], total)
    assert got[0] == "ValueError"
    assert got == _refusal(R.combine_at_offsets, [(o, ra) for o in offsets], total)


@given(st.binary(min_size=1, max_size=1000), st.data())
@settings(max_examples=80, deadline=None)
def test_detects_single_byte_corruption(data, dd):
    i = dd.draw(st.integers(0, len(data) - 1))
    delta = dd.draw(st.integers(1, 255))
    bad = bytearray(data)
    bad[i] = (bad[i] + delta) % 256
    good_d, bad_d = fingerprint_bytes(data), fingerprint_bytes(bytes(bad))
    assert not verify(good_d, bad_d)
    assert _same(bad_d, R.fingerprint_bytes(bytes(bad)))
    assert T.describe_mismatch(good_d, bad_d) == R.describe_mismatch(
        R.fingerprint_bytes(data), R.fingerprint_bytes(bytes(bad)))


@given(st.binary(min_size=2, max_size=500), st.data())
@settings(max_examples=50, deadline=None)
def test_detects_swaps(data, dd):
    i = dd.draw(st.integers(0, len(data) - 2))
    if data[i] == data[i + 1]:
        return
    bad = bytearray(data)
    bad[i], bad[i + 1] = bad[i + 1], bad[i]
    assert fingerprint_bytes(bytes(bad)) != fingerprint_bytes(data)
    assert _same(fingerprint_bytes(bytes(bad)), R.fingerprint_bytes(bytes(bad)))


def test_length_always_carried():
    # same residues would not suffice: zero-padding changes length, not hash 0
    z1 = fingerprint_bytes(b"\x00" * 10)
    z2 = fingerprint_bytes(b"\x00" * 20)
    assert z1.h == z2.h == (0, 0, 0, 0)
    assert not verify(z1, z2)
    assert _same(z1, R.fingerprint_bytes(b"\x00" * 10))
    assert T.describe_mismatch(z1, z2) == R.describe_mismatch(
        R.fingerprint_bytes(b"\x00" * 10), R.fingerprint_bytes(b"\x00" * 20))


def test_serialization_roundtrip():
    d = fingerprint_bytes(b"some chunk data")
    assert Digest.from_bytes(d.to_bytes()) == d
    assert EMPTY_DIGEST.merge(d) == d and d.merge(EMPTY_DIGEST) == d
    rd = R.fingerprint_bytes(b"some chunk data")
    assert d.to_bytes() == rd.to_bytes() and d.hexdigest() == rd.hexdigest()
    # each package reads the other's bytes back to the same digest
    assert _same(Digest.from_bytes(rd.to_bytes()), R.Digest.from_bytes(d.to_bytes()))
    assert _same(EMPTY_DIGEST.merge(d), R.EMPTY_DIGEST.merge(rd))


@pytest.mark.parametrize("build", [
    lambda D: D.from_bytes(b"\x00" * 23),             # short encoding
    lambda D: D.from_bytes(b"\x00" * 25),             # long encoding
    lambda D: D((0, 0, 0), 1),                        # three residues
    lambda D: D((0, 0, 0, P), 1),                     # residue out of the field
    lambda D: D((0, 0, 0, -1), 1),
    lambda D: D((0, 0, 0, 0), -1),                    # negative length
], ids=["short", "long", "three", "field", "negative-residue", "negative-length"])
def test_digest_refusals_equal_the_reference(build):
    got = _refusal(build, Digest)
    assert got[0] == "ValueError"
    assert got == _refusal(build, R.Digest)


# ---------------------------------------------------------------------------
# digest-algebra hot paths: batched / incremental / cached-pow variants
# ---------------------------------------------------------------------------
def test_fingerprint_many_matches_per_chunk():
    rng = np.random.default_rng(7)
    chunks = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
              for n in (0, 1, 17, 300, 300, 65536, 65537, 200_000, 17)]
    got = T.fingerprint_many(chunks)
    assert got == [fingerprint_bytes(c) for c in chunks]
    assert [_key(d) for d in got] == [_key(d) for d in R.fingerprint_many(chunks)]
    # the device route of the engine's fused drain: the same digests
    rows = [np.frombuffer(c, dtype=np.uint8) for c in chunks]
    assert [_key(d) for d in _digest_rows_device(rows, CPU)] == [_key(d) for d in got]


def test_fingerprint_many_and_rows_refusals_equal_the_reference():
    ragged = [b"abc", b"abcd"]
    got = _refusal(lambda: T.fingerprint_many(ragged, expect_equal=True))
    assert got[0] == "ValueError"
    assert got == _refusal(lambda: R.fingerprint_many(ragged, expect_equal=True))
    rows = [np.zeros(3, np.uint8), np.zeros(4, np.uint8)]
    got = _refusal(T.fingerprint_rows, rows)
    assert got[0] == "ValueError"
    assert got == _refusal(R.fingerprint_rows, rows)


def test_fingerprint_state_and_running_accumulator():
    from repro_torch.core.integrity import RunningFingerprint
    rng = np.random.default_rng(8)
    granules = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                for n in (4096, 1, 65537, 13, 0, 9000)]
    whole = fingerprint_bytes(b"".join(granules))
    acc = None
    rf = RunningFingerprint()
    racc = None
    rrf = R.RunningFingerprint()
    for g in granules:
        acc = fingerprint_bytes(g) if acc is None else fingerprint_bytes(g, state=acc)
        racc = R.fingerprint_bytes(g) if racc is None else R.fingerprint_bytes(g, state=racc)
        rf.update(g)
        rrf.update(g)
        assert _same(acc, racc) and _same(rf.digest(), rrf.digest())
        assert rf.length == rrf.length
    assert acc == whole == rf.digest()
    assert rf.length == whole.length
    # a running fingerprint started from a digest continues it
    start = fingerprint_bytes(granules[0])
    rf2 = RunningFingerprint(start)
    for g in granules[1:]:
        rf2.update(g)
    assert rf2.digest() == whole


def test_merge_chain_hits_pow_cache():
    """A chain of equal-length merges must cost O(1) bigint pow() calls, not
    4 per merge — counted by the port's own ``pow_call_count``."""
    ds = [fingerprint_bytes(bytes([i % 256]) * 1000) for i in range(65)]
    T.clear_pow_caches()
    before = T.pow_call_count()
    out = ds[0]
    for d in ds[1:]:
        out = out.merge(d)
    calls = T.pow_call_count() - before
    whole = b"".join(bytes([i % 256]) * 1000 for i in range(65))
    assert out == fingerprint_bytes(whole)
    assert _same(out, R.fingerprint_bytes(whole))
    assert calls * 5 <= 4 * 64          # >= 5x fewer than the uncached cost
    # the caches are the port's own: clearing them leaves the counter, and a
    # cold repeat of the chain pays the same few calls again
    T.clear_pow_caches()
    again = T.pow_call_count()
    out2 = ds[0]
    for d in ds[1:]:
        out2 = out2.merge(d)
    assert out2 == out and T.pow_call_count() - again == calls


# ---------------------------------------------------------------------------
# the device route of the same algebra (the kernels' plain versions here)
# ---------------------------------------------------------------------------
@given(st.binary(min_size=0, max_size=70_000))
@settings(max_examples=25, deadline=None)
def test_device_route_equals_the_reference(data):
    """``fingerprint_on_device`` — the route every digest of the port's
    engine takes — equals the reference's host digest at any length."""
    assert _key(fingerprint_on_device(data, CPU)) == _key(R.fingerprint_bytes(data))


def test_device_route_tile_aligned_batch_equals_the_reference():
    """Equal tile-aligned lengths go through one ``checksum_many_words``
    call (its plain version here): each row equals the reference's."""
    rng = np.random.default_rng(9)
    rows = [rng.integers(0, 256, 2 * 32768, dtype=np.uint8).tobytes() for _ in range(3)]
    got = fingerprint_on_device(rows, CPU)
    assert [_key(d) for d in got] == [_key(R.fingerprint_bytes(r)) for r in rows]
    with pytest.raises(ValueError, match="equal lengths"):
        fingerprint_on_device([rows[0], rows[1][:-4]], CPU)
