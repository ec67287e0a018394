"""The port's chunk planning, region algebra and integrity merge law, against
the reference's.

Every test of ``tests/test_chunker.py``, ``tests/test_plan_properties.py``
and ``tests/test_integrity_properties.py`` runs here on the port: plan
invariants, the paper's sizing rules, ``plan_auto``'s argmin, element
alignment, zero-byte and sub-minimum files, the 1 TiB edge, the re-plan
laws over ``subtract_regions`` / ``partition_regions`` / ``merge_regions``,
and the merge law's order independence, associativity, refinement and
collision hunt.

Then the checks across packages, on the same inputs (hypothesis draws, or
numpy ``default_rng(seed)``): ``plan_chunks``, ``plan_auto``,
``plan_for_array``, ``plan_stripes``, ``merge_regions``,
``partition_regions`` and the tail re-plan (the gaps a journal leaves,
re-cut) give equal plans, and ``combine_at_offsets`` / ``merge_all`` equal
digests on random partitions. The reference is imported inside the tests,
so the card's machine, which has no JAX, can collect this file.
"""
import importlib
import math
import random

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:      # optional dev dep: deterministic fallback examples
    from _hypofallback import given, settings, strategies as st

from repro_torch.core.chunker import (
    GiB,
    MiB,
    Chunk,
    merge_regions,
    partition_regions,
    plan_auto,
    plan_chunks,
    plan_for_array,
    plan_stripes,
    subtract_regions,
)
from repro_torch.core.integrity import (
    combine_at_offsets,
    fingerprint_bytes,
    merge_all,
    verify,
)

TiB = 1024 * GiB


def _ref(module="core.chunker"):
    return importlib.import_module(f"repro.{module}")


def _plan_key(p):
    return (p.total_bytes, p.chunk_bytes, p.movers, p.pipeline_depth,
            tuple((c.index, c.offset, c.length, c.mover) for c in p.chunks))


def _chunks_key(chunks):
    return [(c.index, c.offset, c.length, c.mover) for c in chunks]


def _digest_key(d):
    return (tuple(int(v) for v in d.h), int(d.length))


def _outcome(fn, *args, **kw):
    """What a call gives: its result, or its error's type and message."""
    try:
        return ("ok", fn(*args, **kw))
    except ValueError as e:
        return ("error", type(e).__name__, str(e))


# ---------------------------------------------------------------------------
# tests/test_chunker.py on the port
# ---------------------------------------------------------------------------
@given(
    total=st.integers(0, 10**12),
    movers=st.integers(1, 128),
    depth=st.integers(1, 8),
)
@settings(max_examples=100, deadline=None)
def test_plan_invariants(total, movers, depth):
    plan = plan_chunks(total, movers, pipeline_depth=depth)
    plan.validate()
    assert plan.total_bytes == total
    if total:
        used = {c.mover for c in plan.chunks}
        assert len(used) == min(movers, plan.n_chunks)


@given(total=st.integers(1, 10**11), movers=st.integers(1, 64),
       chunk=st.integers(1, 10**9))
@settings(max_examples=100, deadline=None)
def test_explicit_chunk_size(total, movers, chunk):
    plan = plan_chunks(total, movers, chunk_bytes=chunk, min_chunk=1,
                       max_chunk=10**12, alignment=1, max_chunks=4096)
    plan.validate()
    eff = max(chunk, -(-total // 4096))
    assert all(c.length <= max(eff, 1) for c in plan.chunks)
    assert plan.n_chunks <= 4096


def test_heuristic_respects_paper_rules():
    plan = plan_chunks(500 * 10**9, 64, pipeline_depth=4)
    assert plan.n_chunks >= 64 * 4
    small = plan_chunks(8 * MiB, 64)
    assert small.n_chunks == 1
    plan = plan_chunks(10**9 + 3, 8, alignment=4)
    assert all(c.offset % 4 == 0 for c in plan.chunks)


def test_plan_auto_picks_simulated_optimum():
    def cost(chunk_bytes):
        return abs(chunk_bytes - 200 * MiB) + 1.0
    plan = plan_auto(10**11, 64, cost)
    assert plan.chunk_bytes == 200 * MiB


def test_plan_for_array_element_alignment():
    plan = plan_for_array((4096, 4096), 2, movers=8)
    assert all(c.offset % 2 == 0 and c.length % 2 == 0 for c in plan.chunks[:-1])


def test_invalid_args():
    with pytest.raises(ValueError):
        plan_chunks(-1, 4)
    with pytest.raises(ValueError):
        plan_chunks(10, 0)


# ---------------------------------------------------------------------------
# tests/test_plan_properties.py on the port
# ---------------------------------------------------------------------------
@settings(max_examples=40, deadline=None)
@given(
    total=st.integers(0, 1 << 28),
    movers=st.integers(1, 128),
    depth=st.integers(1, 8),
)
def test_plan_chunks_covers_exactly(total, movers, depth):
    plan = plan_chunks(total, movers, pipeline_depth=depth)
    plan.validate()
    if total == 0:
        assert plan.n_chunks == 0
    else:
        assert plan.n_chunks >= 1
        assert sum(c.length for c in plan.chunks) == total


@settings(max_examples=25, deadline=None)
@given(total=st.integers(1, 32 * MiB - 1))
def test_small_file_is_not_chunked(total):
    plan = plan_chunks(total, 64, min_chunk=16 * MiB)
    if total < 2 * 16 * MiB:
        assert plan.n_chunks == 1
        assert plan.chunks[0].length == total


def test_zero_byte_plans():
    assert plan_chunks(0, 8).n_chunks == 0
    assert plan_auto(0, 8, lambda s: 1.0).n_chunks == 0
    assert partition_regions([], 1024) == []
    assert subtract_regions(0, []) == []


@settings(max_examples=12, deadline=None)
@given(delta=st.integers(-4096, 4096), movers=st.integers(1, 64))
def test_one_tebibyte_edge(delta, movers):
    total = TiB + delta
    plan = plan_chunks(total, movers)
    plan.validate()
    assert plan.chunk_bytes <= 512 * MiB + 4
    assert plan.n_chunks <= 1 << 20


def test_max_chunks_ceiling_enforced():
    plan = plan_chunks(1 << 30, 4, chunk_bytes=64, max_chunks=1024,
                       alignment=1)
    assert plan.n_chunks <= 1024
    plan.validate()


@settings(max_examples=20, deadline=None)
@given(total=st.integers(1, 1 << 32), movers=st.integers(1, 64))
def test_plan_auto_picks_a_candidate_and_covers(total, movers):
    calls = []

    def cost(s):
        calls.append(s)
        return abs(math.log(s / (100 * MiB)))

    plan = plan_auto(total, movers, cost)
    plan.validate()
    if calls:
        seen = list(calls)
        assert plan.chunk_bytes <= max(seen) + 4
        best = min(seen, key=lambda s: abs(math.log(s / (100 * MiB))))
        assert abs(plan.chunk_bytes - min(best, total)) <= 4


@settings(max_examples=30, deadline=None)
@given(
    total=st.integers(1, 1 << 20),
    cb=st.integers(256, 1 << 20),
    align=st.integers(1, 4096),
)
def test_partition_matches_plan_chunks_on_whole_file(total, cb, align):
    plan = plan_chunks(total, 1, chunk_bytes=cb, min_chunk=1,
                       max_chunk=1 << 62, alignment=align)
    carved = partition_regions([(0, total)], cb, alignment=align)
    assert [(c.offset, c.length) for c in plan.chunks] == \
        [(c.offset, c.length) for c in carved]


def _done_regions(plan, pct):
    """A pseudo-random subset of the plan's chunks, as journaled regions
    (a Knuth-hash selection keeps the draw count constant)."""
    return [(plan.chunks[i].offset, plan.chunks[i].length)
            for i in range(plan.n_chunks) if (i * 2654435761 + pct) % 100 < pct]


@settings(max_examples=30, deadline=None)
@given(
    total=st.integers(1, 1 << 20),
    cb=st.integers(512, 1 << 18),
    pct=st.integers(0, 100),
)
def test_replan_is_idempotent_and_respects_done_regions(total, cb, pct):
    plan = plan_chunks(total, 4, chunk_bytes=cb, min_chunk=1,
                       max_chunk=1 << 62)
    done = _done_regions(plan, pct)
    gaps = subtract_regions(total, done)
    carved = partition_regions(gaps, cb, start_index=plan.n_chunks)
    for c in carved:
        for off, ln in done:
            assert not (c.offset < off + ln and off < c.end)
    every = [(c.offset, c.length) for c in carved] + done
    assert merge_regions(every) == ([(0, total)] if total else [])
    again = partition_regions([(c.offset, c.length) for c in carved], cb,
                              start_index=plan.n_chunks)
    assert [(c.offset, c.length) for c in again] == \
        [(c.offset, c.length) for c in carved]


def _disjoint_regions(total, cuts):
    pts = sorted({c % (total + 1) for c in cuts})
    return [(a, b - a) for a, b in zip(pts[::2], pts[1::2]) if b > a]


@settings(max_examples=30, deadline=None)
@given(
    total=st.integers(0, 1 << 24),
    cuts=st.lists(st.integers(0, (1 << 24) - 1), min_size=0, max_size=16),
)
def test_subtract_merge_roundtrip(total, cuts):
    regions = _disjoint_regions(total, cuts)
    gaps = subtract_regions(total, regions)
    assert merge_regions(gaps + regions) == ([(0, total)] if total else [])
    for goff, gln in gaps:
        for off, ln in regions:
            assert not (goff < off + ln and off < goff + gln)


# ---------------------------------------------------------------------------
# tests/test_integrity_properties.py on the port
# ---------------------------------------------------------------------------
def _partition(data: bytes, rnd: random.Random) -> list[tuple[int, bytes]]:
    cuts = sorted({0, len(data), *(rnd.randrange(len(data) + 1)
                                   for _ in range(rnd.randrange(0, 8)))})
    return [(a, data[a:b]) for a, b in zip(cuts, cuts[1:]) if b > a]


@given(st.binary(min_size=1, max_size=2048), st.randoms())
@settings(max_examples=60, deadline=None)
def test_combine_is_order_independent(data, rnd):
    parts = [(off, fingerprint_bytes(c)) for off, c in _partition(data, rnd)]
    whole = fingerprint_bytes(data)
    for _ in range(4):
        rnd.shuffle(parts)
        assert combine_at_offsets(parts, len(data)) == whole


@given(st.binary(min_size=1, max_size=2048), st.randoms())
@settings(max_examples=60, deadline=None)
def test_any_two_partitions_agree(data, rnd):
    p1, p2 = _partition(data, rnd), _partition(data, rnd)
    whole = fingerprint_bytes(data)
    for parts in (p1, p2):
        digs = [fingerprint_bytes(c) for _off, c in parts]
        assert merge_all(digs) == whole
        assert combine_at_offsets(
            [(off, d) for (off, _c), d in zip(parts, digs)], len(data)
        ) == whole


@given(st.binary(min_size=2, max_size=1024), st.randoms())
@settings(max_examples=40, deadline=None)
def test_merge_is_associative(data, rnd):
    i = rnd.randrange(1, len(data))
    j = rnd.randrange(i, len(data))
    a, b, c = data[:i], data[i:j], data[j:]
    da, db, dc = map(fingerprint_bytes, (a, b, c))
    assert da.merge(db).merge(dc) == da.merge(db.merge(dc)) == fingerprint_bytes(data)


@given(st.binary(min_size=4, max_size=1024), st.randoms())
@settings(max_examples=40, deadline=None)
def test_refining_a_partition_preserves_digest(data, rnd):
    coarse = _partition(data, rnd)
    fine = []
    for off, chunk in coarse:
        for sub_off, sub in _partition(chunk, rnd):
            fine.append((off + sub_off, fingerprint_bytes(sub)))
    assert combine_at_offsets(fine, len(data)) == fingerprint_bytes(data)


def _perturbations(seed=0xC0FFEE, trials=10_000):
    """The reference's collision hunt: seeded equal-length perturbations
    (bit flip, byte rewrite, neighbour swap, block reversal)."""
    rnd = random.Random(seed)
    for trial in range(trials):
        n = rnd.randrange(1, 257)
        data = bytearray(rnd.getrandbits(8) for _ in range(n))
        bad = bytearray(data)
        mode = trial % 4
        if mode == 0:
            i = rnd.randrange(n)
            bad[i] ^= 1 << rnd.randrange(8)
        elif mode == 1:
            i = rnd.randrange(n)
            bad[i] = (bad[i] + rnd.randrange(1, 256)) % 256
        elif mode == 2 and n >= 2:
            i = rnd.randrange(n - 1)
            if bad[i] == bad[i + 1]:
                bad[i] ^= 0xFF
            else:
                bad[i], bad[i + 1] = bad[i + 1], bad[i]
        else:
            i = rnd.randrange(n)
            j = rnd.randrange(i, n) + 1
            if bytes(bad[i:j]) == bytes(bad[i:j][::-1]):
                bad[i] ^= 0x55
            else:
                bad[i:j] = bad[i:j][::-1]
        yield trial, bytes(data), bytes(bad)


def test_no_collisions_in_10k_random_trials():
    for trial, data, bad in _perturbations():
        assert not verify(fingerprint_bytes(data), fingerprint_bytes(bad)), (
            f"collision at trial {trial}: data={data.hex()} bad={bad.hex()}")


def test_numpy_and_bytes_paths_agree_on_random_streams():
    rng = np.random.default_rng(7)
    for n in (1, 63, 64, 65, 1000, 65537):
        arr = rng.integers(0, 256, n, dtype=np.uint8)
        assert fingerprint_bytes(arr) == fingerprint_bytes(arr.tobytes())


# ---------------------------------------------------------------------------
# across packages: the planning algebra
# ---------------------------------------------------------------------------
@given(
    total=st.one_of(st.integers(0, 1 << 28), st.integers(TiB - 4096, TiB + 4096),
                    st.integers(0, 10**12)),
    movers=st.integers(1, 128),
    depth=st.integers(1, 8),
    align=st.integers(1, 8),
)
@settings(max_examples=80, deadline=None)
def test_plan_chunks_equal_across_packages(total, movers, depth, align):
    assert _plan_key(plan_chunks(total, movers, pipeline_depth=depth, alignment=align)) == \
        _plan_key(_ref().plan_chunks(total, movers, pipeline_depth=depth, alignment=align))


@given(total=st.integers(0, 10**11), movers=st.integers(1, 64),
       chunk=st.integers(1, 10**9), cap=st.integers(1, 4096))
@settings(max_examples=60, deadline=None)
def test_explicit_plans_equal_across_packages(total, movers, chunk, cap):
    kw = dict(chunk_bytes=chunk, min_chunk=1, max_chunk=10**12, alignment=1, max_chunks=cap)
    assert _plan_key(plan_chunks(total, movers, **kw)) == \
        _plan_key(_ref().plan_chunks(total, movers, **kw))


@given(total=st.integers(1, 32 * MiB - 1), movers=st.integers(1, 64))
@settings(max_examples=25, deadline=None)
def test_sub_minimum_plans_equal_across_packages(total, movers):
    assert _plan_key(plan_chunks(total, movers, min_chunk=16 * MiB)) == \
        _plan_key(_ref().plan_chunks(total, movers, min_chunk=16 * MiB))


def test_invalid_args_raise_alike():
    for args in ((-1, 4), (10, 0)):
        for fn in (plan_chunks, _ref().plan_chunks):
            with pytest.raises(ValueError):
                fn(*args)


@given(total=st.integers(0, 1 << 42), movers=st.integers(1, 64),
       optimum=st.integers(1, 1 << 33))
@settings(max_examples=25, deadline=None)
def test_plan_auto_equal_across_packages(total, movers, optimum):
    def cost(s):
        return abs(math.log(s / optimum))
    assert _plan_key(plan_auto(total, movers, cost)) == \
        _plan_key(_ref().plan_auto(total, movers, cost))


@pytest.mark.parametrize("shape, itemsize, movers", [
    ((4096, 4096), 2, 8), ((1,), 4, 1), ((0, 16), 4, 4), ((3, 5, 7), 1, 2),
    ((65536, 5120), 2, 16), ((1 << 20,), 8, 64), ((14336, 5120), 4, 8)])
def test_plan_for_array_equal_across_packages(shape, itemsize, movers):
    assert _plan_key(plan_for_array(shape, itemsize, movers=movers)) == \
        _plan_key(_ref().plan_for_array(shape, itemsize, movers=movers))


@given(st.integers(1, 1 << 40), st.integers(0, 1 << 40), st.integers(1, 16),
       st.integers(1, 1 << 30), st.integers(0, 12))
@settings(max_examples=80, deadline=None)
def test_plan_stripes_equal_across_packages(length, offset, stripes, min_bytes, align_pow):
    ref = _ref()
    kw = dict(stripe_min_bytes=min_bytes, alignment=1 << align_pow)
    got = plan_stripes(Chunk(5, offset, length, 2), stripes, **kw)
    want = ref.plan_stripes(ref.Chunk(5, offset, length, 2), stripes, **kw)
    assert [(s.seq, s.offset, s.length) for s in got.stripes] == \
        [(s.seq, s.offset, s.length) for s in want.stripes]
    assert (got.chunk.index, got.chunk.offset, got.chunk.length, got.chunk.mover) == \
        (want.chunk.index, want.chunk.offset, want.chunk.length, want.chunk.mover)


def test_plan_stripes_rejects_alike():
    ref = _ref()
    for args, kw in (((0,), {}), ((2,), {"stripe_min_bytes": 0}), ((2,), {"alignment": 0})):
        for mod in (ref, importlib.import_module("repro_torch.core.chunker")):
            with pytest.raises(ValueError):
                mod.plan_stripes(mod.Chunk(0, 0, MiB, 0), *args, **kw)


@given(st.lists(st.tuples(st.integers(0, 1 << 20), st.integers(-2, 1 << 16)), max_size=24))
@settings(max_examples=40, deadline=None)
def test_merge_regions_equal_across_packages(regions):
    """Equal merges, and equal errors for overlapping or negative regions."""
    assert _outcome(merge_regions, regions) == _outcome(_ref().merge_regions, regions)


@given(total=st.integers(0, 1 << 24),
       cuts=st.lists(st.integers(0, (1 << 24) - 1), max_size=16))
@settings(max_examples=40, deadline=None)
def test_subtract_regions_equal_across_packages(total, cuts):
    regions = _disjoint_regions(total, cuts)
    assert subtract_regions(total, regions) == _ref().subtract_regions(total, regions)


@given(total=st.integers(1, 1 << 22), cb=st.integers(256, 1 << 20),
       pct=st.integers(0, 100), align=st.integers(1, 4096), start=st.integers(0, 1 << 20))
@settings(max_examples=30, deadline=None)
def test_tail_replan_equal_across_packages(total, cb, pct, align, start):
    """The gaps a journal leaves, re-cut at a new size: the same chunks in
    both packages, also re-cut once more (the re-plan's fixpoint)."""
    ref = _ref()
    plan = plan_chunks(total, 4, chunk_bytes=cb, min_chunk=1, max_chunk=1 << 62)
    done = _done_regions(plan, pct)
    gaps = subtract_regions(total, done)
    assert gaps == ref.subtract_regions(total, done)
    got = partition_regions(gaps, cb, alignment=align, start_index=start)
    want = ref.partition_regions(gaps, cb, alignment=align, start_index=start)
    assert _chunks_key(got) == _chunks_key(want)
    again = [(c.offset, c.length) for c in got]
    assert _chunks_key(partition_regions(again, cb // 2 or 1, start_index=start)) == \
        _chunks_key(ref.partition_regions(again, cb // 2 or 1, start_index=start))


# ---------------------------------------------------------------------------
# across packages: the merge law on random partitions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(8))
def test_merge_law_equal_across_packages(seed):
    """On ``default_rng(seed)`` streams cut into random partitions, the
    port's ``combine_at_offsets`` and ``merge_all`` of its own part digests
    equal the reference's, and both equal the whole stream's digest."""
    ref = _ref("core.integrity")
    rng = np.random.default_rng(seed)
    rnd = random.Random(seed)
    for n in (1, 17, 4096, 65537, 200_003):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        parts = _partition(data, rnd)
        mine = [(off, fingerprint_bytes(c)) for off, c in parts]
        theirs = [(off, ref.fingerprint_bytes(c)) for off, c in parts]
        assert [_digest_key(d) for _o, d in mine] == [_digest_key(d) for _o, d in theirs]
        whole = _digest_key(ref.fingerprint_bytes(data))
        assert _digest_key(merge_all(d for _o, d in mine)) == whole
        assert _digest_key(ref.merge_all(d for _o, d in theirs)) == whole
        rnd.shuffle(mine)
        rnd.shuffle(theirs)
        assert _digest_key(combine_at_offsets(mine, n)) == whole
        assert _digest_key(ref.combine_at_offsets(theirs, n)) == whole


def test_collision_hunt_digests_equal_across_packages():
    """The first 2 000 trials of the collision hunt: every digest the port
    takes equals the reference's."""
    ref = _ref("core.integrity")
    for _trial, data, bad in _perturbations(trials=2_000):
        for x in (data, bad):
            assert _digest_key(fingerprint_bytes(x)) == _digest_key(ref.fingerprint_bytes(x))
