"""Client-driven chunk planning (paper §3.1).

The Globus service — the *client* in client-driven chunking — knows the
configuration of both endpoints (number of data movers, pipeline depth,
link characteristics) and can therefore plan chunking globally, which the
older server-side striping (SPAS/SPOR) could not. In this framework the
"client" is the launcher/compiler: it holds the whole mesh/topology and emits
a static chunk plan.

The paper's empirical guidance encoded here:

  * enough chunks to saturate every parallel channel: the paper explains the
    large-chunk falloff by `n_chunks < concurrency x parallelism (64 x 4 = 256)`
    (§4.2) — so we target n_chunks >= movers * pipeline_depth;
  * chunks must not be too small, or per-chunk (control channel / pipelining)
    overheads dominate — the 50 MB side of the Fig. 6 curve;
  * the sweet spot measured was 200-500 MB for 64 movers over a 100 Gb/s WAN
    (§4.3): defaults below reproduce that via the simulator;
  * chunk boundaries are aligned so partial checksums and partial restarts
    compose (alignment also keeps device chunk slices on tile boundaries).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

MiB = 1024 * 1024
GiB = 1024 * MiB


@dataclasses.dataclass(frozen=True)
class Chunk:
    """One disjoint byte range of a transfer, assigned to a mover."""

    index: int
    offset: int
    length: int
    mover: int

    @property
    def end(self) -> int:
        return self.offset + self.length


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    total_bytes: int
    chunk_bytes: int           # nominal size (last chunk may be short)
    movers: int
    pipeline_depth: int
    chunks: tuple[Chunk, ...]

    @property
    def n_chunks(self) -> int:
        return len(self.chunks)

    def for_mover(self, mover: int) -> tuple[Chunk, ...]:
        return tuple(c for c in self.chunks if c.mover == mover)

    def validate(self) -> None:
        """Invariants: disjoint, in-order, exact coverage (property-tested)."""
        pos = 0
        for i, c in enumerate(self.chunks):
            if c.index != i:
                raise AssertionError(f"chunk {i} has index {c.index}")
            if c.offset != pos or c.length <= 0:
                raise AssertionError(f"coverage broken at chunk {i}: offset={c.offset} pos={pos}")
            if not (0 <= c.mover < self.movers):
                raise AssertionError(f"chunk {i} assigned to invalid mover {c.mover}")
            pos = c.end
        if pos != self.total_bytes:
            raise AssertionError(f"chunks cover {pos} != total {self.total_bytes}")


def plan_chunks(
    total_bytes: int,
    movers: int,
    *,
    chunk_bytes: int | None = None,
    pipeline_depth: int = 4,
    min_chunk: int = 16 * MiB,
    max_chunk: int = 512 * MiB,
    alignment: int = 4,
    max_chunks: int = 1 << 20,
) -> ChunkPlan:
    """Plan chunks for one transfer using the paper's heuristic.

    With ``chunk_bytes=None`` the size is derived: split so every mover gets
    ~``pipeline_depth`` chunks (keeps pipelining busy, §3.1/Fig. 3), clamped to
    [min_chunk, max_chunk] (Fig. 6 sweet spot). A transfer smaller than
    ``min_chunk * 2`` is not chunked at all — mirroring the paper's finding
    that chunking only pays for large files (§4.5).
    """
    if total_bytes < 0:
        raise ValueError("total_bytes must be >= 0")
    if movers < 1:
        raise ValueError("movers must be >= 1")
    if alignment < 1:
        raise ValueError("alignment must be >= 1")
    if total_bytes == 0:
        return ChunkPlan(0, 0, movers, pipeline_depth, ())

    if chunk_bytes is None:
        target = total_bytes / (movers * pipeline_depth)
        chunk_bytes = int(min(max(target, min_chunk), max_chunk))
        if total_bytes < 2 * min_chunk:
            chunk_bytes = total_bytes  # too small to chunk
    chunk_bytes = max(alignment, _round_up(min(chunk_bytes, total_bytes), alignment))
    # chunk-count ceiling: control-plane state (journal, queue) stays bounded
    # regardless of requested size — the Globus-service-side scalability guard.
    if math.ceil(total_bytes / chunk_bytes) > max_chunks:
        chunk_bytes = _round_up(math.ceil(total_bytes / max_chunks), alignment)

    n = math.ceil(total_bytes / chunk_bytes)
    chunks = []
    pos = 0
    for i in range(n):
        ln = min(chunk_bytes, total_bytes - pos)
        # Round-robin assignment; the transfer engine additionally work-steals,
        # so static assignment only seeds locality (paper movers pull chunks).
        chunks.append(Chunk(index=i, offset=pos, length=ln, mover=i % movers))
        pos += ln
    plan = ChunkPlan(total_bytes, chunk_bytes, movers, pipeline_depth, tuple(chunks))
    plan.validate()
    return plan


def _round_up(x: int, align: int) -> int:
    return ((x + align - 1) // align) * align


# ---------------------------------------------------------------------------
# byte-region algebra — the substrate of mid-flight tail re-planning
# ---------------------------------------------------------------------------
# A "region" is an (offset, length) byte range. The autotuner re-partitions
# the UNTRANSFERRED tail of a transfer by (1) subtracting journaled custody
# regions from the file, then (2) carving fresh chunks out of the gaps — so a
# re-plan can only ever cut at un-journaled boundaries, and the merge-law
# digest chain over the final chunk set still tiles the file exactly.

def merge_regions(regions: Sequence[tuple[int, int]]) -> list[tuple[int, int]]:
    """Sort and coalesce disjoint (offset, length) regions; adjacency merges,
    overlap is a caller bug and raises."""
    out: list[list[int]] = []
    for off, ln in sorted((int(o), int(n)) for o, n in regions):
        if ln < 0:
            raise ValueError(f"negative region length {ln} at offset {off}")
        if ln == 0:
            continue
        if out and off < out[-1][0] + out[-1][1]:
            raise ValueError(
                f"overlapping regions at byte {off} (previous ends at "
                f"{out[-1][0] + out[-1][1]})"
            )
        if out and off == out[-1][0] + out[-1][1]:
            out[-1][1] += ln
        else:
            out.append([off, ln])
    return [(o, n) for o, n in out]


def subtract_regions(
    total_bytes: int, covered: Sequence[tuple[int, int]]
) -> list[tuple[int, int]]:
    """The gaps of [0, total_bytes) not covered by ``covered`` regions."""
    gaps: list[tuple[int, int]] = []
    pos = 0
    for off, ln in merge_regions(covered):
        if off + ln > total_bytes:
            raise ValueError(f"region ({off}, {ln}) exceeds total {total_bytes}")
        if off > pos:
            gaps.append((pos, off - pos))
        pos = off + ln
    if pos < total_bytes:
        gaps.append((pos, total_bytes - pos))
    return gaps


def partition_regions(
    regions: Sequence[tuple[int, int]],
    chunk_bytes: int,
    *,
    start_index: int = 0,
    movers: int = 1,
    alignment: int = 1,
) -> list[Chunk]:
    """Carve ~``chunk_bytes`` chunks out of disjoint byte regions.

    This is the tail re-plan primitive: indices run sequentially from
    ``start_index`` (the caller allocates a band that cannot collide with
    journaled ids), interior cut points land on ``alignment`` multiples
    relative to each region's start, and region boundaries themselves are
    never moved — a journaled chunk's bytes are untouchable by construction
    because they are simply not in ``regions``.
    """
    if chunk_bytes < 1:
        raise ValueError("chunk_bytes must be >= 1")
    if alignment < 1:
        raise ValueError("alignment must be >= 1")
    chunk_bytes = max(alignment, _round_up(chunk_bytes, alignment))
    chunks: list[Chunk] = []
    i = start_index
    for off, ln in merge_regions(regions):
        pos = off
        end = off + ln
        while pos < end:
            take = min(chunk_bytes, end - pos)
            chunks.append(Chunk(index=i, offset=pos, length=take,
                                mover=(i - start_index) % max(1, movers)))
            pos += take
            i += 1
    return chunks


# ---------------------------------------------------------------------------
# intra-chunk striping — split one chunk across N concurrent movers
# ---------------------------------------------------------------------------
# The paper's headline numbers come from concurrency x parallelism streams
# (64 x 4, §4.2); a single huge chunk on one mover is exactly the
# single-stream ceiling the Petascale DTN Project measured. A StripePlan
# splits one chunk's byte range into N disjoint stripes so N movers (each one
# "stream") carry it concurrently. Because the merge-law digest algebra is
# partition-refinement-closed, per-stripe digests fold into the chunk digest
# with combine_at_offsets — no extra hashing pass.

@dataclasses.dataclass(frozen=True)
class Stripe:
    """One disjoint byte sub-range of a parent chunk."""

    seq: int          # 0..n_stripes-1 within the parent
    offset: int       # absolute file offset
    length: int

    @property
    def end(self) -> int:
        return self.offset + self.length


@dataclasses.dataclass(frozen=True)
class StripePlan:
    chunk: Chunk
    stripes: tuple[Stripe, ...]

    @property
    def n_stripes(self) -> int:
        return len(self.stripes)

    def validate(self) -> None:
        """Invariants: stripes tile the parent chunk exactly, in order."""
        pos = self.chunk.offset
        for i, s in enumerate(self.stripes):
            if s.seq != i:
                raise AssertionError(f"stripe {i} has seq {s.seq}")
            if s.offset != pos or s.length <= 0:
                raise AssertionError(
                    f"stripe coverage broken at {i}: offset={s.offset} pos={pos}")
            pos = s.end
        if pos != self.chunk.end:
            raise AssertionError(
                f"stripes cover up to {pos} != chunk end {self.chunk.end}")


def plan_stripes(
    chunk: Chunk,
    stripes: int,
    *,
    stripe_min_bytes: int = 1 * MiB,
    alignment: int = 1,
) -> StripePlan:
    """Split ``chunk`` into up to ``stripes`` disjoint sub-ranges.

    The effective stripe count is capped so every stripe carries at least
    ``stripe_min_bytes`` (striping tiny chunks only adds per-item overhead —
    the same reasoning as the 50 MB side of the Fig. 6 curve, one level
    down). Interior cut points land on ``alignment`` multiples relative to
    the chunk start so partial checksums and device slices stay composable.
    A plan with one stripe is valid and means "do not stripe".
    """
    if stripes < 1:
        raise ValueError("stripes must be >= 1")
    if stripe_min_bytes < 1:
        raise ValueError("stripe_min_bytes must be >= 1")
    if alignment < 1:
        raise ValueError("alignment must be >= 1")
    n = min(stripes, chunk.length // stripe_min_bytes)
    n = max(1, n)
    # Even split, rounded up to alignment; the last stripe absorbs the tail.
    width = _round_up(math.ceil(chunk.length / n), alignment)
    out: list[Stripe] = []
    pos = chunk.offset
    seq = 0
    while pos < chunk.end:
        take = min(width, chunk.end - pos)
        out.append(Stripe(seq=seq, offset=pos, length=take))
        pos += take
        seq += 1
    plan = StripePlan(chunk=chunk, stripes=tuple(out))
    plan.validate()
    return plan


def plan_auto(
    total_bytes: int,
    movers: int,
    cost_model: Callable[[int], float],
    *,
    candidates: Sequence[int] = (
        16 * MiB, 50 * MiB, 100 * MiB, 200 * MiB, 500 * MiB, 1000 * MiB,
        2000 * MiB, 5000 * MiB,
    ),
    pipeline_depth: int = 4,
    alignment: int = 4,
) -> ChunkPlan:
    """Automated chunk-size selection (the paper's §6 'further optimization').

    ``cost_model(chunk_bytes) -> predicted_seconds`` is typically
    ``simulator.predict_transfer_time`` — the same calibrated model used to
    reproduce the paper's figures — evaluated per candidate size.
    """
    if total_bytes <= 0:
        return plan_chunks(total_bytes, movers, pipeline_depth=pipeline_depth)
    best, best_t = None, float("inf")
    for s in candidates:
        if s > total_bytes:
            continue
        t = cost_model(s)
        if t < best_t:
            best, best_t = s, t
    if best is None:
        best = total_bytes
    return plan_chunks(
        total_bytes, movers, chunk_bytes=best,
        pipeline_depth=pipeline_depth, alignment=alignment,
        min_chunk=1, max_chunk=total_bytes,
    )


def plan_for_array(
    shape: Sequence[int],
    dtype_bytes: int,
    movers: int,
    *,
    pipeline_depth: int = 4,
    min_chunk: int = 4 * MiB,
    max_chunk: int = 256 * MiB,
) -> ChunkPlan:
    """Chunk a tensor's byte image; boundaries stay element-aligned so device
    slices, host writes, and per-chunk digests all cut at the same offsets."""
    total = int(math.prod(shape)) * dtype_bytes
    return plan_chunks(
        total, movers, pipeline_depth=pipeline_depth,
        min_chunk=min_chunk, max_chunk=max_chunk, alignment=dtype_bytes,
    )
