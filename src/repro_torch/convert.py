"""Carry state across from the reference package.

Plans and digests made by ``repro`` become the port's own objects here, so
one plan can drive both engines and their digests compare as equals. Both
functions are duck-typed — ``.h``/``.length`` for a digest, the
``ChunkPlan``/``Chunk`` fields for a plan — and import nothing of ``repro``.
The other half of the shared state is the on-disk chunk journal, whose
format the two packages write byte for byte alike.
"""
from __future__ import annotations

from repro_torch.core.chunker import Chunk, ChunkPlan
from repro_torch.core.integrity import Digest


def digest_from_reference(d) -> Digest:
    """The port's ``Digest`` for a reference digest (any object with
    ``h``, a sequence of four residues, and ``length``)."""
    return Digest(tuple(int(v) for v in d.h), int(d.length))


def plan_from_reference(p) -> ChunkPlan:
    """The port's ``ChunkPlan`` for a reference plan (same fields)."""
    return ChunkPlan(
        total_bytes=int(p.total_bytes),
        chunk_bytes=int(p.chunk_bytes),
        movers=int(p.movers),
        pipeline_depth=int(p.pipeline_depth),
        chunks=tuple(Chunk(int(c.index), int(c.offset), int(c.length), int(c.mover))
                     for c in p.chunks),
    )
