"""Content-addressed chunk store — the content plane.

The merge-law digest algebra (``core.integrity``) gives every chunk a
stable fingerprint, yet the data plane re-moves every byte of every
repeated dataset: evolving climate archives are re-published with most
bytes unchanged, and repeated checkpoint saves differ by a few percent.
This package closes that gap with the replica-catalog idea from the
classic Globus replica-management work, rebuilt on the repo's own digest
algebra:

  * ``ChunkIndex`` — a per-endpoint map from merge-law chunk digests to
    landed byte regions, persisted in a self-checksummed append log with
    crash-safe replay and compaction (the same torn-tail discipline as
    ``core.journal``), populated automatically as verified chunks commit;
  * dedup negotiation lives in ``core.transfer`` (engine) and
    ``repro_torch.service`` (tasks): before movers start, the plan's chunk
    digests are probed against the destination's index and already-present
    chunks are satisfied by a destination-local copy (or a pure index
    insert for same-target aliases) instead of wire moves. Every hit is
    re-verified by a read-back fingerprint first — a stale entry demotes
    to a normal wire move with a quarantine record, so the 0-escape
    guarantee is unconditional;
  * ``seed_index_from_manifest`` — delta checkpoints: a previous save's
    MANIFEST.json is itself a chunk catalog; seeding the index from it
    makes the next save move only changed chunks.

Skipped chunks still fold into the whole-file digest chain
(``combine_at_offsets``), so end-to-end integrity verification is
unchanged whether a chunk arrived over the wire or from the index.
"""
from repro_torch.cas.index import (
    ChunkIndex,
    DedupStats,
    IndexEntry,
    seed_index_from_manifest,
)

__all__ = ["ChunkIndex", "DedupStats", "IndexEntry", "seed_index_from_manifest"]
