"""Core of the port: chunking, integrity, the data plane and the transfer engine.

Submodules (each the twin of the same name under ``repro.core``):
  chunker    — chunk planning heuristics (paper §3.1) + automated sizing (§6)
  integrity  — mergeable fingerprints replacing MD5 (the exact host oracle)
  dataplane  — zero-copy buffer pool, single-pass streaming, and the
               decoupled integrity engine, whose fused drain digests on the
               card through ``kernels.checksum.checksum_many_words``
  transfer   — host-side chunked transfer engine with chunk-level FT
  journal    — chunk-completion journal (partial restart), byte-identical
               on disk to the reference's
  backoff    — seeded-jitter retry backoff
  simulator  — calibrated model of the paper's ALCF/NERSC/OLCF testbed
  scheduler  — load-aware mover allocation across transfers
  vclock     — shared virtual clock + outage-window arithmetic for the
               event-stepped simulator
"""
from repro_torch.core.chunker import Chunk, ChunkPlan, plan_auto, plan_chunks, plan_for_array
from repro_torch.core.dataplane import (
    BufferPool,
    ChunkBuffer,
    IntegrityEngine,
    VerifyJob,
    read_back_into,
    read_into,
    stream_chunk,
)
from repro_torch.core.integrity import (
    BASES,
    Digest,
    EMPTY_DIGEST,
    P,
    RunningFingerprint,
    combine_at_offsets,
    describe_mismatch,
    fingerprint_bytes,
    fingerprint_many,
    fingerprint_ndarray,
    fingerprint_rows,
    merge_all,
    verify,
)
from repro_torch.core.journal import ChunkJournal, JournalRecord, replay_checked_lines
from repro_torch.core.transfer import (
    BufferDest,
    BufferSource,
    ChunkedTransfer,
    EndpointOutage,
    FileDest,
    FileSource,
    IntegrityError,
    MoverCrash,
    QuarantineRecord,
    TransferReport,
    transfer_verified,
)
from repro_torch.core.vclock import ConvergenceError, VirtualClock, Window

__all__ = [
    "Chunk", "ChunkPlan", "plan_auto", "plan_chunks", "plan_for_array",
    "BASES", "Digest", "EMPTY_DIGEST", "P", "RunningFingerprint",
    "combine_at_offsets",
    "describe_mismatch", "fingerprint_bytes", "fingerprint_many",
    "fingerprint_ndarray", "fingerprint_rows", "merge_all", "verify",
    "BufferPool", "ChunkBuffer", "IntegrityEngine", "VerifyJob",
    "read_into", "read_back_into", "stream_chunk",
    "ChunkJournal", "JournalRecord", "replay_checked_lines",
    "BufferDest", "BufferSource", "ChunkedTransfer", "EndpointOutage",
    "FileDest", "FileSource", "IntegrityError", "MoverCrash",
    "QuarantineRecord", "TransferReport", "transfer_verified",
    "ConvergenceError", "VirtualClock", "Window",
]
