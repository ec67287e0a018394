#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0]

Run from the root of a checkout, on a machine with one CUDA card. In order:

  1. prints the card: torch's device name, and nvidia-smi's name and power
     limit (every number below is this card's, at that limit);
  2. builds the CUDA kernels from this checkout's sources (one nvcc call,
     with the ``-Xptxas -v`` register/spill summary);
  3. holds each kernel against its plain PyTorch version at the shapes the
     main path gives it — residues equal exactly, copies byte-equal — checks
     a 64 MiB slice against the host digest, and times kernel, plain version
     and (for the copy kernel) a plain device copy with CUDA events;
  4. drives the main path with every launch count at 0: the public digest
     API (``digest_of``, ``fingerprint_and_copy``) on a 1 GiB tensor, then a
     4 GiB pipelined chunked transfer (8 MiB chunks, 8 movers, 2 integrity
     workers) whose fused verification digests run in ``checksum_many_words``;
     each result is held against the host digest, and each kernel must have
     launched;
  5. flips one bit of one chunk's first landing in a short transfer: the
     deferred verifier must catch it and exactly one re-fetch heal it;
  6. prints ``{"kernels": [...]}`` and, as the last line,
     ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero before the last line. There is no CPU
path: without a card, or outside a checkout, it exits with code 2.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

MiB = 1024 * 1024
GiB = 1024 * MiB
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
INT32_LANES_PER_SM = 64          # Hopper: INT32 multiply-adds per SM per clock
MADDS_PER_WORD = 16              # 4 byte planes x 4 bases

MANY_SHAPE = (64, 2 * MiB)       # drain batch: 64 rows x 8 MiB, in int32 words
API_BYTES = 1 * GiB              # checksum_words / checksum_copy_words input
SLICE_BYTES = 64 * MiB           # checked against the host digest
TRANSFER_BYTES = 4 * GiB
CHUNK_BYTES = 8 * MiB            # = the engine's fuse_max_bytes
FLIP_BYTES = 64 * MiB

SOURCE = "src/repro_torch/kernels/csrc/checksum.cu"
REPLACES = {
    "checksum_words": "src/repro/kernels/checksum.py:112",
    "checksum_many_words": "src/repro/kernels/checksum.py:150",
    "checksum_copy_words": "src/repro/kernels/checksum.py:188",
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds per call, by CUDA events over ``iters``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(card: dict, bytes_moved: int, words: int) -> dict:
    """Least time for the work: bytes over HBM rate vs multiply-adds over the
    INT32 rate (64 lanes x SMs x max SM clock); the larger binds."""
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = MADDS_PER_WORD * words / (INT32_LANES_PER_SM * card["sms"] * card["clock_hz"]) * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bound_bytes_ms": bytes_ms, "bound_ops_ms": ops_ms}


def random_words(shape, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    nbytes = int(np.prod(shape)) * 4
    raw = torch.randint(0, 256, (nbytes,), dtype=torch.uint8, device=device, generator=gen)
    return raw.view(torch.int32).reshape(shape)


def kernel_checks(card: dict, seed: int, device) -> list[dict]:
    """Phase 3: every kernel against its plain version at main-path shapes."""
    from repro_torch.core.integrity import fingerprint_bytes
    from repro_torch.kernels import checksum as ck
    from repro_torch.kernels import ref

    tables = ck.tables(device)
    rows = []

    many = random_words(MANY_SHAPE, seed + 1, device)
    got = ck.checksum_many_words(many)
    want = ref.checksum_many_words_ref(many, *tables)
    err = int((got.long() - want.long()).abs().max())
    check(err == 0, "checksum_many_words equals its plain version")
    k, n = MANY_SHAPE
    rows.append({
        "name": "checksum_many_words", "shape": list(MANY_SHAPE), "max_abs_err": err,
        "exact": True,
        "ms": cuda_ms(lambda: ck.checksum_many_words(many), iters=20),
        "plain_ms": cuda_ms(lambda: ref.checksum_many_words_ref(many, *tables), 2, 1),
        **bound(card, k * n * 4 + k * 16, k * n)})
    del many, got, want

    words = random_words((API_BYTES // 4,), seed + 2, device)
    got = ck.checksum_words(words)
    want = ref.checksum_words_ref(words, *tables)
    err = int((got.long() - want.long()).abs().max())
    check(err == 0, "checksum_words equals its plain version")
    part = words[: SLICE_BYTES // 4]
    host = fingerprint_bytes(part.cpu().numpy().view(np.uint8))
    check(tuple(ck.checksum_words(part).cpu().tolist()) == host.h,
          "checksum_words of a 64 MiB slice equals the host fingerprint_bytes")
    n = words.numel()
    rows.append({
        "name": "checksum_words", "shape": [n], "max_abs_err": err, "exact": True,
        "ms": cuda_ms(lambda: ck.checksum_words(words), iters=20),
        "plain_ms": cuda_ms(lambda: ref.checksum_words_ref(words, *tables), 2, 1),
        **bound(card, n * 4 + 16, n)})

    res, copy = ck.checksum_copy_words(words)
    pres, pcopy = ref.checksum_copy_words_ref(words, *tables)
    err = int((res.long() - pres.long()).abs().max())
    check(err == 0 and torch.equal(copy, pcopy) and torch.equal(copy, words),
          "checksum_copy_words equals its plain version; copy byte-equal")
    check(torch.equal(res, got), "checksum_copy_words residues equal checksum_words")
    del pres, pcopy, copy
    rows.append({
        "name": "checksum_copy_words", "shape": [n], "max_abs_err": err, "exact": True,
        "ms": cuda_ms(lambda: ck.checksum_copy_words(words), iters=20),
        "plain_ms": cuda_ms(lambda: ref.checksum_copy_words_ref(words, *tables), 2, 1),
        "copy_ms": cuda_ms(lambda: torch.empty_like(words).copy_(words), iters=20),
        **bound(card, 2 * n * 4 + 16, n)})
    return rows


def digest_api(seed: int, device, nbytes: int) -> dict:
    """Main path, part 1: the public digest API on a float32 tensor."""
    from repro_torch.core.integrity import fingerprint_bytes
    from repro_torch.kernels import digest_of, fingerprint_and_copy

    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 3)
    x = torch.randn(nbytes // 4, generator=gen, device=device)
    t0 = time.perf_counter()
    dig = digest_of(x)
    api_s = time.perf_counter() - t0
    host = fingerprint_bytes(x.cpu().numpy())
    check(dig == host, "digest_of(1 GiB tensor on the card) equals the host digest")
    res, copy = fingerprint_and_copy(x)
    check(tuple(res.cpu().tolist()) == dig.h, "fingerprint_and_copy residues equal digest_of")
    check(torch.equal(copy.view(torch.int32), x.view(torch.int32)),
          "fingerprint_and_copy copy is byte-equal")
    return {"bytes": nbytes, "digest_of_s": api_s, "digest": dig.hexdigest()}


def transfer(seed: int, device, nbytes: int) -> dict:
    """Main path, part 2: the pipelined chunked transfer, verified on ``device``."""
    from repro_torch.core import (BufferDest, BufferSource, ChunkedTransfer,
                                  fingerprint_bytes, plan_chunks)

    t0 = time.perf_counter()
    payload = np.random.default_rng(seed).bytes(nbytes)
    make_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = fingerprint_bytes(payload)
    host_s = time.perf_counter() - t0
    plan = plan_chunks(nbytes, 8, min_chunk=CHUNK_BYTES, max_chunk=CHUNK_BYTES)
    check(plan.n_chunks == nbytes // CHUNK_BYTES
          and all(c.length == CHUNK_BYTES for c in plan.chunks),
          f"plan of {nbytes // CHUNK_BYTES} chunks of 8 MiB")
    dst = BufferDest(nbytes)
    xfer = ChunkedTransfer(BufferSource(payload), dst, plan, pipeline="pipelined",
                           integrity_workers=2, device=device)
    rep = xfer.run()
    stats = xfer.integrity_stats
    check(rep.file_digest == host, "transfer file digest equals the host digest")
    check(dst.buf == payload, "destination equals the payload")
    check(rep.retries == 0 and not rep.quarantined and stats.errors == 0,
          "transfer ran without errors")
    check(stats.fused_jobs > 0 and stats.device_rows > 0,
          "verification fused and digested rows on the card")
    return {"bytes": nbytes, "chunks": plan.n_chunks, "seconds": rep.seconds,
            "GBps": nbytes / rep.seconds / 1e9, "payload_s": make_s,
            "host_digest_s": host_s, "fused_batches": stats.fused_batches,
            "fused_jobs": stats.fused_jobs, "device_rows": stats.device_rows,
            "host_rows": stats.host_rows, "per_job_verifies": stats.per_job,
            "verified": stats.verified, "cksum_lag_s": rep.cksum_lag_s}


def flipped_landing(seed: int, device) -> dict:
    """Phase 5: one bit flipped in one chunk's first write is caught by the
    deferred verifier and healed by exactly one re-fetch."""
    from repro_torch.core import (BufferDest, BufferSource, ChunkedTransfer,
                                  fingerprint_bytes, plan_chunks)
    from repro_torch.obs import Tracer

    payload = np.random.default_rng(seed + 4).bytes(FLIP_BYTES)
    plan = plan_chunks(FLIP_BYTES, 8, min_chunk=CHUNK_BYTES, max_chunk=CHUNK_BYTES)
    target = plan.chunks[3].offset
    flips = []

    class FlippyDest(BufferDest):
        def write(self, offset, data):
            if offset == target and not flips:
                flips.append(offset)
                data = bytes([data[0] ^ 0x01]) + bytes(data[1:])
            super().write(offset, data)

    tracer = Tracer()
    dst = FlippyDest(FLIP_BYTES)
    rep = ChunkedTransfer(BufferSource(payload), dst, plan, pipeline="pipelined",
                          integrity_workers=2, device=device, tracer=tracer).run()
    check(flips == [target], "the bit flip happened")
    check(rep.refetches == 1 and len(rep.quarantined) == 1
          and rep.quarantined[0].chunk_index == 3,
          "the flip was caught and healed by exactly one re-fetch")
    check(dst.buf == payload and rep.file_digest == fingerprint_bytes(payload),
          "healed destination equals the payload")
    caught = [s for s in tracer.spans() if s.name == "verify" and s.arg("ok") is False]
    check(len(caught) == 1, "one failed verification span")
    return {"caught_by": "fused on-card batch" if caught[0].arg("fused") else "per-job host path",
            "refetches": rep.refetches, "quarantined": len(rep.quarantined),
            "detail": rep.quarantined[0].detail}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the card",
              file=sys.stderr)
        return 2
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}: run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch.kernels import _build
    from repro_torch.kernels import checksum as ck

    t_all = time.perf_counter()
    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    props = torch.cuda.get_device_properties(0)
    card = {"sms": props.multi_processor_count,
            "clock_hz": float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6}
    print(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{card['sms']} SMs, max SM clock {card['clock_hz'] / 1e6:.0f} MHz)")
    print(f"card: {smi}")

    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s, nvcc {_build.BUILD_INFO['seconds']:.2f} s "
          f"-> {os.path.relpath(_build.BUILD_INFO['path'])}")
    for line in _build.BUILD_INFO["log"].splitlines():
        if "ptxas info" in line or "spill" in line:
            print(f"  {line.strip()}")

    rows = kernel_checks(card, args.seed, device)
    for r in rows:
        print(f"kernel {r['name']} {r['shape']}: exact (tolerance 0), {r['ms']:.4f} ms "
              f"(bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
              f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound), plain {r['plain_ms']:.2f} ms"
              + (f", copy_ {r['copy_ms']:.4f} ms" if "copy_ms" in r else ""))

    torch.cuda.synchronize()
    ck.reset_launch_counts()
    api = digest_api(args.seed, device, API_BYTES)
    xfer = transfer(args.seed, device, TRANSFER_BYTES)
    torch.cuda.synchronize()
    launches = ck.launch_counts()
    print("digest_api " + json.dumps(api))
    print("transfer " + json.dumps(xfer))
    print("launches " + json.dumps(launches))
    for r in rows:
        check(launches[r["name"]] > 0, f"{r['name']} launched on the main path")

    flip = flipped_landing(args.seed, device)
    print("flipped_landing " + json.dumps(flip))

    kernels = []
    for r in rows:
        entry = {"name": r["name"], "route": "cuda", "source": SOURCE,
                 "replaces": REPLACES[r["name"]], "launches": launches[r["name"]],
                 "max_abs_err": r["max_abs_err"], "tolerance": 0, "exact": r["exact"],
                 "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"], "bound_bytes_ms": r["bound_bytes_ms"],
                 "bound_ops_ms": r["bound_ops_ms"], "library_ms": None,
                 "shape": r["shape"]}
        if "copy_ms" in r:
            entry["copy_ms"] = r["copy_ms"]
        kernels.append(entry)
    print(f"total: {time.perf_counter() - t_all:.1f} s on {smi}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
