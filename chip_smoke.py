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
  5. flips one bit of one chunk's first landing in a short transfer, once
     with 8 MiB chunks (fused drain) and once with 32 MiB chunks (over the
     engine's fuse_max_bytes: the per-job verify on the card): the deferred
     verifier must catch it and exactly one re-fetch heal it;
  6. the fused matmul + digest at mistral-nemo-12b's width (d_model 5120,
     d_ff 14336): the up-projection weight A (14336, 5120) bf16 times 4096
     tokens of activations B (5120, 4096) bf16. The kernel's residues must
     equal its plain version's, the checksum kernel's digest of
     ``blocked_view(A)`` and the host digest; C must lie within
     K * 2^-24 * (|A| @ |B|) of the float64 product, and equal the
     product-only build of the same kernel (``mm_product``). Times, in
     turns: the fused kernel, its product-only build, the library product
     (cuBLAS, bf16 in, f32 out), the separate digest pass and the plain
     version, which gives the digest's share of the kernel. Then drives the
     public ``matmul_with_digest`` with the launch counts at 0;
  7. saves one full-width decoder block of mistral-nemo-12b (bf16, 545 MB,
     the JAX model's keys and shapes) with the port's ``CheckpointManager``
     and restores it to the card with the counts at 0: every leaf
     bit-equal, its digest on the card equal to its MANIFEST digest, and one
     flipped bit reported by leaf and chunk;
  8. runs the transfer service (``repro_torch.service``, pipelined, verifying
     on the card) for two tenants at once, with the counts at 0: "facility"
     moves a 2 GiB file in 8 MiB chunks (the fused drain), a 512 MiB file in
     32 MiB chunks (per-job verifies on the card) and 64 files of 1 MiB (one
     batched task); "ckpt" checkpoints the decoder block through the service,
     restores it bit-equal, overwrites the first 10 % of the rows of ``wi``
     and saves a delta that must move only the chunks holding changed bytes.
     "facility" also moves a 512 MiB file in 8 MiB chunks through a serial
     and through a single-pass service, whose movers digest each chunk and
     its read-back on the card. Every task must succeed, every destination
     equal its payload, both digest kernels launch, and the facility tasks
     verify nothing on the host. Then, on the idle services, each with the
     counts at 0: a delta save of the unchanged state (every chunk dedups;
     the probes digest source, donor and landing on the card) and the two
     inline files once more (exact launch counts per chunk);
  9. relays a 1 GiB file on local disk over the 3-hop route of
     ``shared_trunk_topology(1, trunk_hops=2)`` (8 MiB chunks, 4 movers a
     hop, every hop digest on the card) with one bit flipped once in the
     middle hop's landing: the file digest must equal the host digest, the
     replica the payload, one re-fetch heal the flip, and every hop launch
     exactly its digests; then a tuned relay of 256 MiB whose middle hop
     turns lossy (``tune.harness``), so its granule hops digest on the card;
 10. runs the port's ``transferd`` in process on the card, every mode on
     fresh directories: the testbed, ``--real`` twice on one directory,
     ``scrub``, ``cas stats``, ``fabric plan``, ``fabric campaign`` under
     chaos, ``fabric replicate``, ``top`` and ``trace --real``; each must
     print its success line, and the real modes must launch the kernels;
 11. prints ``{"kernels": [...]}`` and, as the last line,
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
BF16_FLOP_PER_SM = 4096          # dense bf16 tensor-core FLOP per SM per clock:
#                                  989.4 TFLOP/s at 132 SMs x 1830 MHz (data sheet)
MADDS_PER_ELEMENT = 8            # matmul digest: 2 bytes x 4 bases per A element

# mistral-nemo-12b (src/repro/configs/mistral_nemo_12b.py:10)
D_MODEL, D_FF, N_HEADS, N_KV_HEADS, HEAD_DIM = 5120, 14336, 32, 8, 128
TOKENS = 4096                    # activations through the up-projection

MANY_SHAPE = (64, 2 * MiB)       # drain batch: 64 rows x 8 MiB, in int32 words
API_BYTES = 1 * GiB              # checksum_words / checksum_copy_words input
SLICE_BYTES = 64 * MiB           # checked against the host digest
TRANSFER_BYTES = 4 * GiB
CHUNK_BYTES = 8 * MiB            # = the engine's fuse_max_bytes
FLIP_CHUNKS = 8                  # chunks of the flipped-landing transfer
SERVICE_BIG_BYTES = 2 * GiB      # the facility's file in default 8 MiB chunks
SERVICE_OVERSIZE_BYTES = 512 * MiB
SERVICE_OVERSIZE_CHUNK = 32 * MiB   # over fuse_max_bytes: per-job verifies
SERVICE_SMALL_FILES, SERVICE_SMALL_BYTES = 64, 1 * MiB
SERVICE_HOST_PIPELINE_BYTES = 512 * MiB   # one file each, serial and single-pass
RELAY_BYTES = 1 * GiB            # the relay's payload, 8 MiB chunks, 3 hops
RELAY_TUNED_BYTES = 256 * MiB    # the tuned relay (granule hops)
RELAY_CHUNK = 8 * MiB
RELAY_GRANULE_MIN = 1 * MiB

SOURCES = {
    "checksum_words": "src/repro_torch/kernels/csrc/checksum.cu",
    "checksum_many_words": "src/repro_torch/kernels/csrc/checksum.cu",
    "checksum_copy_words": "src/repro_torch/kernels/csrc/checksum.cu",
    "matmul_digest": "src/repro_torch/kernels/csrc/matmul_digest.cu",
}
REPLACES = {
    "checksum_words": "src/repro/kernels/checksum.py:112",
    "checksum_many_words": "src/repro/kernels/checksum.py:150",
    "checksum_copy_words": "src/repro/kernels/checksum.py:188",
    "matmul_digest": "src/repro/kernels/matmul_digest.py:99",
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def sync(device) -> None:
    """Wait for the card where ``device`` is one; a CPU device has nothing
    in flight. Lets the phases rehearse on the CPU (see the verify recipe)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


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


def flipped_landing(seed: int, device, chunk_bytes: int = CHUNK_BYTES) -> dict:
    """Phase 5: one bit flipped in one chunk's first write is caught by the
    deferred verifier and healed by exactly one re-fetch. 8 MiB chunks verify
    in the fused drain; chunks over ``fuse_max_bytes`` one by one on the card."""
    from repro_torch.core import (BufferDest, BufferSource, ChunkedTransfer,
                                  fingerprint_bytes, plan_chunks)
    from repro_torch.obs import Tracer

    nbytes = FLIP_CHUNKS * chunk_bytes
    payload = np.random.default_rng(seed + 4).bytes(nbytes)
    plan = plan_chunks(nbytes, 8, min_chunk=chunk_bytes, max_chunk=chunk_bytes)
    target = plan.chunks[3].offset
    flips = []

    class FlippyDest(BufferDest):
        def write(self, offset, data):
            if offset == target and not flips:
                flips.append(offset)
                data = bytes([data[0] ^ 0x01]) + bytes(data[1:])
            super().write(offset, data)

    tracer = Tracer()
    dst = FlippyDest(nbytes)
    xfer = ChunkedTransfer(BufferSource(payload), dst, plan, pipeline="pipelined",
                           integrity_workers=2, device=device, tracer=tracer)
    rep = xfer.run()
    stats = xfer.integrity_stats
    check(flips == [target], "the bit flip happened")
    check(rep.refetches == 1 and len(rep.quarantined) == 1
          and rep.quarantined[0].chunk_index == 3,
          "the flip was caught and healed by exactly one re-fetch")
    check(dst.buf == payload and rep.file_digest == fingerprint_bytes(payload),
          "healed destination equals the payload")
    caught = [s for s in tracer.spans() if s.name == "verify" and s.arg("ok") is False]
    check(len(caught) == 1, "one failed verification span")
    check(stats.per_job == 0 and stats.host_rows == 0, "nothing was verified on the host")
    if chunk_bytes > CHUNK_BYTES:
        check(not caught[0].arg("fused") and stats.device_jobs == plan.n_chunks + 1,
              "every landing (the re-fetch included) verified per job on the card")
    return {"chunk_bytes": chunk_bytes, "chunks": plan.n_chunks,
            "caught_by": "fused on-card batch" if caught[0].arg("fused") else "per-job on-card verify",
            "refetches": rep.refetches, "quarantined": len(rep.quarantined),
            "device_jobs": stats.device_jobs, "fused_jobs": stats.fused_jobs,
            "detail": rep.quarantined[0].detail}


def matmul_bound(card: dict, M: int, K: int, N: int) -> dict:
    """Least time for C = A @ B + digest of A: the product over the bf16
    tensor-core rate, A + B + C over HBM, the digest's multiply-adds over the
    INT32 rate; the largest binds."""
    clock = card["sms"] * card["clock_hz"]
    ops_ms = 2 * M * N * K / (BF16_FLOP_PER_SM * clock) * 1e3
    bytes_ms = (2 * M * K + 2 * K * N + 4 * M * N) / HBM_BYTES_PER_S * 1e3
    digest_ms = MADDS_PER_ELEMENT * M * K / (INT32_LANES_PER_SM * clock) * 1e3
    bound_ms = max(ops_ms, bytes_ms, digest_ms)
    return {"bound_ms": bound_ms, "bound_by": "bytes" if bound_ms == bytes_ms else "operations",
            "bound_bytes_ms": bytes_ms, "bound_ops_ms": ops_ms, "bound_digest_ms": digest_ms}


def library_matmul(a: torch.Tensor, b: torch.Tensor):
    """One PyTorch call for the same product (cuBLAS): bf16 in, f32 out.
    Returns (name, call). Raises where this torch has no such call: the
    yardstick is always the same function."""
    call = lambda: torch.mm(a, b, out_dtype=torch.float32)   # noqa: E731
    check(call().dtype == torch.float32, "torch.mm(a, b, out_dtype=torch.float32) gives f32")
    return "torch.mm(a, b, out_dtype=torch.float32)", call


def product_only(a: torch.Tensor, b: torch.Tensor):
    """C = A @ B by the bf16 kernel without its digest warps (``mm_product``,
    the kernel's kDigest = false build), through its own C entry point.
    Returns a call that launches it into one preallocated C; on a CPU
    tensor, the plain product."""
    if a.device.type == "cpu":
        return lambda: a.float() @ b.float()
    from repro_torch.kernels import _build
    from repro_torch.kernels import matmul_digest as mm

    lib = _build.load()
    (M, K), N = a.shape, b.shape[1]
    c = torch.empty((M, N), dtype=torch.float32, device=a.device)
    sms = mm.sm_count(a.device)

    def call() -> torch.Tensor:
        rc = lib.mm_product(a.device.index, a.data_ptr(), b.data_ptr(), c.data_ptr(), M, N, K,
                            sms, torch.cuda.current_stream(a.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"mm_product launch failed: {lib.ck_error_string(rc).decode()}")
        return c
    return call


def matmul_inputs(seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The up-projection of mistral-nemo-12b: nn.Linear's (out, in) weight
    A (d_ff, d_model) and TOKENS activations transposed, B (d_model, TOKENS)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 5)
    a = (torch.randn(D_FF, D_MODEL, generator=gen, device=device) * 0.02).to(torch.bfloat16)
    b = torch.randn(D_MODEL, TOKENS, generator=gen, device=device).to(torch.bfloat16)
    return a, b


def matmul_check(card: dict, a: torch.Tensor, b: torch.Tensor) -> tuple[dict, torch.Tensor]:
    """Phase 6: the fused matmul + digest kernel against its plain version.
    Returns its row of the kernels line and its residues."""
    from repro_torch.core.integrity import fingerprint_bytes
    from repro_torch.kernels import fingerprint_array, ref
    from repro_torch.kernels import matmul_digest as mm

    torch.backends.cuda.matmul.allow_tf32 = False      # the plain f32 product in full f32
    torch.backends.cudnn.allow_tf32 = False
    (M, K), N = a.shape, b.shape[1]
    c, dig = mm.matmul_digest(a, b)
    pc, pdig = ref.matmul_digest_ref(a, b)
    check(torch.equal(dig, pdig), "matmul_digest residues equal its plain version's")
    blocked = ref.blocked_view(a, 128, 128)
    check(torch.equal(fingerprint_array(blocked), dig),
          "matmul_digest residues equal checksum_words' digest of blocked_view(A)")
    host = fingerprint_bytes(blocked.view(torch.uint8).cpu().numpy())
    check(tuple(dig.cpu().tolist()) == host.h,
          "matmul_digest residues equal the host digest of A's blocked bytes")
    del blocked
    a64, b64 = a.double(), b.double()
    c64 = a64 @ b64
    tol = K * 2.0 ** -24 * (a64.abs() @ b64.abs())
    del a64, b64
    err = (c.double() - c64).abs()
    perr = (pc.double() - c64).abs()
    check(bool((err <= tol).all()), "C within K*2^-24*(|A|@|B|) of the float64 product")
    check(bool((perr <= tol).all()), "plain C within K*2^-24*(|A|@|B|) of the float64 product")
    prod = product_only(a, b)
    check(torch.equal(prod(), c), "the product-only build gives the fused kernel's C")
    out = {"shape": [M, K, N], "max_abs_err": float((c - pc).abs().max()),
           "max_abs_err_f64": float(err.max()),
           "max_rel_err_f64": float(err.max() / c64.abs().max()),
           "max_share_of_tolerance": float((err / tol.clamp_min(1e-300)).max())}
    del c64, tol, err, perr, pc, c
    lib_name, lib_call = library_matmul(a, b)
    calls = {   # key on the kernels line: (call, timed launches a turn)
        "ms": (lambda: mm.matmul_digest(a, b), 20),
        "product_only_ms": (prod, 20),
        "library_ms": (lib_call, 20),
        "separate_digest_ms": (lambda: fingerprint_array(ref.blocked_view(a, 128, 128)), 20),
        "plain_ms": (lambda: ref.matmul_digest_ref(a, b), 2),
    }
    runs = {key: [] for key in calls}
    for order in (list(calls), list(reversed(calls))):     # in turns: a b c d e e d c b a
        for key in order:
            fn, iters = calls[key]
            runs[key].append(cuda_ms(fn, iters=iters, warmup=1))
    out.update({key: sum(v) / len(v) for key, v in runs.items()})
    out.update(
        runs_ms=runs, library_call=lib_name,
        digest_share=(out["ms"] - out["product_only_ms"]) / out["ms"],
        library_plus_digest_ms=out["library_ms"] + out["separate_digest_ms"],
        separate_digest_row_major_ms=cuda_ms(lambda: fingerprint_array(a), iters=20),
        **matmul_bound(card, M, K, N))
    return out, dig


def matmul_path(a: torch.Tensor, b: torch.Tensor, dig: torch.Tensor) -> dict:
    """Main path, part 3: the public fused consume-and-verify product."""
    from repro_torch.kernels import matmul_with_digest

    t0 = time.perf_counter()
    c, got = matmul_with_digest(a, b)
    sync(a.device)
    seconds = time.perf_counter() - t0
    check(torch.equal(got, dig), "matmul_with_digest residues equal the kernel check's")
    check(c.shape == (a.shape[0], b.shape[1]) and bool(torch.isfinite(c).all()),
          "matmul_with_digest C is finite and (M, N)")
    return {"shape": [a.shape[0], a.shape[1], b.shape[1]], "seconds": seconds,
            "residues": got.cpu().tolist()}


def decoder_block(seed: int, device) -> dict:
    """One mistral-nemo-12b decoder block as a state dict, bf16: the JAX
    model's keys and shapes with one block (models/transformer.py:42-51)."""
    D, F, H, KVH, hd = D_MODEL, D_FF, N_HEADS, N_KV_HEADS, HEAD_DIM
    shapes = {"ln1": (1, D), "ln2": (1, D), "wq": (1, D, H, hd), "wk": (1, D, KVH, hd),
              "wv": (1, D, KVH, hd), "wo": (1, H, hd, D), "wi": (1, D, F), "wg": (1, D, F),
              "wmo": (1, F, D)}
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 6)
    return {"blocks": {"0": {k: (torch.randn(s, generator=gen, device=device) * 0.02)
                             .to(torch.bfloat16) for k, s in shapes.items()}}}


def checkpoint_path(seed: int, device, reset, counts) -> dict:
    """Main path, part 4, and its checks: save a decoder block from the card,
    restore it to the card, compare; then flip one bit in one leaf file."""
    import shutil
    import tempfile

    from repro_torch.ckpt import CheckpointManager, CorruptionError
    from repro_torch.core.integrity import Digest
    from repro_torch.kernels import digest_of

    state = decoder_block(seed, device)
    leaves = {f"blocks/0/{k}": t for k, t in state["blocks"]["0"].items()}
    nbytes = sum(t.numel() * t.element_size() for t in leaves.values())
    root = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    try:
        mgr = CheckpointManager(root, device=device)
        sync(device)
        reset()
        t0 = time.perf_counter()
        rep = mgr.save(1, state)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got, step = mgr.restore()
        sync(device)
        restore_s = time.perf_counter() - t0
        launches = counts()
        check(step == 1 and rep.total_bytes == nbytes and rep.n_leaves == len(leaves),
              "checkpoint saved every leaf")
        with open(os.path.join(rep.path, "MANIFEST.json")) as fh:
            manifest = json.load(fh)
        for key, t in leaves.items():
            r = got["blocks"]["0"][key.rsplit("/", 1)[1]]
            check(r.device == t.device and r.dtype == t.dtype
                  and torch.equal(r.view(torch.int16), t.view(torch.int16)),
                  f"{key} restored bit-equal on the card")
            want = Digest.from_bytes(bytes.fromhex(manifest["leaves"][key]["digest"]))
            check(digest_of(r) == want, f"{key}: digest on the card equals its MANIFEST digest")
        del got
        entry = manifest["leaves"]["blocks/0/wi"]
        chunk = entry["chunks"][2]
        with open(os.path.join(rep.path, entry["file"]), "r+b") as fh:
            fh.seek(chunk["offset"] + 12345)
            byte = fh.read(1)
            fh.seek(chunk["offset"] + 12345)
            fh.write(bytes([byte[0] ^ 0x10]))
        try:
            mgr.restore()
        except CorruptionError as e:
            caught = (e.leaf, e.bad_chunks)
        else:
            caught = None
        check(caught == ("blocks/0/wi", [chunk["index"]]),
              f"the flipped bit is reported by leaf and chunk, got {caught}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"bytes": nbytes, "leaves": len(leaves),
            "chunks": sum(len(e["chunks"]) for e in manifest["leaves"].values()),
            "save_s": save_s, "save_GBps": nbytes / save_s / 1e9,
            "restore_s": restore_s, "restore_GBps": nbytes / restore_s / 1e9,
            "flipped": {"leaf": caught[0], "bad_chunks": caught[1]}, "launches": launches}


def service_path(seed: int, device, reset, counts) -> dict:
    """Main path, part 5: the transfer service for two tenants at once,
    verifying on ``device``. "facility" moves files through ``submit()``;
    "ckpt" saves the decoder block through ``submit_checkpoint``, restores
    it, changes the first 10 % of the rows of ``wi`` and saves a delta."""
    import filecmp
    import shutil
    import tempfile

    from repro_torch.ckpt import restore_checkpoint
    from repro_torch.core.integrity import fingerprint_bytes
    from repro_torch.service import ServiceConfig, TransferService, submit_checkpoint

    root = tempfile.mkdtemp(prefix="chip-smoke-svc-")
    try:
        t0 = time.perf_counter()
        rng = np.random.default_rng(seed + 7)
        files = {"big": SERVICE_BIG_BYTES, "oversize": SERVICE_OVERSIZE_BYTES,
                 **{f"small{i:02d}": SERVICE_SMALL_BYTES for i in range(SERVICE_SMALL_FILES)},
                 "serial": SERVICE_HOST_PIPELINE_BYTES,
                 "single_pass": SERVICE_HOST_PIPELINE_BYTES}
        digests = {}
        for name, n in files.items():
            data = rng.bytes(n)
            digests[name] = fingerprint_bytes(data).hexdigest()
            with open(os.path.join(root, name), "wb") as fh:
                fh.write(data)
            del data
        make_s = time.perf_counter() - t0

        def item(name):
            return (os.path.join(root, name), os.path.join(root, name + ".out"))

        cfg = ServiceConfig(pipeline="pipelined", integrity_workers=2, mover_budget=8,
                            max_concurrent_tasks=4)
        svc = TransferService(os.path.join(root, "svc"), cfg, device=device)
        # the movers' own digests: one service root per pipeline that digests
        # inline (serial: whole chunk, then the read-back; single-pass:
        # streamed granules staged for one launch, then the read-back)
        inline = {pipe: TransferService(os.path.join(root, f"svc-{pipe}"), ServiceConfig(
            pipeline=pipe, mover_budget=8, max_concurrent_tasks=4), device=device)
            for pipe in ("serial", "single_pass")}
        try:
            state = decoder_block(seed, device)
            block = state["blocks"]["0"]
            sync(device)
            reset()
            t0 = time.perf_counter()
            tasks = {
                "big": svc.submit([item("big")], tenant="facility", label="big")[0],
                "oversize": svc.submit([item("oversize")], tenant="facility", label="oversize",
                                       chunk_bytes=SERVICE_OVERSIZE_CHUNK)[0],
            }
            inline_tasks = {pipe: isvc.submit([item(pipe)], tenant="facility", label=pipe)[0]
                            for pipe, isvc in inline.items()}
            small = svc.submit([item(n) for n in files if n.startswith("small")],
                               tenant="facility", label="small")
            check(len(small) == 1, "the 1 MiB files were coalesced into one task")
            tasks["small"] = small[0]
            ck_root = os.path.join(root, "ckpt")
            sub1 = submit_checkpoint(svc, ck_root, 1, state, tenant="ckpt")
            rep1 = sub1.wait(timeout=600)
            got, _ = restore_checkpoint(rep1.path, device=device)
            for key, t in block.items():
                check(torch.equal(got["blocks"]["0"][key].view(torch.int16), t.view(torch.int16)),
                      f"checkpoint 1: {key} restored bit-equal on the card")
            del got
            wi = block["wi"]
            rows = wi.shape[1] // 10
            gen = torch.Generator(device=device)
            gen.manual_seed(seed + 8)
            wi[:, :rows] = (torch.randn((wi.shape[0], rows, wi.shape[2]), generator=gen,
                                        device=device) * 0.02).to(wi.dtype)
            sub2 = submit_checkpoint(svc, ck_root, 2, state, tenant="ckpt", delta=True)
            rep2 = sub2.wait(timeout=600)
            got, _ = restore_checkpoint(rep2.path, device=device)
            for key, t in block.items():
                check(torch.equal(got["blocks"]["0"][key].view(torch.int16), t.view(torch.int16)),
                      f"checkpoint 2 (delta): {key} restored bit-equal to the changed state")
            del got
            sts = {name: svc.wait(tid, timeout=600) for name, tid in tasks.items()}
            inline_sts = {pipe: inline[pipe].wait(tid, timeout=600)
                          for pipe, tid in inline_tasks.items()}
            sync(device)
            wall_s = time.perf_counter() - t0
            launches = counts()
            stats = {name: svc.integrity_stats(tid) for name, tid in tasks.items()}
            ck_sts = {"ckpt_full": sub1.status(), "ckpt_delta": sub2.status()}
            ck_stats = {"ckpt_full": svc.integrity_stats(sub1.task_id),
                        "ckpt_delta": svc.integrity_stats(sub2.task_id)}
            # thread-seconds per span name, per task: where the host time went
            spans = {}
            for name, tid, tracer in (
                    *((n, t, svc.tracer) for n, t in tasks.items()),
                    ("ckpt_full", sub1.task_id, svc.tracer),
                    ("ckpt_delta", sub2.task_id, svc.tracer),
                    *((p, t, inline[p].tracer) for p, t in inline_tasks.items())):
                spans[name] = {}
                for sp in tracer.spans(tid):
                    spans[name][sp.name] = spans[name].get(sp.name, 0.0) + sp.t1 - sp.t0
            # the dedup probes alone, on an idle service: a delta save of the
            # unchanged state dedups every chunk, each probe digesting the
            # source, the donor's backing bytes and the landing on the card
            reset()
            t1 = time.perf_counter()
            sub3 = submit_checkpoint(svc, ck_root, 3, state, tenant="ckpt", delta=True)
            rep3 = sub3.wait(timeout=600)
            sync(device)
            idle_delta = {"save_s": rep3.seconds, "seconds": time.perf_counter() - t1,
                          "launches": counts()}
            st3 = sub3.status()
            idle_delta.update(chunks=st3.chunks_total, chunks_deduped=st3.chunks_deduped,
                              dedup_hit_thread_s=sum(sp.t1 - sp.t0 for sp in
                                                     svc.tracer.spans(sub3.task_id)
                                                     if sp.name == "dedup_hit"))
            # the movers' inline digests alone: each inline file once more,
            # on its idle service
            inline_idle = {}
            for pipe, isvc in inline.items():
                reset()
                [tid] = isvc.submit([item(pipe)], tenant="facility", label=f"{pipe}-idle")
                st = isvc.wait(tid, timeout=600)
                sync(device)
                row = {"launches": counts(), "state": st.state, "chunks": st.chunks_total,
                       "seconds": st.finished_s - st.started_s, "span_thread_s": {}}
                for sp in isvc.tracer.spans(tid):
                    row["span_thread_s"][sp.name] = (row["span_thread_s"].get(sp.name, 0.0)
                                                     + sp.t1 - sp.t0)
                inline_idle[pipe] = row
        finally:
            svc.close()
            for isvc in inline.values():
                isvc.close()
        for name, st in {**sts, **ck_sts, **inline_sts}.items():
            check(st.state == "SUCCEEDED", f"service task {name} succeeded ({st.error})")
        check(idle_delta["chunks_deduped"] == idle_delta["chunks"] > 0,
              "a delta save of the unchanged state dedups every chunk")
        for pipe, row in inline_idle.items():
            check(row["state"] == "SUCCEEDED", f"{pipe} task on the idle service succeeded")
        for pipe, st in inline_sts.items():
            check(len([1 for sp in inline[pipe].tracer.spans(inline_tasks[pipe])
                       if sp.name == "cksum_inline"]) == st.chunks_total,
                  f"{pipe}: every chunk digested inline by its mover")
        for name in files:
            check(filecmp.cmp(*item(name), shallow=False), f"{name}: destination equals payload")
        reports = {r.src: r for st in {**sts, **inline_sts}.values() for r in st.item_reports}
        for name in files:
            check(reports[item(name)[0]].digest_hex == digests[name],
                  f"{name}: item digest equals the host digest of the payload")
        for name, st in stats.items():
            check(st.per_job == 0 and st.host_rows == 0 and st.errors == 0,
                  f"{name}: no verify on the host")
            check(st.verified == sts[name].chunks_total, f"{name}: every chunk verified once")
        check(stats["oversize"].device_jobs == sts["oversize"].chunks_total
              == SERVICE_OVERSIZE_BYTES // SERVICE_OVERSIZE_CHUNK,
              "every 32 MiB chunk verified per job on the card")
        check(stats["big"].fused_jobs > 0 and stats["big"].device_rows > 0,
              "the 8 MiB chunks were verified in fused on-card batches")
        # the delta moved exactly the chunks that hold changed bytes: those
        # whose digest changed between the two MANIFESTs, which must be the
        # chunks of wi that overlap its first rows
        mans = []
        for rep in (rep1, rep2):
            with open(os.path.join(rep.path, "MANIFEST.json")) as fh:
                mans.append(json.load(fh))
        changed = sum(1 for key, leaf in mans[1]["leaves"].items()
                      for c, c0 in zip(leaf["chunks"], mans[0]["leaves"][key]["chunks"])
                      if c["digest"] != c0["digest"])
        changed_end = rows * wi.shape[2] * wi.element_size()
        overlap = sum(1 for c in mans[1]["leaves"]["blocks/0/wi"]["chunks"]
                      if c["offset"] < changed_end)
        delta = ck_sts["ckpt_delta"]
        moved = delta.chunks_total - delta.chunks_deduped
        check(moved == changed == overlap > 0,
              f"the delta moved {moved} chunks: the {changed} whose bytes changed")
        check(delta.wire_bytes_saved == delta.bytes_total - sum(
            c["length"] for c in mans[1]["leaves"]["blocks/0/wi"]["chunks"]
            if c["offset"] < changed_end), "wire bytes saved = bytes of the unchanged chunks")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    def task_row(st, istats) -> dict:
        secs = st.finished_s - st.started_s
        row = {"seconds": secs, "GBps": st.bytes_total / secs / 1e9, "bytes": st.bytes_total,
               "chunks": st.chunks_total, "files": st.n_files}
        if istats is not None:
            row["integrity_stats"] = {k: getattr(istats, k) for k in (
                "fused_batches", "fused_jobs", "device_rows", "host_rows", "device_jobs",
                "per_job", "verified")}
        return row

    out = {name: task_row(st, stats[name]) for name, st in sts.items()}
    out.update({name: task_row(st, ck_stats[name]) for name, st in ck_sts.items()})
    out.update({name: task_row(st, None) for name, st in inline_sts.items()})
    for name, row in out.items():
        row["span_thread_s"] = spans[name]
    out["ckpt_full"]["save_s"], out["ckpt_delta"]["save_s"] = rep1.seconds, rep2.seconds
    out["ckpt_delta"].update(chunks_deduped=delta.chunks_deduped,
                             wire_bytes_saved=delta.wire_bytes_saved, chunks_moved=moved)
    return {"tasks": out, "wall_s": wall_s, "payload_s": make_s, "launches": launches,
            "idle_delta": idle_delta, "inline_idle": inline_idle}


def relay_path(seed: int, device, reset, counts) -> dict:
    """Main path, part 6: a 3-hop relay of a 1 GiB file on local disk, every
    hop digest on ``device``, one bit flipped once in the middle hop's
    landing; then a tuned relay of 256 MiB whose middle hop turns lossy, so
    its granule controller shrinks the hop's I/O unit and the granule digests
    run (``[data, back]``: one launch when the granule tiles the kernel, one
    each otherwise)."""
    import filecmp
    import shutil
    import tempfile

    from repro_torch.core import FileDest, FileSource, fingerprint_bytes
    from repro_torch.fabric import RelayTransfer, RoutePlanner, shared_trunk_topology
    from repro_torch.tune.harness import Phase, StepPath, StepScenario

    root = tempfile.mkdtemp(prefix="chip-smoke-relay-")
    try:
        t0 = time.perf_counter()
        payload = np.random.default_rng(seed + 9).bytes(RELAY_BYTES)
        host = fingerprint_bytes(payload)
        src = os.path.join(root, "payload.bin")
        with open(src, "wb") as fh:
            fh.write(payload)
        tuned_src = os.path.join(root, "payload-tuned.bin")
        with open(tuned_src, "wb") as fh:
            fh.write(payload[:RELAY_TUNED_BYTES])
        tuned_host = fingerprint_bytes(payload[:RELAY_TUNED_BYTES])
        del payload
        make_s = time.perf_counter() - t0
        route = RoutePlanner(shared_trunk_topology(1, trunk_hops=2)).best_route(
            "src", "d0", RELAY_BYTES)
        check(route.n_hops == 3, f"a 3-hop route, got {route.nodes}")
        n_chunks = RELAY_BYTES // RELAY_CHUNK
        target = (n_chunks // 2) * RELAY_CHUNK
        flips = []

        class FlipOnce:
            """The middle hop's landing: one bit of one chunk flips, once."""

            def __init__(self, inner):
                self._inner = inner

            def write(self, offset, data):
                if offset == target and not flips:
                    flips.append(offset)
                    data = bytearray(data)
                    data[len(data) // 2] ^= 0x04
                self._inner.write(offset, data)

            def read_back(self, offset, length):
                return self._inner.read_back(offset, length)

        out = os.path.join(root, "replica.bin")
        sync(device)
        reset()
        t0 = time.perf_counter()
        rep = RelayTransfer(
            route, FileSource(src), FileDest(out, RELAY_BYTES),
            workdir=os.path.join(root, "work"), chunk_bytes=RELAY_CHUNK, movers=4,
            dest_wrapper=lambda h, d: FlipOnce(d) if h == 1 else d, device=device,
        ).run()
        sync(device)
        secs = time.perf_counter() - t0
        launches = counts()
        check(flips == [target], "the bit flip happened")
        check(rep.file_digest == host, "relay file digest equals the host digest")
        check(filecmp.cmp(src, out, shallow=False), "relay destination equals the payload")
        check(rep.refetches == 1 and [h.refetches for h in rep.hops] == [0, 1, 0],
              "the flipped landing was healed by exactly one re-fetch on the middle hop")
        check(rep.n_chunks == n_chunks and all(h.moved_chunks == n_chunks for h in rep.hops),
              "every hop moved every chunk")
        # whole-chunk hops: one launch for the data, one for the read-back,
        # per chunk per hop, and two for the corrupt attempt
        plain = {"bytes": RELAY_BYTES, "chunks": n_chunks, "hops": route.n_hops,
                 "seconds": secs, "GBps": RELAY_BYTES / secs / 1e9,
                 "refetches": rep.refetches, "launches": launches,
                 "whole_chunk_launches": 2 * (route.n_hops * n_chunks + rep.refetches)}

        # the tuned relay: hop 1's path turns lossy at 40 % of its bytes
        # (deterministic loss: an 8 MiB read then lands on its 20th try, a
        # 1 MiB one on its first), so the hop's controller shrinks its granule
        lossy = StepPath(StepScenario("hop1_loss_at_40pct", (
            Phase(0.0, per_op_s=5e-3),
            Phase(0.4, per_op_s=5e-3, error_per_byte=3.0 / RELAY_CHUNK))),
            RELAY_TUNED_BYTES, sleep=time.sleep)
        out = os.path.join(root, "replica-tuned.bin")
        sync(device)
        reset()
        t0 = time.perf_counter()
        rep = RelayTransfer(
            route, FileSource(tuned_src), FileDest(out, RELAY_TUNED_BYTES),
            workdir=os.path.join(root, "work-tuned"), chunk_bytes=RELAY_CHUNK, movers=1,
            tuning=True, granule_min=RELAY_GRANULE_MIN, tune_hops={1}, max_retries=200,
            retry_backoff_s=0.0,
            source_wrapper=lambda h, s: lossy.wrap_source(s) if h == 1 else s,
            dest_wrapper=lambda h, d: lossy.wrap_dest(d) if h == 1 else d,
            device=device,
        ).run()
        sync(device)
        tsecs = time.perf_counter() - t0
        tlaunches = counts()
        check(rep.file_digest == tuned_host, "tuned relay file digest equals the host digest")
        check(filecmp.cmp(tuned_src, out, shallow=False),
              "tuned relay destination equals the payload")
        h1 = rep.hops[1]
        check(h1.granule_replans >= 1 and h1.granule_bytes < RELAY_CHUNK,
              f"the lossy hop shrank its granule ({h1.granule_bytes} B, "
              f"{h1.granule_replans} replans)")
        tuned = {"bytes": RELAY_TUNED_BYTES, "seconds": tsecs,
                 "GBps": RELAY_TUNED_BYTES / tsecs / 1e9,
                 "granule_bytes": [h.granule_bytes for h in rep.hops],
                 "granule_replans": [h.granule_replans for h in rep.hops],
                 "failed_reads": lossy.failed_reads, "launches": tlaunches,
                 # hops 0 and 2 move whole chunks: two launches a chunk
                 "whole_chunk_launches": 2 * 2 * (RELAY_TUNED_BYTES // RELAY_CHUNK)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"payload_s": make_s, "plain": plain, "tuned": tuned}


def cli_path(device, reset, counts) -> dict:
    """Main path, part 7: the port's ``transferd`` in process on ``device``,
    every mode on fresh directories, each with the launch counts at 0."""
    import contextlib
    import io
    import re
    import shutil
    import tempfile

    from repro_torch.launch import transferd

    dev = str(device)
    root = tempfile.mkdtemp(prefix="chip-smoke-cli-")
    real = os.path.join(root, "real")
    runs = {}

    def run(name: str, argv: list[str], *expect: str) -> str:
        buf = io.StringIO()
        sync(device)
        reset()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                transferd.main(argv)
        except SystemExit as e:
            raise RuntimeError(f"transferd {name} exited with {e.code}:\n"
                               f"{buf.getvalue()[-2000:]}") from e
        sync(device)
        out = buf.getvalue()
        runs[name] = {"seconds": time.perf_counter() - t0, "launches": counts()}
        for want in expect:
            check(want in out, f"transferd {name} printed {want!r}")
        return out

    def all_succeeded(name: str, out: str, n: int) -> None:
        states = re.findall(r"^  task-\S+\s+(\S+)", out, re.M)
        check(states == ["SUCCEEDED"] * n, f"transferd {name}: {n} tasks SUCCEEDED, got {states}")

    try:
        run("testbed", ["--policy", "all", "--small", "60", "--small-mb", "100",
                        "--large", "2", "--large-gb", "100", "--tenants", "2",
                        "--movers", "16", "--concurrent", "4"],
            "marginal/file_bound aggregate speedup")
        all_succeeded("real", run("real", ["--real", real, "--device", dev]), 4)
        all_succeeded("real_again", run("real_again", ["--real", real, "--device", dev]), 4)
        run("scrub", ["scrub", "--root", os.path.join(real, "state"), "--device", dev],
            "0 quarantined", "176 regions")
        run("cas_stats", ["cas", "stats", "--index",
                          os.path.join(real, "state", "cas", "index.log")],
            "# chunk index")
        run("fabric_plan", ["fabric", "plan", "--topology", "chain", "--dst", "d0"], "0: src")
        run("fabric_campaign", ["fabric", "campaign", "--topology", "chain", "--fanout", "4",
                                "--gb", "100", "--chaos", "link_outage_at_50pct+degrade_hop"],
            "# wire reduction")
        run("fabric_replicate", ["fabric", "replicate", "--root", os.path.join(root, "fabric"),
                                 "--fanout", "4", "--kb", "512", "--device", dev],
            "campaign SUCCEEDED: 4/4 replicas verified, 0 escapes")
        run("top", ["top", "--root", os.path.join(root, "top"), "--frames", "3",
                    "--device", dev], "--- transferd top")
        run("trace_real", ["trace", "--export", os.path.join(root, "trace.json"),
                           "--real", os.path.join(root, "trace"), "--device", dev],
            "exported ")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return runs


def digest_latency(device, iters: int = 200, threads: int = 16) -> dict:
    """Host-clock latency of one card digest of a host byte view
    (``fingerprint_on_device``: staging copy, host-to-device copy, launch,
    wait), alone and from ``threads`` threads at once, beside the host
    digest of the same bytes: the cost the movers, probes, scrubber and
    relay pay per chunk. Each call ends in a wait for its residues."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.core.dataplane import fingerprint_on_device
    from repro_torch.core.integrity import fingerprint_bytes

    out = {}
    for name, n in (("64KiB", 64 * 1024), ("256KiB", 256 * 1024),
                    ("300001B", 300_001), ("8MiB", CHUNK_BYTES)):
        data = np.random.default_rng(n).bytes(n)
        check(fingerprint_on_device(data, device) == fingerprint_bytes(data),
              f"card digest of {name} equals the host digest")
        reps = max(8, iters * 64 * 1024 // max(n, 64 * 1024 * 4))
        t0 = time.perf_counter()
        for _ in range(reps):
            fingerprint_on_device(data, device)
        alone = (time.perf_counter() - t0) / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            fingerprint_bytes(data)
        host = (time.perf_counter() - t0) / reps

        def burst(_i):
            for _ in range(reps):
                fingerprint_on_device(data, device)

        t0 = time.perf_counter()
        with ThreadPoolExecutor(threads) as pool:
            list(pool.map(burst, range(threads)))
        wall = time.perf_counter() - t0
        out[name] = {"bytes": n, "calls": reps, "card_ms": alone * 1e3, "host_ms": host * 1e3,
                     f"card_ms_{threads}_threads": wall / reps * 1e3,
                     f"card_calls_per_s_{threads}_threads": threads * reps / wall}
    return out


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
    from repro_torch.kernels import matmul_digest as mm

    def reset() -> None:
        ck.reset_launch_counts()
        mm.reset_launch_counts()

    def counts() -> dict:
        return {**ck.launch_counts(), **mm.launch_counts()}

    t_all = time.perf_counter()
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi("name,power.limit")
    props = torch.cuda.get_device_properties(0)
    card = {"sms": props.multi_processor_count,
            "clock_hz": float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6}
    print(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
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
    reset()
    api = digest_api(args.seed, device, API_BYTES)
    xfer = transfer(args.seed, device, TRANSFER_BYTES)
    torch.cuda.synchronize()
    launches = counts()
    print("digest_api " + json.dumps(api))
    print("transfer " + json.dumps(xfer))
    print("launches transfer path " + json.dumps(launches))
    for r in rows:
        check(launches[r["name"]] > 0, f"{r['name']} launched on the main path")

    for chunk_bytes in (CHUNK_BYTES, SERVICE_OVERSIZE_CHUNK):
        flip = flipped_landing(args.seed, device, chunk_bytes)
        print("flipped_landing " + json.dumps(flip))

    a, b = matmul_inputs(args.seed, device)
    mmr, dig = matmul_check(card, a, b)
    print(f"kernel matmul_digest {mmr['shape']}: residues exact, C within K*2^-24*(|A|@|B|) "
          f"of float64 (max abs err {mmr['max_abs_err_f64']:.3e}, max rel err "
          f"{mmr['max_rel_err_f64']:.3e}, {100 * mmr['max_share_of_tolerance']:.2f}% of the "
          f"tolerance; vs plain {mmr['max_abs_err']:.3e}), {mmr['ms']:.4f} ms (bound "
          f"{mmr['bound_ms']:.4f} ms by {mmr['bound_by']}, "
          f"{100 * mmr['bound_ms'] / mmr['ms']:.1f}% of bound), product only "
          f"{mmr['product_only_ms']:.4f} ms (digest share {100 * mmr['digest_share']:.2f}%), "
          f"plain {mmr['plain_ms']:.2f} ms, library {mmr['library_ms']:.4f} ms "
          f"({mmr['library_call']}), separate digest {mmr['separate_digest_ms']:.4f} ms, "
          f"library + separate digest {mmr['library_plus_digest_ms']:.4f} ms")
    check(mmr["ms"] < mmr["library_plus_digest_ms"],
          "the fused kernel is faster than the library product plus the separate digest pass")
    torch.cuda.synchronize()
    reset()
    mpath = matmul_path(a, b, dig)
    mpath["launches"] = counts()
    del a, b, dig
    print("matmul_path " + json.dumps(mpath))
    check(mpath["launches"]["matmul_digest"] > 0, "matmul_digest launched on its path")

    lat = digest_latency(device)
    print("digest_latency " + json.dumps(lat))
    ckpt = checkpoint_path(args.seed, device, reset, counts)
    print("checkpoint " + json.dumps(ckpt))
    check(ckpt["launches"]["checksum_words"] > 0,
          "the checkpoint digested its leaves on the card")
    svc = service_path(args.seed, device, reset, counts)
    print("service " + json.dumps(svc))
    for kernel in ("checksum_many_words", "checksum_words"):
        check(svc["launches"][kernel] > 0, f"{kernel} launched on the service path")
    idle = svc["idle_delta"]
    check(sum(idle["launches"].values()) >= 3 * idle["chunks_deduped"],
          "the delta save's dedup probes digested source, donor and landing on the card")
    n = SERVICE_HOST_PIPELINE_BYTES // CHUNK_BYTES
    serial, single = svc["inline_idle"]["serial"], svc["inline_idle"]["single_pass"]
    check(serial["launches"]["checksum_many_words"] == 2 * n
          and serial["launches"]["checksum_words"] == 0,
          f"the serial movers digested each chunk and its read-back on the card: "
          f"{serial['launches']}")
    check(single["launches"]["checksum_words"] == n
          and single["launches"]["checksum_many_words"] == n,
          f"the single-pass movers digested each streamed chunk and its read-back on the "
          f"card: {single['launches']}")
    relay = relay_path(args.seed, device, reset, counts)
    print("relay " + json.dumps(relay))
    plain = relay["plain"]
    check(plain["launches"]["checksum_many_words"] == plain["whole_chunk_launches"]
          and plain["launches"]["checksum_words"] == 0,
          f"every relay hop digested every chunk on the card: {plain['launches']} "
          f"(want {plain['whole_chunk_launches']} checksum_many_words)")
    check(sum(relay["tuned"]["launches"].values()) > relay["tuned"]["whole_chunk_launches"],
          "the tuned relay's granule hop digested its granules on the card")
    cli = cli_path(device, reset, counts)
    print("cli " + json.dumps(cli))
    for name in ("real", "real_again", "scrub", "fabric_replicate", "trace_real"):
        check(cli[name]["launches"]["checksum_words"]
              + cli[name]["launches"]["checksum_many_words"] > 0,
              f"transferd {name} digested on the card")
    for name in ("testbed", "fabric_plan", "fabric_campaign"):
        check(sum(cli[name]["launches"].values()) == 0, f"transferd {name} used no device")
    # each kernel's launches over every main-path run
    runs = [mpath["launches"], ckpt["launches"], svc["launches"],
            svc["idle_delta"]["launches"], serial["launches"], single["launches"],
            relay["plain"]["launches"],
            relay["tuned"]["launches"], *(r["launches"] for r in cli.values())]
    launches = {k: launches[k] + sum(r[k] for r in runs) for k in launches}
    print("launches all paths " + json.dumps(launches))

    kernels = []
    for r in rows + [{"name": "matmul_digest", "exact": True, **mmr}]:
        entry = {"name": r["name"], "route": "cuda", "source": SOURCES[r["name"]],
                 "replaces": REPLACES[r["name"]], "launches": launches[r["name"]],
                 "max_abs_err": r["max_abs_err"], "tolerance": 0, "exact": r["exact"],
                 "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"], "bound_bytes_ms": r["bound_bytes_ms"],
                 "bound_ops_ms": r["bound_ops_ms"], "library_ms": r.get("library_ms"),
                 "shape": r["shape"]}
        for extra in ("copy_ms", "bound_digest_ms", "library_call", "product_only_ms",
                      "digest_share", "separate_digest_ms", "library_plus_digest_ms",
                      "separate_digest_row_major_ms", "runs_ms", "max_abs_err_f64",
                      "max_rel_err_f64", "max_share_of_tolerance"):
            if extra in r:
                entry[extra] = r[extra]
        if r["name"] == "matmul_digest":
            entry["tolerance"] = ("C: |C - C64| <= K*2^-24*(|A|@|B|) elementwise, for the "
                                  "kernel and the plain version; residues: exact")
        kernels.append(entry)
    print(f"total: {time.perf_counter() - t_all:.1f} s on {smi}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
