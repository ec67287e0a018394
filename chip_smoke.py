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
  8. prints ``{"kernels": [...]}`` and, as the last line,
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
FLIP_BYTES = 64 * MiB

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

    flip = flipped_landing(args.seed, device)
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

    ckpt = checkpoint_path(args.seed, device, reset, counts)
    print("checkpoint " + json.dumps(ckpt))
    check(ckpt["launches"]["checksum_words"] > 0,
          "the checkpoint digested its leaves on the card")
    # each kernel's launches over the three main-path runs
    launches = {k: launches[k] + mpath["launches"][k] + ckpt["launches"][k] for k in launches}
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
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
