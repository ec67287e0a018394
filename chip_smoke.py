#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on NVIDIA cards.

    python3 chip_smoke.py [--seed 0]
        [--phases card,collectives|stripes|engine|matmul|serve_long|remat|dryrun|
                  expert_axis|family_model_axis|zero_axis|serve_model_axis|
                  serve_families]

Run from the root of a checkout, on a machine with one CUDA card (four for
the ``collectives`` phase; ``--phases collectives`` runs it alone, ``card``
the one-card phases alone; ``stripes``, ``engine``, ``matmul``,
``serve_long``, ``remat`` and ``dryrun`` run that one-card part alone;
``expert_axis``,
``family_model_axis``, ``zero_axis``, ``serve_model_axis`` and
``serve_families`` run that part of the four-card phase alone). In order:

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
     verifier must catch it and exactly one re-fetch heal it; then the
     striped transfers (``stripes_path``), every host digest patched to
     raise and each case's launches counted from 0: a 2 GiB payload in
     256 MiB chunks at 4 stripes of 64 MiB (over fuse_max_bytes: every
     stripe verified per job in ``checksum_words``) and in 32 MiB chunks at
     stripes of 8 MiB (the fused drain's rows in ``checksum_many_words``);
     one bit flipped in one stripe's first landing, healed by one re-fetch
     of that stripe; a kill after 6 journaled stripes (serial, one mover)
     restarted on the same journal with no journaled byte re-moved; the
     tuner's stripe ladder (1, 2, 4) with the chunk size pinned (at least
     one stripe re-plan); and a striped service task (4 stripes, 256 MiB
     chunks) between 1 GiB files on local disk. Each digest must equal the
     host's and each destination its payload. Then the engine's remaining
     paths (``engine_path``), in the same way, on 1 GiB in 64 MiB chunks:
     a file on local disk moved to a fresh ``FileDest`` under the serial,
     single-pass and pipelined modes (8 movers; two digests a chunk on the
     card, the pipelined verifies per job); speculative straggler
     duplication (the last chunk's first attempt sleeps 1 s once, a
     speculated twin lands it; at least one speculated); chunks 1 and 5
     failing their first attempt (two retries) and a chunk that always
     fails (the run raises); and the pipelined kill-restart (a crash at the
     9th mover call behind a verifier lagging on a slow read-back, then a
     restart from the journal that skips every journaled chunk and re-moves
     none of them);
  6. the fused matmul + digest at mistral-nemo-12b's width (d_model 5120,
     d_ff 14336): the up-projection weight A (14336, 5120) bf16 times 4096
     tokens of activations B (5120, 4096) bf16. The kernel's residues must
     equal its plain version's, the checksum kernel's digest of
     ``blocked_view(A)`` and the host digest; C must lie within
     K * 2^-24 * (|A| @ |B|) of the float64 product, and equal the
     product-only build of the same kernel (``mm_product``). Times, in
     turns: the fused kernel, its product-only build, the library product
     (cuBLAS, bf16 in, f32 out), the separate digest pass and the plain
     version, which gives the digest's share of the kernel. Then the same
     with B (5120, 4096) in float32 (row ``matmul_digest_f32b``): the split
     of B into three bf16 terms bit-equal to its plain version, the same
     residues and tolerance, and times in turns of the kernel, cuBLAS SGEMM
     (``torch.mm`` of A cast to float32 before timing, TF32 off), the split
     alone, the separate digest and the plain version; the kernel must beat
     SGEMM plus the separate digest. Then drives the public
     ``matmul_with_digest`` on each B with the launch counts at 0
     (``--phases matmul`` runs this item alone);
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
 11. trains gemma-2b at full width, cut to 2 of its 18 layers (744.5 M
     params, bf16, seq 2048, batch 4), through the port's
     ``launch.train.main`` with every host digest patched to raise: 6 steps
     with a checkpoint of the params and the AdamW state (about 7.45 GB) at
     step 4, then a fresh ``main`` that restores it and runs steps 5-6. The
     losses must be finite and fall, the restored tree equal the saved one
     bit for bit, the resumed losses equal the uninterrupted run's (within
     ``LOSS_RTOL``), and the save and the restore launch exactly the digests
     their chunk plans fix (``ckpt_launches``);
 12. serves the same weights through ``launch.serve``: a 64-token prompt and
     32 greedy tokens for a batch of 4; the decode logits at every prompt
     position must match the train forward (``DECODE_TOL``), and the card's
     f32 forward of one 128-token sequence the port's own f32 forward on the
     CPU (``F32_TOL``);
 13. the same two phases on the moe, ssm and hybrid families, each at full
     width: ``train_moe`` trains qwen3-moe-30b-a3b cut to 2 of 48 layers
     (128 experts top-8, C = 1024 slots an expert; a checkpoint of about
     18.7 GB) as phase 11 trains gemma-2b, and ``serve_moe`` serves it as
     phase 12 does, at capacity factor ``NO_DROP_CF`` in the checks, holding
     logits only at tokens whose top-k experts agree between the two runs
     compared and bounding the share that flipped (``FLIP_SHARE_BF16``,
     ``FLIP_SHARE_F32``); ``serve_grok`` serves grok-1-314b cut to 1 of 64
     layers (11.5 GB of bf16 weights; decode against the forward on the
     card, no CPU copy); ``train_ssm`` and ``serve_ssm`` mamba2-370m at full
     depth (48 layers, a 3.7 GB checkpoint); ``train_hybrid`` (3 steps, no
     checkpoint) and ``serve_hybrid`` recurrentgemma-2b cut to one 2:1
     period (3 layers);
 14. the encdec and vlm families: ``train_encdec`` trains the whole of
     whisper-large-v3 (32 encoder and 32 decoder layers at full width,
     1.535 B params, 1500 encoder frames of zero embeddings, decoder seq
     448, batch 4; a checkpoint of about 15.35 GB) as phase 11 trains
     gemma-2b, except that at the reference's init its grad norm overflows
     f32 at every step (the clip zeroes the update), which the phase
     requires and reports; ``train_encdec_cut`` shows the same launcher
     learning on whisper cut to 1+1 layers (finite grad norms, a falling
     loss); ``serve_encdec`` serves the whole model by the reference's
     protocol (``build_prefill_step``, ``prefill_cross``, then
     ``build_serve_step``'s step) over seeded frame embeddings, holding the
     prefill to ``dec_logits``' last position, and decode to the forward
     and the card to the CPU in f32 on the leading layer of each stack
     (``ENCDEC_CHECK_LAYERS``);
     ``train_vlm`` trains internvl2-2b at full width cut to 2 of 24 layers
     (2048 text tokens after the 256-token visual prefix; a checkpoint of
     about 5.05 GB) and ``serve_vlm`` serves it text-only as phase 12, then
     ``prefill_vlm`` holds its prefill step over seeded patch embeddings to
     ``logits_mm`` and the card's f32 ``logits_mm`` to the CPU's;
     ``serve_long`` (``serve_long_path``) decodes gemma2-2b at full width
     and all 26 layers, bf16, at batch 1 over a cache of the long_500k
     cell's 524288 positions (about 28 GB, drawn on the card from seeded
     tiles, ``long_cache``), 32 teacher-forced tokens from position 393200
     (crossing a four-way time cut's block boundary and the local ring's
     wrap): finite logits, every position written at its slot of every
     layer, ms a step, cache and peak GB; ``remat`` (``remat_path``) runs 3
     train steps of phase 11's gemma-2b under ``remat`` "none", "full" and
     "dots" from the same weights and batches: "dots"' losses within
     ``LOSS_RTOL`` of "full"'s (bit-equality recorded), its peak between
     theirs, step ms and peak GB of each;
 15. the dry run (``repro_torch.launch.dryrun``), with the launch counts at
     0 (it digests nothing): (a) on four cells at full width, at each probe
     depth, the walk on fake tensors against ``measure``, the same step run
     on the card — gemma-2b's train step (seq 4096, batch 4; 1 and 2
     layers), qwen3-moe-30b-a3b's decode_32k (batch 128, a 32k cache; 1 and
     2 layers), mamba2-370m's prefill_32k (batch 32, halved until the
     walk's peak is under 60 GB; 1 and 2 layers) and recurrentgemma-2b's
     long_500k (3, 6 and 8 layers): FLOPs and argument bytes equal, the
     walk's peak within 10 % of the card's, the step's ms and FLOP share
     printed; (b) ``dryrun.main`` in process, ``--mesh one --no-probes``,
     over one registry cell a family at full depth and batch (gemma-2b
     train_4k, qwen3-moe decode_32k, mamba2 long_500k, recurrentgemma-2b
     prefill_32k, whisper decode_32k, internvl2-2b train_4k): none may
     fail, each peak printed against the card's memory; then ``--mesh
     both --no-probes`` over ``DRYRUN_MESH`` (two of those cells) on the
     production meshes, this process as rank 0 of a fake world of 256 or
     512 ranks, once on fake card tensors and once on fake host tensors:
     no cell may fail, each must record collectives, and FLOPs, argument
     and output bytes and collectives must be equal on both devices; one
     ``dryrun mesh`` line a cell (argument and peak GB a rank, TFLOP,
     collective GB by group size), and no world left after them;
 16. the four-card phase ``collectives`` (``collectives_path``): with fewer
     than four cards it prints ``collectives: not run, needs 4 cards, N
     visible`` and runs nothing in its place (NCCL refuses two ranks on one
     card). Else, one rank a card under ``python -m torch.distributed.run``
     (this file's ``--rank-worker`` mode): (a) every chunked collective of
     ``repro_torch.distributed.chunked`` against NCCL's monolithic call on
     256 MiB a rank, f32 and bf16, n_chunks 1, 4 and 16 (gathers
     byte-equal, reductions within (A-1)·u·Σ|x| of float64), and
     ``ag_matmul`` / ``matmul_rs`` at mistral-nemo-12b's up-projection,
     each timed against its monolithic pair; (b) gemma-2b at full width, 2
     layers, 4 sequences a card on a 2x2x1 mesh through ``launch.train``:
     6 steps under "auto" and under "chunked" (losses finite, falling,
     within ``LOSS_RTOL`` of each other and, at step 1, of one card on the
     same 16 sequences), a checkpoint at step 4 saved by rank 0 and
     restored bit-equal on every rank with exact launch counts, the
     resumed steps equal to the uninterrupted run's, then the same root
     resumed on two ranks (elastic); (c) every other family over 2x2x1, and
     the model axis (``model_axis_path``): gemma-2b on 1x2x2 and 1x1x4 and
     internvl2-2b on 1x1x4; (d) the expert axis (``expert_axis_path``;
     ``--phases expert_axis`` runs it alone): qwen3-moe-30b-a3b at full
     width, 1 of 48 layers, the same 16 sequences a step, on 1x2x2 (64
     experts a card) and 1x1x4 (32 a card), 6 steps each: finite falling
     losses, step 1 within ``LOSS_RTOL`` of one card's on the same weights
     (the draws for tp columns are one card's, reshaped), the assignments
     each drops at step 1 printed against one card's, the f32 forward of
     one layer within ``TP_F32_TOL`` of the largest sum of magnitudes
     behind one card's logits (max |h| @ |W|) at the tokens whose top-k
     experts agree (the flipped share under ``FLIP_SHARE_F32``),
     every leaf bit-equal on the ranks that hold its block; a 12.5 GB checkpoint
     at step 4 from 1x2x2 in the tp = 2 layout, restored bit-equal on every
     rank with exact launch counts and resumed there and on 1x1x2; then
     grok-1-314b at 1 of 64 layers on 1x1x4 (2 of its 8 experts a card),
     3 steps with finite falling losses at 16 sequences (halved while the
     peak passes ``GROK_PEAK_MAX``), its f32 forward held to one card's.
     Each run prints ms a step, the all-to-all and model all-reduce ms a
     step (CUDA events around each call) and peak GB a card; (e) the model
     axis of the ssm, hybrid and encdec families
     (``family_model_axis_path``; ``--phases family_model_axis`` runs it
     alone): mamba2-370m at 8 of 48 layers, recurrentgemma-2b at 3 of 26
     (seq 2048) and whisper-large-v3 at 1+1 of 32+32 (448 target
     positions), at full width, the same 16 sequences a step, on 1x2x2 and
     1x1x4, 3 steps each in one world a mesh: finite losses, step 1 within
     ``LOSS_RTOL`` of one card's, the f32 forward of one layer within
     ``TP_F32_TOL`` of the largest of one card's logits (whisper's within
     ``ENCDEC_TP_F32_TOL``), every leaf bit-equal on the ranks that hold its block;
     recurrentgemma-2b's checkpoint at step 2 from 1x2x2, its MANIFEST a
     one-device run's, restored bit-equal on every rank with exact launch
     counts and resumed there and on 1x1x2. Each run prints ms a step, the
     model all-reduce, all-gather and reduce-scatter ms a step and peak GB
     a card; (f) ZeRO-3 over the data axis (``zero_axis_path``; ``--phases
     zero_axis`` runs it alone), which every part above also runs wherever
     its mesh has ``data`` over 1: gemma-2b at full width, 2 layers, the
     same 16 sequences a step, on 1x4x1, 2x2x1 and 1x2x2, 6 steps each:
     finite falling losses, step 1 within ``LOSS_RTOL`` of one card's, the
     f32 forward of one layer within ``TP_F32_TOL`` of one card's largest
     logit, every leaf bit-equal on the ranks that hold its block
     (``blocks_agree``); the roots saved at step 4 on 1x4x1 and 1x2x2, each
     a one-device run's MANIFEST, restored bit-equal (gathered) on every
     rank with exact launch counts, leaf by leaf into each rank's blocks,
     and resumed there and on 1x2x1 / 1x1x2; in the 1x4x1 world,
     mistral-nemo-12b at full width and 4 of its 40 layers
     (``ZERO_NEMO_CUT_ARGS``, the deepest cut whose whole train step
     fits one card under ``ZERO_PEAK_MAX``, the allocator's reserve
     counted), 3 steps of the same 16 sequences,
     run again on one card from the same weights: each step's loss and
     step 1's grad norm within ``LOSS_RTOL`` of one card's (a rank's
     gradient share lost in the reduce-scatter moves the norm),
     every leaf bit-equal on the ranks that hold its block, the one-card
     step's peak under ``ZERO_PEAK_MAX``; then mistral-nemo-12b at all 40
     layers on 1x4x1, 3 steps of 16 sequences (4 a card a pass, halved
     while the steps' peak passes ``ZERO_PEAK_MAX``): finite falling
     losses, step 1 within ``LOSS_RTOL`` of one card's loss of the same
     weights and sequences under ``no_grad`` (``one_card_step1``, passes of
     4 sequences, on this process's card after the world ends; its
     gradient's norm is held too where that pass fits under
     ``ZERO_PEAK_MAX`` without AdamW's state, else its peak is printed),
     the f32 forward of one layer within ``TP_F32_TOL`` of one card's
     largest logit, every peak under ``CARD_BYTES``, each rank's param,
     gradient and moment bytes equal to the arithmetic
     (``zero_state_bytes``: 36.7 GB a rank against 147 GB whole). Each
     measured difference is printed beside its bound. Each run prints ms a step, the
     ZeRO all-gather and reduce-scatter ms a step over ``data`` (apart
     from the model axis's), peak GB a card (the steps' and, for the
     first, the init's) and its state GB a rank; the part prints its
     seconds; (g) serving over the model axis (``serve_model_axis_path``;
     ``--phases serve_model_axis`` runs it alone): gemma-2b at full width,
     2 layers (``SERVE_ARGS``), its one-device params saved by rank 0 as a
     params-only root (every host digest patched to raise), then on 1x1x4
     under the train specs and under the weight-stationary serve specs and
     on 1x2x2 under the serve specs: each rank restores only its blocks
     (``restore_checkpoint(keep=)``; bit-equal to rank 0's saved tree,
     gathered, with the chunk plan's launches), the cache cut by
     ``cache_specs`` (time over ``model``); the f32 logits of the
     teacher-forced 64-token prompt for a batch of 4 within ``TP_F32_TOL``
     of one card's largest at ``TP_F32_LAYERS`` layer and within
     ``F32_TOL`` at 2 (one card's own f32 forward printed beside), then 32
     greedy tokens in bf16, counted against one card's (not bounded). Each run prints ms a
     decoded token (one card's beside it), the model all-gather and
     all-reduce ms a token (``collective_timer``), cache bytes and peak GB
     a card, and the save and restore seconds. In the same world
     (``long_ranks``), gemma2-2b at batch 1 over the long_500k cache, its
     time cut over model x data (1x2x2) and model x pod (2x1x2), under the
     serve specs: 32 teacher-forced tokens in f32 at 1 global layer and at
     2 (local, global), within ``TP_F32_TOL`` and ``F32_TOL`` of rank 0's
     one-card logits over the whole cache; then all 26 layers in bf16 on
     1x2x2 (a quarter of the cache a card): ms a step, its collectives,
     cache and peak GB a card. The families' serving part
     (``serve_families_path``) also serves mamba2-370m, recurrentgemma-2b
     and whisper-large-v3 at batch 1 on 1x2x2 (the time over model x data),
     an 8-token prompt and 8 greedy tokens, under the gates of their
     batch-4 runs;
 17. prints ``{"kernels": [...]}`` (after the one-card phases) and, as the
     last line, ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero before the last line. There is no CPU
path: without a card, or outside a checkout, it exits with code 2.
"""
from __future__ import annotations

import argparse
import faulthandler
import json
import os
import subprocess
import sys
import time
import traceback

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
FP32_FLOP_PER_SM = 256           # CUDA-core f32: 128 FMA lanes per SM per clock x 2 FLOP
SPLIT_TERMS = 3                  # bf16 terms of a float32 B on the tensor cores

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
STRIPE_BYTES = 2 * GiB           # the striped transfers' payload
STRIPE_CHUNK = 256 * MiB         # large chunks: 4 stripes of 64 MiB, over fuse_max_bytes
STRIPE_FUSED_CHUNK = 32 * MiB    # 4 stripes of 8 MiB: equal, tile-aligned, fused
STRIPE_COUNT = 4
STRIPE_MIN = 16 * MiB
STRIPE_FUSED_MIN = 8 * MiB       # lets a 32 MiB chunk cut into 4
STRIPE_FLIP_BYTES = 512 * MiB    # the flipped-stripe transfer: 2 chunks, 8 stripes
STRIPE_KILL_BYTES = 1 * GiB      # the killed transfer: 4 chunks, 16 stripes
STRIPE_SURVIVORS = 6             # stripes journaled before the kill
STRIPE_LADDER = (1, 2, 4)
STRIPE_LADDER_BYTES = 1 * GiB    # the tuned transfer: 16 chunks of 64 MiB
STRIPE_LADDER_CHUNK = 64 * MiB
STRIPE_SERVICE_BYTES = 1 * GiB   # the service's striped file on local disk
ENGINE_BYTES = 1 * GiB           # the engine part's payload: 16 chunks of 64 MiB
ENGINE_CHUNK = 64 * MiB          # over fuse_max_bytes: pipelined verifies run per job
ENGINE_FILE_MOVERS = 8
ENGINE_MOVERS = 4                # speculation and the kill-restart
ENGINE_STRAGGLER_S = 1.0         # the last chunk's first attempt, once
ENGINE_READ_BACK_S = 0.02        # the lagging verifier's read-back delay a chunk
ENGINE_CRASH_CALL = 9            # the mover call that raises in the killed run

SOURCES = {
    "checksum_words": "src/repro_torch/kernels/csrc/checksum.cu",
    "checksum_many_words": "src/repro_torch/kernels/csrc/checksum.cu",
    "checksum_copy_words": "src/repro_torch/kernels/csrc/checksum.cu",
    "matmul_digest": "src/repro_torch/kernels/csrc/matmul_digest.cu",
    "matmul_digest_f32b": "src/repro_torch/kernels/csrc/matmul_digest.cu",
}
REPLACES = {
    "checksum_words": "src/repro/kernels/checksum.py:112",
    "checksum_many_words": "src/repro/kernels/checksum.py:150",
    "checksum_copy_words": "src/repro/kernels/checksum.py:188",
    "matmul_digest": "src/repro/kernels/matmul_digest.py:99",
    "matmul_digest_f32b": "src/repro/kernels/matmul_digest.py:99",
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def nvidia_smi_cards(query: str) -> list[str]:
    """``nvidia_smi``'s answer for every card, in index order."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [line.strip() for line in out.stdout.strip().splitlines()]


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


def counted_case(device, reset, counts, totals: dict, fn) -> dict:
    """Runs ``fn`` with every launch count at 0 and every host digest
    raising; returns its dict with ``wall_s`` and ``launches`` added, and
    adds the launches into ``totals``."""
    sync(device)
    reset()
    t0 = time.perf_counter()
    with host_digests_raise():
        out = fn()
    sync(device)
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = counts()
    for k, v in out["launches"].items():
        totals[k] = totals.get(k, 0) + v
    return out


def stripes_path(seed: int, device, reset, counts) -> dict:
    """Main path, part 2b: striped large-chunk transfers on ``device``, every
    host digest patched to raise while each case runs, its launches counted
    from 0. (1) 256 MiB chunks in 4 stripes of 64 MiB, over the engine's
    fuse_max_bytes, so each stripe verifies per job in ``checksum_words``;
    (2) 32 MiB chunks in stripes of 8 MiB, fused in ``checksum_many_words``;
    (3) one bit flipped in one stripe's first landing, healed by one re-fetch
    of that stripe; (4) a kill after 6 journaled stripes (serial, one
    mover), restarted on the same journal; (5) the tuner's stripe ladder
    with the chunk size pinned; (6) a striped service task between files on
    local disk. Returns each case's numbers and the part's launches."""
    import filecmp
    import shutil
    import tempfile

    from repro_torch.core import (BufferDest, BufferSource, ChunkedTransfer, ChunkJournal,
                                  fingerprint_bytes, merge_all, plan_chunks)
    from repro_torch.core.transfer import STRIPE_INDEX_BASE
    from repro_torch.service import ServiceConfig, TransferService
    from repro_torch.tune import ChunkController

    t_part = time.perf_counter()
    payload = np.random.default_rng(seed + 11).bytes(STRIPE_BYTES)
    # host digests of each STRIPE_CHUNK block; a prefix's is their merge
    blocks = [fingerprint_bytes(payload[o:o + STRIPE_CHUNK])
              for o in range(0, STRIPE_BYTES, STRIPE_CHUNK)]

    def host(nbytes):
        return merge_all(blocks[:nbytes // STRIPE_CHUNK])

    setup_s = time.perf_counter() - t_part
    cases, launches = {}, {}

    def run(name, fn):
        out = counted_case(device, reset, counts, launches, fn)
        cases[name] = out
        extra = "".join(f", {k} {out[k]}" for k in ("device_jobs", "fused_jobs", "skipped",
                                                    "refetches", "stripe_replans") if k in out)
        print(f"stripes {name}: {out['bytes'] / GiB:.2f} GiB in {out['seconds']:.3f} s "
              f"({out['GBps']:.2f} GB/s), {out['stripes']} stripes, {out['striped_chunks']} "
              f"striped chunks{extra}; launches {out['launches']}")
        sys.stdout.flush()
        return out

    def engine(nbytes, chunk, dst, **kw):
        plan = plan_chunks(nbytes, kw.pop("movers", 8), min_chunk=chunk, max_chunk=chunk)
        check(plan.n_chunks == nbytes // chunk, f"plan of {nbytes // chunk} chunks")
        kw.setdefault("stripes", STRIPE_COUNT)
        kw.setdefault("stripe_min_bytes", STRIPE_MIN)
        xfer = ChunkedTransfer(BufferSource(memoryview(payload)[:nbytes]), dst, plan,
                               device=device, **kw)
        return plan, xfer

    def numbers(nbytes, rep, stats=None):
        out = {"bytes": nbytes, "seconds": rep.seconds, "GBps": nbytes / rep.seconds / 1e9,
               "stripes": rep.stripes, "striped_chunks": rep.striped_chunks,
               "stripe_replans": rep.stripe_replans, "work_items": len(rep.outcomes)}
        if stats is not None:
            out.update(device_jobs=stats.device_jobs, fused_jobs=stats.fused_jobs,
                       fused_batches=stats.fused_batches, device_rows=stats.device_rows,
                       host_rows=stats.host_rows, per_job=stats.per_job)
        return out

    # (1) large chunks: every 64 MiB stripe verified per job on the card
    def large():
        dst = BufferDest(STRIPE_BYTES)
        plan, xfer = engine(STRIPE_BYTES, STRIPE_CHUNK, dst, pipeline="pipelined",
                            integrity_workers=2)
        rep = xfer.run()
        stats = xfer.integrity_stats
        n_stripes = plan.n_chunks * STRIPE_COUNT
        check(rep.file_digest == host(STRIPE_BYTES), "large stripes: digest equals the host's")
        check(dst.buf == payload, "large stripes: destination equals the payload")
        check(rep.striped_chunks == plan.n_chunks == STRIPE_BYTES // STRIPE_CHUNK
              and rep.stripes == STRIPE_COUNT, "large stripes: every chunk striped")
        check(len(rep.outcomes) == n_stripes
              and all(i >= STRIPE_INDEX_BASE for i in rep.outcomes),
              "large stripes: every work item in the stripe band")
        check(stats.host_rows == 0 and stats.per_job == 0 and stats.errors == 0,
              "large stripes: nothing verified on the host")
        check(stats.device_jobs >= n_stripes,
              f"large stripes: each stripe verified per job: {stats}")
        return numbers(STRIPE_BYTES, rep, stats)
    out = run("large", large)
    check(out["launches"]["checksum_words"] > 0, "large stripes launched checksum_words")

    # (2) equal 8 MiB stripes: the fused drain's rows in checksum_many_words
    def fused():
        dst = BufferDest(STRIPE_BYTES)
        plan, xfer = engine(STRIPE_BYTES, STRIPE_FUSED_CHUNK, dst, pipeline="pipelined",
                            integrity_workers=2, stripe_min_bytes=STRIPE_FUSED_MIN)
        rep = xfer.run()
        stats = xfer.integrity_stats
        width = STRIPE_FUSED_CHUNK // STRIPE_COUNT
        check(len(rep.outcomes) == plan.n_chunks * STRIPE_COUNT
              and {o.chunk.length for o in rep.outcomes.values()} == {width},
              f"fused stripes: every chunk cut into {STRIPE_COUNT} stripes of {width} bytes")
        check(rep.file_digest == host(STRIPE_BYTES), "fused stripes: digest equals the host's")
        check(dst.buf == payload, "fused stripes: destination equals the payload")
        check(rep.striped_chunks == plan.n_chunks, "fused stripes: every chunk striped")
        check(stats.fused_jobs > 0 and stats.device_rows > 0 and stats.host_rows == 0,
              f"fused stripes: the drain digested stripe rows on the card: {stats}")
        return numbers(STRIPE_BYTES, rep, stats)
    out = run("fused", fused)
    check(out["launches"]["checksum_many_words"] > 0,
          "fused stripes launched checksum_many_words")

    # (3) a flipped bit in one stripe's first landing: one re-fetch of it
    stripe_len = STRIPE_CHUNK // STRIPE_COUNT
    target = STRIPE_CHUNK + stripe_len          # stripe 1 of chunk 1
    flips, moves = [], []

    class FlippyDest(BufferDest):
        def write(self, offset, data):
            if offset == target and not flips:
                flips.append(offset)
                data = bytes([data[0] ^ 0x01]) + bytes(data[1:])
            super().write(offset, data)

    def flip():
        dst = FlippyDest(STRIPE_FLIP_BYTES)
        plan, xfer = engine(STRIPE_FLIP_BYTES, STRIPE_CHUNK, dst, pipeline="pipelined",
                            integrity_workers=2,
                            fault_injector=lambda c, a: moves.append((c.offset, c.length)))
        rep = xfer.run()
        stats = xfer.integrity_stats
        n_stripes = plan.n_chunks * STRIPE_COUNT
        check(flips == [target], "flipped stripe: the bit flip happened")
        check(rep.refetches == 1 and len(rep.quarantined) == 1, "flipped stripe: one re-fetch")
        q = rep.quarantined[0]
        check((q.offset, q.length) == (target, stripe_len) and q.chunk_index >= STRIPE_INDEX_BASE,
              f"flipped stripe: the quarantined range is the stripe's, not its chunk's: {q}")
        check(sorted(moves) == sorted([(target, stripe_len)] + [
            (c.offset + s * stripe_len, stripe_len)
            for c in plan.chunks for s in range(STRIPE_COUNT)]),
              "flipped stripe: only that stripe moved twice")
        check(dst.buf == memoryview(payload)[:STRIPE_FLIP_BYTES]
              and rep.file_digest == host(STRIPE_FLIP_BYTES),
              "flipped stripe: healed destination equals the payload")
        check(stats.host_rows == 0 and stats.per_job == 0
              and stats.device_jobs == n_stripes + 1,
              "flipped stripe: every landing, the re-fetch included, verified per job on the card")
        return {**numbers(STRIPE_FLIP_BYTES, rep, stats), "refetches": rep.refetches,
                "quarantined": [q.offset, q.length], "detail": q.detail}
    run("flip", flip)

    # (4) kill after STRIPE_SURVIVORS journaled stripes, restart on the journal
    root = tempfile.mkdtemp(prefix="chip-smoke-stripes-")
    try:
        jpath = os.path.join(root, "stripes.journal")

        class HostCrash(Exception):
            pass

        def kill():
            calls = [0]

            def bomb(_chunk, _attempt):
                calls[0] += 1
                if calls[0] > STRIPE_SURVIVORS:
                    raise HostCrash("host died mid-stripe")

            dst = BufferDest(STRIPE_KILL_BYTES)
            journal = ChunkJournal(jpath)
            try:
                _, xfer = engine(STRIPE_KILL_BYTES, STRIPE_CHUNK, dst, movers=1,
                                 pipeline="serial", journal=journal, fault_injector=bomb,
                                 max_retries=0)
                try:
                    xfer.run()
                    check(False, "the killed transfer raised")
                except HostCrash:
                    pass
            finally:
                journal.close()
            journal = ChunkJournal(jpath)
            journaled = [(r.offset, r.length) for r in journal.records.values()]
            check(len(journaled) == STRIPE_SURVIVORS
                  and all(g >= STRIPE_INDEX_BASE for g in journal.records),
                  f"kill: {STRIPE_SURVIVORS} stripes journaled before the crash")
            moved = []
            try:
                _, xfer = engine(STRIPE_KILL_BYTES, STRIPE_CHUNK, dst, movers=1,
                                 pipeline="serial", journal=journal,
                                 fault_injector=lambda c, _a: moved.append((c.offset, c.length)))
                rep = xfer.run()
            finally:
                journal.close()
            check(not [m for m in moved if any(m[0] < o + n and o < m[0] + m[1]
                                               for o, n in journaled)],
                  "kill: the restart re-moved no journaled byte")
            check(rep.skipped_chunks == STRIPE_SURVIVORS and moved,
                  "kill: the journaled stripes were skipped, the rest moved")
            check(rep.file_digest == host(STRIPE_KILL_BYTES)
                  and dst.buf == memoryview(payload)[:STRIPE_KILL_BYTES],
                  "kill: digest equals the host's, destination the payload")
            return {**numbers(STRIPE_KILL_BYTES, rep), "skipped": rep.skipped_chunks,
                    "re_moved_bytes": sum(n for _o, n in moved)}
        run("kill", kill)

        # (5) the stripe ladder, the chunk size pinned: only stripes can move.
        # One serial mover feeds the tuner each chunk before it takes the
        # next, so a rung climbed re-cuts the chunks still queued.
        def ladder():
            tuner = ChunkController(chunk_bytes=STRIPE_LADDER_CHUNK,
                                    min_chunk=STRIPE_LADDER_CHUNK,
                                    max_chunk=STRIPE_LADDER_CHUNK, epoch_chunks=1,
                                    hold_patience=1, stripe_ladder=STRIPE_LADDER)
            dst = BufferDest(STRIPE_LADDER_BYTES)
            _, xfer = engine(STRIPE_LADDER_BYTES, STRIPE_LADDER_CHUNK, dst, movers=1,
                             pipeline="serial", stripes=1, tuner=tuner)
            rep = xfer.run()
            check(rep.stripe_replans >= 1 and rep.striped_chunks > 0,
                  f"ladder: the live stripe count rose ({[d.action for d in tuner.decisions]})")
            check(rep.file_digest == host(STRIPE_LADDER_BYTES)
                  and dst.buf == memoryview(payload)[:STRIPE_LADDER_BYTES],
                  "ladder: digest equals the host's, destination the payload")
            return {**numbers(STRIPE_LADDER_BYTES, rep),
                    "decisions": [d.action for d in tuner.decisions]}
        run("ladder", ladder)

        # (6) a striped service task between files on local disk
        src = os.path.join(root, "striped.bin")
        with open(src, "wb") as fh:
            fh.write(memoryview(payload)[:STRIPE_SERVICE_BYTES])
        want = host(STRIPE_SERVICE_BYTES).hexdigest()
        del payload, blocks

        def service():
            cfg = ServiceConfig(stripes=STRIPE_COUNT, chunk_bytes=STRIPE_CHUNK,
                                stripe_min_bytes=STRIPE_MIN, mover_budget=4)
            svc = TransferService(os.path.join(root, "svc"), cfg, device=device)
            try:
                t0 = time.perf_counter()
                [tid] = svc.submit([(src, src + ".out")], batch=False)
                st = svc.wait(tid, timeout=600)
                secs = time.perf_counter() - t0
            finally:
                svc.close()
            check(st.state == "SUCCEEDED", f"service: the striped task succeeded ({st.error})")
            check(st.stripes == STRIPE_COUNT and st.striped_chunks > 0,
                  "service: the task striped its chunks")
            [rep] = st.item_reports
            check(rep.digest_hex == want, "service: the item digest equals the host's")
            check(filecmp.cmp(src, src + ".out", shallow=False),
                  "service: the output file equals the input")
            return {"bytes": STRIPE_SERVICE_BYTES, "seconds": secs,
                    "GBps": STRIPE_SERVICE_BYTES / secs / 1e9, "stripes": st.stripes,
                    "striped_chunks": st.striped_chunks, "chunks": st.chunks_total,
                    "pipeline": cfg.pipeline}
        run("service", service)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"cases": cases, "launches": launches, "setup_s": setup_s,
            "seconds": time.perf_counter() - t_part}


def print_stripes(st: dict, smi: str) -> None:
    """The stripes part's JSON line and its total (each case printed its
    own line as it ended)."""
    print(json.dumps({"stripes": st}))
    print(f"stripes: part {st['seconds']:.1f} s (payload and host digests "
          f"{st['setup_s']:.1f} s); launches {st['launches']} [{smi}]")
    sys.stdout.flush()


def engine_path(seed: int, device, reset, counts) -> dict:
    """Main path, part 2c: the transfer engine's paths the earlier parts do
    not take, on ``device`` with every host digest patched to raise while
    each case runs and its launches counted from 0; the expected digest is
    taken once on the host before. 1 GiB in 64 MiB chunks: (1) from a file
    on local disk to a fresh ``FileDest`` under the serial, single-pass and
    pipelined modes (8 movers); (2) speculative straggler duplication: the
    last chunk's first attempt sleeps once, a speculated twin lands it
    (serial verification, 4 movers); (3) chunks 1 and 5 failing their
    first attempt (two retries), then a chunk that always fails (the run
    raises); (4) the pipelined kill-restart: a lagging verifier (one
    integrity worker behind a slow read-back), a crash at the 9th mover
    call, a restart from the journal that re-moves no journaled chunk.
    Returns each case's numbers and the part's launches."""
    import shutil
    import tempfile
    import threading

    from repro_torch.core import (BufferDest, BufferSource, ChunkedTransfer, ChunkJournal,
                                  FileDest, FileSource, fingerprint_bytes, plan_chunks)

    t_part = time.perf_counter()
    payload = np.random.default_rng(seed + 13).bytes(ENGINE_BYTES)
    host = fingerprint_bytes(payload)
    n_chunks = ENGINE_BYTES // ENGINE_CHUNK
    setup_s = time.perf_counter() - t_part
    cases, launches = {}, {}

    def plan(movers):
        p = plan_chunks(ENGINE_BYTES, movers, min_chunk=ENGINE_CHUNK, max_chunk=ENGINE_CHUNK)
        check(p.n_chunks == n_chunks and all(c.length == ENGINE_CHUNK for c in p.chunks),
              f"engine: a plan of {n_chunks} chunks of 64 MiB")
        return p

    def run(name, fn):
        out = counted_case(device, reset, counts, launches, fn)
        check(out["launches"]["checksum_words"] + out["launches"]["checksum_many_words"] > 0,
              f"engine {name}: the digests ran on the card")
        cases[name] = out
        rate = (f"{out['GBps']:.2f} GB/s of the engine's {out['seconds']:.3f} s"
                if "GBps" in out else f"raised after {out['wall_s']:.3f} s")
        print(f"engine {name}: {rate}, {out['chunks']} chunks, speculated "
              f"{out.get('speculated', 0)}, retries {out.get('retries', 0)}, skipped "
              f"{out.get('skipped', 0)}; launches {out['launches']}")
        sys.stdout.flush()
        return out

    def numbers(rep, **extra):
        return {"bytes": ENGINE_BYTES, "chunks": n_chunks, "seconds": rep.seconds,
                "GBps": ENGINE_BYTES / rep.seconds / 1e9, "speculated": rep.speculated,
                "retries": rep.retries, "skipped": rep.skipped_chunks,
                "pipeline": rep.pipeline, **extra}

    root = tempfile.mkdtemp(prefix="chip-smoke-engine-")
    try:
        # (1) file endpoints under each pipeline mode
        src_path = os.path.join(root, "src.bin")
        with open(src_path, "wb") as fh:
            fh.write(payload)
        for mode in ("serial", "single_pass", "pipelined"):
            dst_path = os.path.join(root, f"dst-{mode}.bin")

            def files(mode=mode, dst_path=dst_path):
                src, dst = FileSource(src_path), FileDest(dst_path, ENGINE_BYTES)
                try:
                    xfer = ChunkedTransfer(src, dst, plan(ENGINE_FILE_MOVERS), pipeline=mode,
                                           device=device)
                    rep = xfer.run()
                finally:
                    src.close()
                    dst.close()
                stats = xfer.integrity_stats
                check(rep.file_digest == host, f"engine files {mode}: digest equals the host's")
                check(rep.retries == 0 and not rep.quarantined,
                      f"engine files {mode}: no retry, no quarantine")
                out = numbers(rep)
                if stats is not None:
                    # 64 MiB is over fuse_max_bytes: each landing verifies per job
                    check(stats.device_jobs == n_chunks and stats.device_rows == 0
                          and stats.host_rows == 0 and stats.per_job == 0
                          and stats.errors == 0,
                          f"engine files {mode}: every chunk verified per job on the card: "
                          f"{stats}")
                    out.update(device_jobs=stats.device_jobs, device_rows=stats.device_rows,
                               host_rows=stats.host_rows, fused_jobs=stats.fused_jobs)
                return out
            out = run(f"files_{mode}", files)
            check(sum(out["launches"].values()) == 2 * n_chunks,
                  f"engine files {mode}: two digests a chunk on the card: {out['launches']}")
            with open(dst_path, "rb") as fh:
                landed = fh.read()
            check(landed == payload, f"engine files {mode}: the destination equals the source")
            del landed
            os.remove(dst_path)
        os.remove(src_path)

        # (2) speculative straggler duplication: the twin lands the last chunk
        def speculation():
            p = plan(ENGINE_MOVERS)
            last = p.n_chunks - 1
            slept = threading.Event()

            def straggler(chunk, _attempt):
                if chunk.index == last and not slept.is_set():
                    slept.set()
                    time.sleep(ENGINE_STRAGGLER_S)

            dst = BufferDest(ENGINE_BYTES)
            rep = ChunkedTransfer(BufferSource(payload), dst, p, fault_injector=straggler,
                                  speculative_factor=1.0, device=device).run()
            check(rep.speculated >= 1, f"engine speculation: speculated {rep.speculated}")
            check(rep.file_digest == host, "engine speculation: digest equals the host's")
            check(dst.buf == payload, "engine speculation: destination equals the payload")
            return numbers(rep)
        out = run("speculation", speculation)
        check(sum(out["launches"].values()) >= 2 * (n_chunks + 1),
              f"engine speculation: the twin digested on the card: {out['launches']}")

        # (3) transient faults retried, then a persistent one raised
        def transient():
            failed = []

            def inject(chunk, attempt):
                if chunk.index in (1, 5) and attempt == 1:
                    failed.append(chunk.index)
                    raise IOError("injected transient")

            dst = BufferDest(ENGINE_BYTES)
            rep = ChunkedTransfer(BufferSource(payload), dst, plan(ENGINE_FILE_MOVERS),
                                  fault_injector=inject, device=device).run()
            check(sorted(failed) == [1, 5] and rep.retries == 2,
                  f"engine transient: two retries ({rep.retries})")
            check(rep.file_digest == host and dst.buf == payload,
                  "engine transient: digest equals the host's, destination the payload")
            return numbers(rep)
        out = run("transient", transient)
        check(sum(out["launches"].values()) == 2 * n_chunks,
              f"engine transient: two digests a chunk on the card: {out['launches']}")

        def persistent():
            tries = []

            def dead(chunk, attempt):
                if chunk.index == 2:
                    tries.append(attempt)
                    raise IOError("dead OST")

            xfer = ChunkedTransfer(BufferSource(payload), BufferDest(ENGINE_BYTES),
                                   plan(ENGINE_FILE_MOVERS), fault_injector=dead,
                                   max_retries=2, device=device)
            try:
                xfer.run()
            except IOError as e:
                check(str(e) == "dead OST" and tries == [1, 2, 3],
                      f"engine persistent: the chunk's error after 3 attempts ({tries})")
            else:
                check(False, "engine persistent: the run raised")
            return {"bytes": ENGINE_BYTES, "chunks": n_chunks, "attempts": len(tries),
                    "raised": "IOError"}
        run("persistent", persistent)

        # (4) the engine's pipelined kill-restart with a lagging verifier
        class HostCrash(Exception):
            pass

        class SlowReadBackDest(BufferDest):
            """The zero-copy read-backs pinned to None, so every verify
            takes the slow path and the verifier lags movement."""

            read_back_into = None
            read_back_view = None

            def read_back(self, offset, length):
                time.sleep(ENGINE_READ_BACK_S)
                return super().read_back(offset, length)

        jpath = os.path.join(root, "engine.journal")
        dst = SlowReadBackDest(ENGINE_BYTES)

        def killed():
            lock = threading.Lock()
            calls = [0]

            def crash(_chunk, _attempt):
                with lock:
                    calls[0] += 1
                    if calls[0] == ENGINE_CRASH_CALL:
                        raise HostCrash("host died mid-transfer")

            journal = ChunkJournal(jpath)
            try:
                ChunkedTransfer(BufferSource(payload), dst, plan(ENGINE_MOVERS), journal=journal,
                                fault_injector=crash, max_retries=0, pipeline="pipelined",
                                integrity_workers=1, device=device).run()
                check(False, "engine kill: the killed transfer raised")
            except HostCrash:
                pass
            finally:
                journal.close()
            return {"bytes": ENGINE_BYTES, "chunks": n_chunks, "mover_calls": calls[0]}
        run("kill", killed)

        journal = ChunkJournal(jpath)
        journaled = {(r.offset, r.length) for r in journal.records.values()}
        journal.close()
        check(0 < len(journaled) < n_chunks,
              f"engine kill: {len(journaled)} of {n_chunks} chunks journaled before the crash")

        def restart():
            moved = []
            lock = threading.Lock()

            def record(chunk, _attempt):
                with lock:
                    moved.append((chunk.offset, chunk.length))

            journal = ChunkJournal(jpath)
            try:
                xfer = ChunkedTransfer(BufferSource(payload), dst, plan(ENGINE_MOVERS),
                                       journal=journal, fault_injector=record,
                                       pipeline="pipelined", integrity_workers=1,
                                       device=device)
                rep = xfer.run()
            finally:
                journal.close()
            stats = xfer.integrity_stats
            re_moved = [m for m in set(moved)
                        if any(m[0] < o + n and o < m[0] + m[1] for o, n in journaled)]
            check(re_moved == [], f"engine restart: journaled chunks re-moved: {re_moved}")
            check(rep.skipped_chunks == len(journaled),
                  f"engine restart: skipped {rep.skipped_chunks} = {len(journaled)} journaled")
            check(rep.file_digest == host,
                  "engine restart: digest equals the host's")
            check(stats.host_rows == 0 and stats.per_job == 0 and stats.device_jobs > 0,
                  f"engine restart: every verify on the card: {stats}")
            return numbers(rep, journaled=len(journaled), re_moved=len(re_moved),
                           moved_chunks=len(set(moved)), cksum_lag_s=rep.cksum_lag_s,
                           device_jobs=stats.device_jobs)
        out = run("restart", restart)
        check(dst.buf == payload, "engine restart: destination equals the payload")
        check(out["launches"]["checksum_words"] == 2 * out["moved_chunks"],
              f"engine restart: two verify digests a re-moved chunk on the card: "
              f"{out['launches']}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"cases": cases, "launches": launches, "setup_s": setup_s,
            "seconds": time.perf_counter() - t_part}


def print_engine(en: dict, smi: str) -> None:
    """The engine part's JSON line and its total (each case printed its own
    line as it ended)."""
    print("engine " + json.dumps(en))
    print(f"engine: part {en['seconds']:.1f} s (payload and host digest "
          f"{en['setup_s']:.1f} s); launches {en['launches']} [{smi}]")
    sys.stdout.flush()


def matmul_bound(card: dict, M: int, K: int, N: int, b_bytes: int = 2) -> dict:
    """Least time for C = A @ B + digest of A: the product over the bf16
    tensor-core rate (a float32 B, ``b_bytes`` 4: its three bf16 terms'
    products), A + B + C over HBM, the digest's multiply-adds over the INT32
    rate; the largest binds. A float32 B also gets the product over the
    CUDA cores' f32 rate (``bound_fp32_ms``) and the bytes with its split
    written and read once (``bound_split_bytes_ms``)."""
    clock = card["sms"] * card["clock_hz"]
    terms = SPLIT_TERMS if b_bytes == 4 else 1
    ops_ms = terms * 2 * M * N * K / (BF16_FLOP_PER_SM * clock) * 1e3
    bytes_ms = (2 * M * K + b_bytes * K * N + 4 * M * N) / HBM_BYTES_PER_S * 1e3
    digest_ms = MADDS_PER_ELEMENT * M * K / (INT32_LANES_PER_SM * clock) * 1e3
    bound_ms = max(ops_ms, bytes_ms, digest_ms)
    out = {"bound_ms": bound_ms, "bound_by": "bytes" if bound_ms == bytes_ms else "operations",
           "bound_bytes_ms": bytes_ms, "bound_ops_ms": ops_ms, "bound_digest_ms": digest_ms}
    if b_bytes == 4:
        split_bytes = 2 * SPLIT_TERMS * (-(-K // 64) * 64) * N * 2    # written, then read
        out.update(bound_fp32_ms=2 * M * N * K / (FP32_FLOP_PER_SM * clock) * 1e3,
                   bound_split_bytes_ms=bytes_ms + split_bytes / HBM_BYTES_PER_S * 1e3)
    return out


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


def matmul_inputs(seed: int, device,
                  b_dtype=torch.bfloat16) -> tuple[torch.Tensor, torch.Tensor]:
    """The up-projection of mistral-nemo-12b: nn.Linear's (out, in) weight
    A (d_ff, d_model) and TOKENS activations transposed, B (d_model, TOKENS)
    in ``b_dtype`` (bf16, or float32 as drawn)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 5)
    a = (torch.randn(D_FF, D_MODEL, generator=gen, device=device) * 0.02).to(torch.bfloat16)
    b = torch.randn(D_MODEL, TOKENS, generator=gen, device=device).to(b_dtype)
    return a, b


def matmul_held(a: torch.Tensor, b: torch.Tensor,
                tag: str) -> tuple[dict, torch.Tensor, torch.Tensor]:
    """The fused kernel's residues and C against its plain version, the
    checksum kernel and the host digest, and against float64 within
    K * 2^-24 * (|A| @ |B|). Returns (errors, residues, C)."""
    from repro_torch.core.integrity import fingerprint_bytes
    from repro_torch.kernels import fingerprint_array, ref
    from repro_torch.kernels import matmul_digest as mm

    K = a.shape[1]
    c, dig = mm.matmul_digest(a, b)
    pc, pdig = ref.matmul_digest_ref(a, b)
    check(torch.equal(dig, pdig), f"{tag} residues equal its plain version's")
    blocked = ref.blocked_view(a, 128, 128)
    check(torch.equal(fingerprint_array(blocked), dig),
          f"{tag} residues equal checksum_words' digest of blocked_view(A)")
    host = fingerprint_bytes(blocked.view(torch.uint8).cpu().numpy())
    check(tuple(dig.cpu().tolist()) == host.h,
          f"{tag} residues equal the host digest of A's blocked bytes")
    del blocked
    a64, b64 = a.double(), b.double()
    c64 = a64 @ b64
    tol = K * 2.0 ** -24 * (a64.abs() @ b64.abs())
    del a64, b64
    err = (c.double() - c64).abs()
    perr = (pc.double() - c64).abs()
    check(bool((err <= tol).all()), f"{tag} C within K*2^-24*(|A|@|B|) of the float64 product")
    check(bool((perr <= tol).all()),
          f"{tag} plain C within K*2^-24*(|A|@|B|) of the float64 product")
    out = {"shape": [a.shape[0], K, b.shape[1]], "max_abs_err": float((c - pc).abs().max()),
           "max_abs_err_f64": float(err.max()),
           "max_rel_err_f64": float(err.max() / c64.abs().max()),
           "max_share_of_tolerance": float((err / tol.clamp_min(1e-300)).max())}
    return out, dig, c


def in_turns(calls: dict) -> dict:
    """Mean ms of each call, timed in turns (a b c ... c b a); ``calls`` maps
    a key to (call, timed launches a turn). Adds ``runs_ms``."""
    runs = {key: [] for key in calls}
    for order in (list(calls), list(reversed(calls))):
        for key in order:
            fn, iters = calls[key]
            runs[key].append(cuda_ms(fn, iters=iters, warmup=1))
    return {**{key: sum(v) / len(v) for key, v in runs.items()}, "runs_ms": runs}


def matmul_check(card: dict, a: torch.Tensor, b: torch.Tensor) -> tuple[dict, torch.Tensor]:
    """Phase 6: the fused matmul + digest kernel against its plain version.
    Returns its row of the kernels line and its residues."""
    from repro_torch.kernels import fingerprint_array, ref
    from repro_torch.kernels import matmul_digest as mm

    torch.backends.cuda.matmul.allow_tf32 = False      # the plain f32 product in full f32
    torch.backends.cudnn.allow_tf32 = False
    (M, K), N = a.shape, b.shape[1]
    out, dig, c = matmul_held(a, b, "matmul_digest")
    prod = product_only(a, b)
    check(torch.equal(prod(), c), "the product-only build gives the fused kernel's C")
    del c
    lib_name, lib_call = library_matmul(a, b)
    out.update(in_turns({   # key on the kernels line: (call, timed launches a turn)
        "ms": (lambda: mm.matmul_digest(a, b), 20),
        "product_only_ms": (prod, 20),
        "library_ms": (lib_call, 20),
        "separate_digest_ms": (lambda: fingerprint_array(ref.blocked_view(a, 128, 128)), 20),
        "plain_ms": (lambda: ref.matmul_digest_ref(a, b), 2),
    }))
    out.update(
        library_call=lib_name,
        digest_share=(out["ms"] - out["product_only_ms"]) / out["ms"],
        library_plus_digest_ms=out["library_ms"] + out["separate_digest_ms"],
        separate_digest_row_major_ms=cuda_ms(lambda: fingerprint_array(a), iters=20),
        **matmul_bound(card, M, K, N))
    return out, dig


def matmul_check_f32b(card: dict, a: torch.Tensor, b: torch.Tensor) -> dict:
    """Phase 6 with a float32 B: the split of B bit-equal to its plain
    version, then ``matmul_held`` and the times, in turns, of the kernel,
    cuBLAS SGEMM on A cast to float32 before timing (TF32 off), the split
    alone, the separate digest pass and the plain version. Returns the
    ``matmul_digest_f32b`` row of the kernels line."""
    from repro_torch.kernels import fingerprint_array, ref
    from repro_torch.kernels import matmul_digest as mm

    torch.backends.cuda.matmul.allow_tf32 = False      # SGEMM and the plain product in full f32
    (M, K), N = a.shape, b.shape[1]
    split = mm.split_bf16x3(b)
    check(torch.equal(split.view(torch.int16), ref.split_bf16x3(b).view(torch.int16)),
          "split_bf16x3 kernel bit-equal to its plain version")
    del split
    out, _, c = matmul_held(a, b, "matmul_digest (f32 B)")
    del c
    a32 = a.float()
    sgemm = lambda: torch.mm(a32, b)   # noqa: E731
    check(sgemm().dtype == torch.float32, "torch.mm(a32, b) gives f32")
    out.update(in_turns({
        "ms": (lambda: mm.matmul_digest(a, b), 10),
        "library_ms": (sgemm, 10),
        "split_ms": (lambda: mm.split_bf16x3(b), 20),
        "separate_digest_ms": (lambda: fingerprint_array(ref.blocked_view(a, 128, 128)), 20),
        "plain_ms": (lambda: ref.matmul_digest_ref(a, b), 2),
    }))
    del a32
    out.update(
        library_call="torch.mm(a32, b), a32 = a.float() cast before timing, TF32 off "
                     "(cuBLAS SGEMM)",
        library_plus_digest_ms=out["library_ms"] + out["separate_digest_ms"],
        **matmul_bound(card, M, K, N, b_bytes=4))
    return out


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


# gemma-2b (src/repro/configs/gemma_2b.py:8) at full width, cut to 2 of its 18 layers
TRAIN_ARGS = ["--arch", "gemma-2b", "--layers", "2", "--seq-len", "2048", "--global-batch", "4",
              "--lr", "3e-3", "--log-every", "1"]
TRAIN_STEPS, TRAIN_CKPT_STEP = 6, 4
LOSS_RTOL = 2e-3                 # resumed steps against the uninterrupted run's
SERVE_ARGS = ["--arch", "gemma-2b", "--layers", "2"]
# qwen3-moe-30b-a3b (src/repro/configs/qwen3_moe_30b_a3b.py:10) at full width, 2 of 48 layers
MOE_TRAIN_ARGS = ["--arch", "qwen3-moe-30b-a3b", "--layers", "2", "--seq-len", "2048",
                  "--global-batch", "4", "--lr", "3e-3", "--log-every", "1"]
MOE_SERVE_ARGS = ["--arch", "qwen3-moe-30b-a3b", "--layers", "2"]
# grok-1-314b (src/repro/configs/grok_1_314b.py:13) at full width, 1 of 64 layers: served only
GROK_SERVE_ARGS = ["--arch", "grok-1-314b", "--layers", "1"]
# mamba2-370m (src/repro/configs/mamba2_370m.py:8) at full width and full depth (48 layers)
SSM_TRAIN_ARGS = ["--arch", "mamba2-370m", "--seq-len", "2048", "--global-batch", "4",
                  "--lr", "3e-3", "--log-every", "1"]
SSM_SERVE_ARGS = ["--arch", "mamba2-370m"]
# recurrentgemma-2b (src/repro/configs/recurrentgemma_2b.py:9) at full width, one 2:1
# period (3 of 26 layers: 2 RG-LRU, 1 local attention); 3 steps, no checkpoint
HYBRID_TRAIN_ARGS = ["--arch", "recurrentgemma-2b", "--layers", "3", "--seq-len", "2048",
                     "--global-batch", "4", "--lr", "3e-3", "--log-every", "1"]
HYBRID_SERVE_ARGS = ["--arch", "recurrentgemma-2b", "--layers", "3"]
HYBRID_TRAIN_STEPS = 3
# whisper-large-v3 (src/repro/configs/whisper_large_v3.py:10) whole: 32 encoder and 32 decoder
# layers at full width, 1500 encoder frames; the decoder at Whisper's 448 target positions
ENCDEC_TRAIN_ARGS = ["--arch", "whisper-large-v3", "--seq-len", "448", "--global-batch", "4",
                     "--lr", "3e-3", "--log-every", "1"]
ENCDEC_SERVE_ARGS = ["--arch", "whisper-large-v3"]
# At the reference's init whisper's attention logits have a std of ~48 (wq and wk scaled by
# 1/sqrt(heads)), so its layers amplify rounding: in f32 on the CPU one sequence alone and in a
# batch differs by 3.9e-5 of the largest logit at 1+1 layers, 3.5e-4 at 2+2, 8e-3 at 4+4 and
# 0.36 at 8+8, and the grad norm grows ~10x a layer (2.4e3 at 1+1, 4.6e9 at 6+6), past f32 at
# 32+32. So serve_encdec holds its tolerances on the leading layer of each stack (the same
# weights), and train_encdec's learning is checked on a model of that depth.
ENCDEC_CHECK_LAYERS = 1
# internvl2-2b (src/repro/configs/internvl2_2b.py:10) at full width, 2 of 24 layers; 2048 text
# tokens after the 256-token visual prefix
VLM_TRAIN_ARGS = ["--arch", "internvl2-2b", "--layers", "2", "--seq-len", "2048",
                  "--global-batch", "4", "--lr", "3e-3", "--log-every", "1"]
VLM_SERVE_ARGS = ["--arch", "internvl2-2b", "--layers", "2"]
NO_DROP_CF = 16.0                # MoE capacity factor of the checks: no token dropped
FLIP_SHARE_BF16 = 0.15           # MoE: tokens whose top-k set differs, decode vs forward, bf16
FLIP_SHARE_F32 = 0.03            # the same in f32 (decode vs forward, card vs CPU)
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 64, 32
SERVE_FORWARD_TOKENS = 128       # the card's forward against the port's CPU f32 forward
DECODE_TOL = 2.0 ** -5           # bf16: max |decode - forward| over max |forward|
F32_TOL = 2.0 ** -10             # f32 card forward against the CPU f32 forward, same scale
PREFILL_TOL = 2.0 ** -7          # bf16 prefill step against the forward's last position: an ulp
BF16_PEAK_FLOPS = 989.4e12       # H100 SXM dense bf16, NVIDIA data sheet (at 700 W)
# serving at batch 1 over the long_500k cell's cache: gemma2-2b (src/repro/configs/gemma2_2b.py:9)
# at full width and all 26 layers, bf16, its global layers' cache of LONG_T positions and its local
# layers' ring of 4096, drawn on the card from seeded tiles of LONG_TILE slots; LONG_STEPS tokens
# decoded from LONG_START, which crosses the boundary of a four-way time cut of the global cache
# (slot 393216) and the wrap of the ring (slot 4096 -> 0, a four-way cut's boundary too)
LONG_ARGS = ["--arch", "gemma2-2b"]
LONG_T = 524288
LONG_TILE = 1024
LONG_STEPS = 32
LONG_START = 3 * LONG_T // 4 - LONG_STEPS // 2
# remat "none", "full" and "dots": gemma-2b as the train phase runs it (TRAIN_ARGS), REMAT_STEPS each
REMAT_STEPS = 3
# the dry run (launch.dryrun): walk against card on four cells, then full-depth walks
DRYRUN_TRAIN_SEQ, DRYRUN_TRAIN_BATCH = 4096, 4      # gemma-2b's train cell of the smoke
DRYRUN_PREFILL_BATCH = 32        # mamba2-370m prefill_32k: halved until the walk's peak fits
DRYRUN_PREFILL_MAX_BYTES = 60e9
DRYRUN_PEAK_REL = 0.10           # the walk's peak against max_memory_allocated on the card
# one cell a family; whisper's decode_32k, not its prefill_32k, whose walk alone
# (64 KV blocks a decoder layer, 32 layers) takes 44 s on the card's host
DRYRUN_FULL = [("gemma-2b", "train_4k"), ("qwen3-moe-30b-a3b", "decode_32k"),
               ("mamba2-370m", "long_500k"), ("recurrentgemma-2b", "prefill_32k"),
               ("whisper-large-v3", "decode_32k"), ("internvl2-2b", "train_4k")]
# DRYRUN_FULL's cells walked on both production meshes, on the card's fake tensors
# and the host's: four walks a cell (gemma-2b's train cell ~100 s of them, whisper's
# decode ~25 s on the card's host), so the other four are left out to hold the part
# near 120 s (``launch.dryrun --all --mesh both --device cpu`` walks every cell)
DRYRUN_MESH = [("gemma-2b", "train_4k"), ("whisper-large-v3", "decode_32k")]


class host_digests_raise:
    """Every host digest the checkpoint path could reach raises while this
    is entered: the digest module's, the data plane's, the running
    (streaming) host fingerprint, and the names the engine and the
    checkpoint module hold."""

    def __enter__(self):
        import importlib

        def host_digest(*_a, **_k):
            raise AssertionError("a host digest ran")

        self.saved = []
        integrity = importlib.import_module("repro_torch.core.integrity")
        targets = [(integrity, ("fingerprint_bytes", "fingerprint_many")),
                   (integrity.RunningFingerprint, ("update",))]
        for mod in ("repro_torch.core.dataplane", "repro_torch.core.transfer",
                    "repro_torch.ckpt.checkpoint"):
            targets.append((importlib.import_module(mod),
                            ("fingerprint_bytes", "fingerprint_many", "fingerprint_view")))
        for obj, names in targets:
            for name in names:
                if name in vars(obj):
                    self.saved.append((obj, name, vars(obj)[name]))
                    setattr(obj, name, host_digest)
        return self

    def __exit__(self, *_exc):
        for obj, name, value in self.saved:
            setattr(obj, name, value)


def ckpt_launches(manifest: dict) -> dict:
    """The digest launches a checkpoint of card leaves takes, fixed by its
    chunk plan: on save the serial movers digest each chunk and its read-back
    (``checksum_many_words`` for a tile-aligned chunk, else
    ``checksum_words``) and each leaf is digested once on the card
    (``checksum_words``); the restore digests each run of back-to-back
    chunks of one tile-aligned length in one ``checksum_many_words`` and
    every other chunk in one ``checksum_words``."""
    from repro_torch.kernels.checksum import TILE_BYTES

    save = {"checksum_words": 0, "checksum_many_words": 0}
    restore = dict(save)
    for entry in manifest["leaves"].values():
        if not entry["nbytes"]:
            continue
        save["checksum_words"] += 1
        prev = None
        for c in entry["chunks"]:
            aligned = c["length"] % TILE_BYTES == 0
            save["checksum_many_words" if aligned else "checksum_words"] += 2
            if not aligned:
                restore["checksum_words"] += 1
            elif prev is None or prev["length"] != c["length"] \
                    or prev["offset"] + prev["length"] != c["offset"] \
                    or prev["length"] % TILE_BYTES:
                restore["checksum_many_words"] += 1
            prev = c
    return {"save": save, "restore": restore}


def _arg(args: list, flag: str, default=None):
    return args[args.index(flag) + 1] if flag in args else default


def with_arg(args: list, flag: str, value) -> list:
    """``args`` with ``flag``'s value replaced by ``value``."""
    i = args.index(flag)
    return args[:i + 1] + [str(value)] + args[i + 2:]


def smoke_model(args: list, *, cf: float | None = None, dtype=None):
    """The model a launcher builds from ``args`` (arch, ``--layers``, both
    stacks of an encdec), with a MoE's capacity factor ``cf`` and the dtype
    overridden where given."""
    from repro_torch.configs.registry import build_model
    from repro_torch.launch.train import with_layers

    kw = {"cf": cf} if cf is not None else {}
    model = build_model(_arg(args, "--arch"), smoke="--smoke" in args, **kw)
    model = with_layers(model, int(_arg(args, "--layers", 0)))
    return model if dtype is None else smoke_model_like(model, dtype)


def flop_counts(model, batch: int, seq: int) -> dict:
    """Model FLOPs of a train step of ``batch`` sequences of ``seq`` tokens: 6 x
    the params each token touches (a MoE's: the top-k experts,
    ``active_param_count``), and for a MoE apart the FLOPs its expert
    matmuls run over the padded capacity (E x C rows a layer, C from
    ``capacity``). An encdec counts its matmul weights per stack: the
    encoder's over the frames, the decoder's and the tied embedding's over
    the tokens, the cross-attention ``wk`` and ``wv`` over the frames. A
    vlm's sequences are its visual prefix and the tokens."""
    cfg = model.cfg
    tokens = batch * (seq + cfg.n_vis_tokens)
    out = {"params": cfg.param_count(), "active_params": cfg.active_param_count(),
           "tokens": tokens, "model_flops": 6 * cfg.active_param_count() * tokens,
           "flop_count": f"6 x {cfg.active_param_count()} active params x {tokens} tokens"}
    if cfg.family == "moe":
        from repro_torch.models.moe import capacity

        C = capacity(tokens, cfg, 1, model.cf)
        expert = 3 * cfg.d_model * cfg.d_ff
        dense = cfg.active_param_count() - cfg.n_layers * cfg.top_k * expert
        out.update(capacity=C, executed_flops=6 * (dense * tokens
                                                   + cfg.n_layers * cfg.n_experts * C * expert))
    if cfg.family == "encdec":
        D, A = cfg.d_model, cfg.d_model * cfg.n_heads * cfg.hd
        mlp = 2 * D * cfg.d_ff
        frames = batch * cfg.enc_positions
        enc = cfg.n_enc_layers * (4 * A + mlp)
        dec = cfg.n_layers * (6 * A + mlp) + cfg.vocab * D
        cross_kv = cfg.n_layers * 2 * A
        out.update(frames=frames, model_flops=6 * ((enc + cross_kv) * frames + dec * tokens),
                   flop_count=f"6 x ({enc} encoder + {cross_kv} cross K/V weights x {frames} "
                              f"frames + {dec} decoder and embedding weights x {tokens} tokens)")
    return out


def flat_tree(tree, prefix=""):
    """A nested dict's leaves keyed by their "/"-joined path."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def recording_manager(records: dict, device, reset, counts):
    """The launcher's ``CheckpointManager``, keeping in ``records`` a host
    copy of what it saved (``saved``), the restored tree (``restored``), and
    the seconds and launches of each (``save``, ``restore``)."""
    from repro_torch.ckpt import CheckpointManager

    class Recording(CheckpointManager):
        def save(self, step, tree, **kw):
            materialize = kw.get("materialize")
            if materialize is None:
                records["saved"] = {k: t.to("cpu", copy=True) for k, t in flat_tree(tree).items()}
            else:        # a sharded run: each leaf as written, gathered (a copy on the card)
                records["saved"] = {}

                def recorded(key, t):
                    whole = materialize(key, t)
                    records["saved"][key] = whole.detach().clone()
                    return whole

                kw["materialize"] = recorded
            sync(device)
            reset()
            t0 = time.perf_counter()
            rep = super().save(step, tree, **kw)
            sync(device)
            records["save"] = {"seconds": time.perf_counter() - t0, "launches": counts(),
                               "bytes": rep.total_bytes, "path": rep.path}
            return rep

        def restore(self, step=None, **kw):
            sync(device)
            reset()
            t0 = time.perf_counter()
            tree, got = super().restore(step, **kw)
            sync(device)
            records["restore"] = {"seconds": time.perf_counter() - t0, "launches": counts()}
            records["restored"] = flat_tree(tree)
            return tree, got

    return Recording


def train_path(seed: int, device, reset, counts, args=TRAIN_ARGS, steps=TRAIN_STEPS,
               ckpt_step=TRAIN_CKPT_STEP, learns: bool = True) -> dict:
    """Main path, part 8: the port's training launcher (``launch.train.main``)
    on ``args`` (gemma-2b at full width, 2 layers, by default): ``steps``
    steps with a checkpoint of the params and the AdamW state at
    ``ckpt_step``, then a fresh ``main`` that restores it and runs the rest;
    every host digest raises meanwhile. With ``ckpt_step`` None, the steps
    alone. The saved tree is kept on the host and the restored one held to
    it bit for bit, leaf by leaf. The losses must be finite; with
    ``learns``, every grad norm finite and the loss falling; without, every
    grad norm must overflow f32 (the clip then zeroes each update: whisper
    whole at the reference's init, ``ENCDEC_CHECK_LAYERS``)."""
    import shutil
    import tempfile

    from repro_torch.launch import train

    records = {}
    Recording = recording_manager(records, device, reset, counts)
    seq, batch = int(_arg(args, "--seq-len")), int(_arg(args, "--global-batch"))
    model = smoke_model(args)
    flops = flop_counts(model, batch, seq)
    base = args + ["--seed", str(seed), "--device", str(device), "--steps", str(steps)]
    def held(run):
        losses, norms = run["losses"], run["grad_norms"]
        check(len(losses) == steps and all(np.isfinite(losses)), f"finite losses {losses}")
        if learns:
            check(all(np.isfinite(norms)), f"finite grad norms {norms}")
            check(losses[-1] < losses[0], f"the loss falls over {steps} steps: {losses}")
        else:
            check(not any(np.isfinite(norms)),
                  f"every grad norm overflows f32, so no step moves the weights: {norms}")
        return losses

    if ckpt_step is None:
        reset()
        first = train.main(base)
        losses = held(first)
        out = {"losses": losses, "launches": counts()}
    else:
        root = tempfile.mkdtemp(prefix="chip-smoke-train-")
        real_manager = train.CheckpointManager
        train.CheckpointManager = Recording
        try:
            with host_digests_raise():
                first = train.main(base + ["--ckpt-dir", root, "--ckpt-every", str(ckpt_step)])
                with open(os.path.join(records["save"]["path"], "MANIFEST.json")) as fh:
                    manifest = json.load(fh)
                resumed = train.main(base + ["--ckpt-dir", root, "--ckpt-every", "0"])
        finally:
            train.CheckpointManager = real_manager
            shutil.rmtree(root, ignore_errors=True)
        losses, again = held(first), resumed["losses"]
        saved, restored = records.pop("saved"), records.pop("restored")
        check(sorted(saved) == sorted(restored) == sorted(manifest["leaves"]),
              "the restored tree has the saved tree's leaves")
        for key, t in saved.items():
            r = restored[key]
            check(r.device == torch.device(device) and r.dtype == t.dtype
                  and r.shape == t.shape
                  and torch.equal(r.reshape(-1).view(torch.uint8),
                                  t.to(r.device).reshape(-1).view(torch.uint8)),
                  f"{key} restored bit for bit on the card")
        del saved, restored
        tail = losses[ckpt_step:]
        check(len(again) == steps - ckpt_step
              and all(abs(a - b) <= LOSS_RTOL * abs(b) for a, b in zip(again, tail)),
              f"the resumed steps repeat the uninterrupted run's losses: {again} vs {tail}")
        nbytes = records["save"]["bytes"]
        out = {"losses": losses, "resumed_losses": again, "loss_rtol": LOSS_RTOL,
               "resumed_step_ms": [x * 1e3 for x in resumed["step_seconds"]],
               "ckpt_bytes": nbytes, "leaves": len(manifest["leaves"]),
               "chunks": sum(len(e["chunks"]) for e in manifest["leaves"].values()),
               "save_s": records["save"]["seconds"],
               "save_GBps": nbytes / records["save"]["seconds"] / 1e9,
               "restore_s": records["restore"]["seconds"],
               "restore_GBps": nbytes / records["restore"]["seconds"] / 1e9,
               "expected_launches": ckpt_launches(manifest),
               "launches_save": records["save"]["launches"],
               "launches_restore": records["restore"]["launches"],
               "launches": {k: records["save"]["launches"][k]
                            + records["restore"]["launches"][k]
                            for k in records["save"]["launches"]}}
    steady = sorted(first["step_seconds"][1:])[len(first["step_seconds"][1:]) // 2]
    out.update({"arch": _arg(args, "--arch"), "layers": model.cfg.n_layers,
                "grad_norms": first["grad_norms"], "tokens_per_step": flops["tokens"],
                "step_ms": [x * 1e3 for x in first["step_seconds"]],
                "steady_step_ms": steady * 1e3, "tokens_per_s": flops["tokens"] / steady,
                **flops, "model_flop_share": flops["model_flops"] / steady / BF16_PEAK_FLOPS})
    if model.cfg.family == "encdec":
        out["enc_layers"] = model.cfg.n_enc_layers
    if "executed_flops" in flops:
        out["executed_flop_share"] = flops["executed_flops"] / steady / BF16_PEAK_FLOPS
    return out


def topk_sets(route_log: list, k: int) -> list:
    """Each logged MoE layer's chosen experts per token, sorted: (tokens, k)."""
    return [torch.topk(p, k, dim=-1).indices.sort(dim=-1).values.cpu() for p in route_log]


def decode_vs_forward(model, params, prompts, device, audio=None) -> dict:
    """Decode the prompts token by token and hold each step's logits to the
    train forward's at that position (soft-capped as decode caps them).
    The scale is the largest uncapped forward logit: the cap is 1-Lipschitz,
    so it cannot grow an error made before it. A MoE logs its routing: a
    token whose top-k set differs between the two in any layer is left out
    of the error and counted in ``flipped_share``. An encdec decodes over
    the encoder output of ``audio`` (``prefill_cross``) against
    ``dec_logits`` on the same encoder output."""
    from repro_torch.models.common import softcap

    moe = model.cfg.family == "moe"
    B, S = prompts.shape
    k = model.cfg.top_k
    with torch.no_grad():
        model.route_log = [] if moe else None
        if audio is None:
            raw = model.logits(params, prompts).float()
        else:
            raw = model.dec_logits(params, prompts, model.encode(params, audio)).float()
        full = softcap(raw, model.cfg.final_softcap)
        fwd_sets = topk_sets(model.route_log or [], k)
        scale = float(raw.abs().max())
        del raw
        cache = model.init_cache(B, S, device=device)
        if audio is not None:
            cache = model.prefill_cross(params, cache, audio)
        flipped = torch.zeros((B, S), dtype=torch.bool)
        errs = torch.zeros((B, S))
        for t in range(S):
            pos = torch.full((B,), t, dtype=torch.int32, device=device)
            model.route_log = [] if moe else None
            lg, cache = model.decode_step(params, cache, prompts[:, t:t + 1], pos)
            errs[:, t] = (lg[:, 0].float() - full[:, t]).abs().amax(-1).cpu()
            for f, d in zip(fwd_sets, topk_sets(model.route_log or [], k)):
                flipped[:, t] |= (f.reshape(B, S, k)[:, t] != d).any(-1)
        model.route_log = None
    out = {"max_abs_err": float(errs[~flipped].max()), "scale": scale}
    if moe:
        out.update(flipped_share=float(flipped.float().mean()),
                   max_abs_err_all_tokens=float(errs.max()))
    return out


def serve_path(seed: int, device, args=SERVE_ARGS, *, f32_cpu: bool = True,
               bf16_decode_bound: bool = True) -> dict:
    """Main path, part 9: the port's serving launcher (``launch.serve``) on
    ``args`` with the train phase's weights (the same seed): greedy decode of
    a 64-token prompt and 32 new tokens for a batch of 4, then
    ``decode_vs_forward`` on the prompt in bf16 on the card (within
    ``DECODE_TOL``; with ``bf16_decode_bound`` False, measured only: at
    mamba2's 48 layers bf16 rounding compounds through the depth, and
    grok-1's logits are capped at 30 while its largest uncapped logit, each
    token's own tied embedding, is in the thousands), the same in f32 on the
    card (within ``F32_TOL``) and, with ``f32_cpu``, the card's f32 forward of
    one 128-token sequence held to the port's own f32 forward on the CPU
    (``F32_TOL``). The bf16 forward's distance from the
    f32 one is reported, not bounded: with the reference's init (wk and wv
    scaled by 1/sqrt(KV heads), 1 for MQA) the attention logits reach
    hundreds and the softmax is nearly one-hot, so bf16 rounding flips
    near-tied keys and moves single logits far.

    A MoE is checked at capacity factor ``NO_DROP_CF`` (no token dropped, as
    the reference's decode test does) with its routing logged: a token whose
    top-k set differs between the two runs compared (a near tie of the k-th
    and (k+1)-th expert that the last bits of the hidden state flip) is left
    out of the logit bound, and the share of such tokens must stay under
    ``FLIP_SHARE_BF16`` in bf16 and ``FLIP_SHARE_F32`` in f32."""
    import contextlib
    import io

    from repro_torch.launch import serve
    from repro_torch.optim.adamw import tree_map

    moe = smoke_model(args).cfg.family == "moe"
    cf = NO_DROP_CF if moe else None
    model = smoke_model(args, cf=cf)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        seqs = serve.main(args + ["--batch", str(SERVE_BATCH), "--prompt-len",
                                  str(SERVE_PROMPT), "--gen", str(SERVE_GEN),
                                  "--seed", str(seed), "--device", str(device)])
    check(seqs.shape == (SERVE_BATCH, SERVE_PROMPT + SERVE_GEN)
          and (seqs >= 0).all() and (seqs < model.cfg.vocab).all(),
          f"serve.main generated ({SERVE_BATCH}, {SERVE_PROMPT + SERVE_GEN}) tokens")
    params = model.init_params(seed, device)
    prompts = serve.prompts_for(seed, SERVE_BATCH, SERVE_PROMPT, model.cfg.vocab, device)
    serve.generate(model, params, prompts, 2, SERVE_PROMPT + 2)       # warm-up
    sync(device)
    t0 = time.perf_counter()
    again = serve.generate(model, params, prompts, SERVE_GEN, SERVE_PROMPT + SERVE_GEN)
    sync(device)
    wall = time.perf_counter() - t0
    check(np.array_equal(again.cpu().numpy(), seqs), "generate repeats serve.main's tokens")
    steps = SERVE_PROMPT + SERVE_GEN - 1
    out = {"arch": _arg(args, "--arch"), "layers": model.cfg.n_layers, "batch": SERVE_BATCH,
           "prompt": SERVE_PROMPT, "generated": SERVE_GEN, "decode_steps": steps,
           "seconds": wall, "ms_per_decode_step": wall / steps * 1e3,
           "tokens_per_s": SERVE_BATCH * steps / wall,
           "generated_tokens_per_s": SERVE_BATCH * SERVE_GEN / wall,
           "serve_main": buf.getvalue().strip().splitlines()[0]}
    if moe:
        out["capacity_factor"] = cf

    def hold(name, res, tol, flip_max, bounded=True):
        if moe:
            check(res["flipped_share"] <= flip_max,
                  f"{name}: the two runs route the same experts: "
                  f"{res['flipped_share']:.3%} of tokens flipped > {flip_max:.0%}")
        if bounded:
            hold_to(out, name, res, tol)
        else:
            out.update({f"{name}_{key}": val for key, val in res.items()})
            out[f"{name}_tolerance"] = "measured, not bounded"

    hold("decode_vs_forward", decode_vs_forward(model, params, prompts, device), DECODE_TOL,
         FLIP_SHARE_BF16, bf16_decode_bound)
    with torch.no_grad():
        gen = torch.Generator().manual_seed(seed + 11)
        tokens = torch.randint(0, model.cfg.vocab, (1, SERVE_FORWARD_TOKENS), generator=gen,
                               dtype=torch.int32)
        bf16 = model.logits(params, tokens.to(device)).float().cpu() if f32_cpu else None
        f32_model = smoke_model(args, cf=cf, dtype=torch.float32)
        params32 = tree_map(lambda t: t.float(), params)
        del params
        hold("f32_decode_vs_forward", decode_vs_forward(f32_model, params32, prompts, device),
             F32_TOL, FLIP_SHARE_F32)
        if not f32_cpu:
            return out
        f32_model.route_log = [] if moe else None
        card = f32_model.logits(params32, tokens.to(device)).cpu()
        card_sets = topk_sets(f32_model.route_log or [], model.cfg.top_k)
        params32 = tree_map(lambda t: t.cpu(), params32)
        f32_model.route_log = [] if moe else None
        ref = f32_model.logits(params32, tokens)
        host_sets = topk_sets(f32_model.route_log or [], model.cfg.top_k)
        f32_model.route_log = None
        del params32
    flip32 = torch.zeros(SERVE_FORWARD_TOKENS, dtype=torch.bool)
    for a, b in zip(card_sets, host_sets):
        flip32 |= (a != b).any(-1)
    hold("f32_card_vs_cpu", {"max_abs_err": float((card - ref).abs()[0][~flip32].max()),
                             "scale": float(ref.abs().max()),
                             **({"flipped_share": float(flip32.float().mean())} if moe else {})},
         F32_TOL, FLIP_SHARE_F32)
    check(bool(torch.isfinite(bf16).all()), "the card's bf16 forward is finite")
    bf16_err = (bf16 - ref).abs()
    out.update({"bf16_vs_f32_max_abs_err": float(bf16_err.max()),
                "bf16_vs_f32_mean_abs_err": float(bf16_err.mean()),
                "f32_mean_abs_logit": float(ref.abs().mean()),
                "bf16_argmax_agreement": float((bf16.argmax(-1) == ref.argmax(-1)).float().mean())})
    return out


def hold_to(out: dict, name: str, res: dict, tol: float) -> None:
    """Record ``res`` under ``name`` and require its error within ``tol`` of
    its scale."""
    for key, val in res.items():
        out[f"{name}_{key}"] = val
    out[f"{name}_tolerance"] = f"{tol} x max|uncapped forward logits|"
    check(res["max_abs_err"] <= tol * res["scale"],
          f"{name}: max |err| {res['max_abs_err']:.4g} > {tol} x {res['scale']:.4g}")


def seeded_embeddings(seed: int, batch: int, rows: int, model, device) -> torch.Tensor:
    """A stubbed frontend's output (frame or patch embeddings), standard
    normal, drawn on the host so every device gets the same."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((batch, rows, model.cfg.d_model), generator=gen).to(device, model.cfg.dtype)


def cpu_forward_check(model, params, forward, *inputs) -> dict:
    """``forward(model, params, *inputs)`` of a f32 copy on the card against
    the same on the CPU: the error, the scale and the CPU's seconds."""
    from repro_torch.optim.adamw import tree_map

    f32 = smoke_model_like(model, torch.float32)
    params32 = tree_map(lambda t: t.float(), params)
    with torch.no_grad():
        card = forward(f32, params32, *(x.float() if x.is_floating_point() else x
                                        for x in inputs)).cpu()
        params32 = tree_map(lambda t: t.cpu(), params32)
        t0 = time.perf_counter()
        host = forward(f32, params32, *(x.cpu().float() if x.is_floating_point() else x.cpu()
                                        for x in inputs))
        seconds = time.perf_counter() - t0
    return {"max_abs_err": float((card - host).abs().max()), "scale": float(host.abs().max()),
            "cpu_seconds": seconds}


def smoke_model_like(model, dtype):
    """``model`` rebuilt with ``dtype`` (its own arguments kept)."""
    import dataclasses

    from repro_torch.launch.train import rebuild

    return rebuild(model, dataclasses.replace(model.cfg, dtype=dtype))


def batch_sensitivity(model, params, forward, *inputs) -> float:
    """How far ``forward`` of the first sequence alone lies from the same
    sequence as row 0 of the batch ``inputs``: the same function summed in
    another order, over the largest logit."""
    with torch.no_grad():
        batch = forward(model, params, *inputs)[:1].float()
        alone = forward(model, params, *(x[:1] for x in inputs)).float()
    return float((alone - batch).abs().max() / batch.abs().max())


def serve_encdec_path(seed: int, device, args=ENCDEC_SERVE_ARGS) -> dict:
    """Main path, part 10: whisper's serve protocol, the reference's
    (``generate`` refuses an encdec): ``launch.steps.build_prefill_step`` and
    ``prefill_cross`` over a seeded ``audio_embed`` for a batch of 4, then
    the decode loop through ``build_serve_step``'s step: a 64-token prompt
    and 32 greedy tokens, with the train phase's weights (the same seed),
    the whole model. The prefill's logits must equal ``dec_logits``' last
    position (within a bf16 ulp, ``PREFILL_TOL``). On the leading
    ``ENCDEC_CHECK_LAYERS`` layers of each stack (the same weights), the f32
    decode logits at every prompt position must lie within ``F32_TOL`` of
    the forward's on the same encoder output, and the card's f32 ``encode``
    + ``dec_logits`` of one sequence within ``F32_TOL`` of the port's own
    f32 forward on the CPU. At the whole depth, and in bf16, decode against
    forward is measured, not bounded, beside the forward's own sensitivity
    to summation order (``batch_sensitivity``): the model amplifies
    rounding ~3x a layer (``ENCDEC_CHECK_LAYERS``)."""
    from repro_torch.launch import serve
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.launch.train import with_layers
    from repro_torch.optim.adamw import tree_map

    model = smoke_model(args)
    cfg = model.cfg
    params = model.init_params(seed, device)
    B = SERVE_BATCH
    prompts = serve.prompts_for(seed, B, SERVE_PROMPT, cfg.vocab, device)
    audio = seeded_embeddings(seed + 13, B, cfg.enc_positions, model, device)
    prefill = build_prefill_step(model).fn
    step = build_serve_step(model).fn

    def decode(gen):
        """The serve loop over the prompt and ``gen`` greedy tokens: the
        tokens and the loop's seconds (``prefill_cross`` before it)."""
        cache = model.prefill_cross(params, model.init_cache(B, SERVE_PROMPT + gen,
                                                             device=device), audio)
        sync(device)
        t0 = time.perf_counter()
        tok, pos, out = prompts[:, :1], torch.zeros(B, dtype=torch.int32, device=device), []
        for t in range(SERVE_PROMPT + gen - 1):
            tok, cache, pos = step(params, cache, tok, pos)
            if t + 1 < SERVE_PROMPT:
                tok = prompts[:, t + 1:t + 2]
            out.append(tok)
        seqs = torch.cat([prompts[:, :1]] + out, dim=1)
        sync(device)
        return seqs, time.perf_counter() - t0

    batch = {"tokens": prompts, "audio_embed": audio}
    prefill(params, batch)                                     # warm-up
    decode(2)
    sync(device)
    t0 = time.perf_counter()
    last = prefill(params, batch)
    sync(device)
    prefill_s = time.perf_counter() - t0
    seqs, wall = decode(SERVE_GEN)
    steps = SERVE_PROMPT + SERVE_GEN - 1
    check(seqs.shape == (B, SERVE_PROMPT + SERVE_GEN) and bool((seqs >= 0).all())
          and bool((seqs < cfg.vocab).all())
          and torch.equal(seqs[:, :SERVE_PROMPT], prompts),
          f"the serve loop generated ({B}, {SERVE_PROMPT + SERVE_GEN}) tokens after the prompt")
    with torch.no_grad():
        full = model.dec_logits(params, prompts, model.encode(params, audio))[:, -1:].float()
    prefill_err = float((last.float() - full).abs().max())
    check(prefill_err <= PREFILL_TOL * float(full.abs().max()),
          f"the prefill step's logits equal dec_logits' last position: {prefill_err:.4g}")
    out = {"arch": _arg(args, "--arch"), "layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers,
           "batch": B, "prompt": SERVE_PROMPT, "generated": SERVE_GEN, "decode_steps": steps,
           "seconds": wall, "ms_per_decode_step": wall / steps * 1e3,
           "tokens_per_s": B * steps / wall, "generated_tokens_per_s": B * SERVE_GEN / wall,
           "prefill_ms": prefill_s * 1e3, "prefill_max_abs_err": prefill_err,
           "prefill_scale": float(full.abs().max()), "prefill_tolerance": PREFILL_TOL,
           "check_layers": ENCDEC_CHECK_LAYERS}

    def forward(m, p, tok, aud):
        return m.dec_logits(p, tok, m.encode(p, aud))

    def leading(tree, n):
        return {**tree, "enc": tree_map(lambda t: t[:n], tree["enc"]),
                "dec": tree_map(lambda t: t[:n], tree["dec"])}

    def measure(name, res):
        out.update({f"{name}_{k}": v for k, v in res.items()})
        out[f"{name}_tolerance"] = "measured, not bounded"

    n = ENCDEC_CHECK_LAYERS
    measure("decode_vs_forward", decode_vs_forward(model, params, prompts, device, audio))
    cut, cut_params = with_layers(model, n), leading(params, n)
    measure("cut_decode_vs_forward", decode_vs_forward(cut, cut_params, prompts, device, audio))
    f32_model, audio32 = smoke_model_like(model, torch.float32), audio.float()
    params32 = tree_map(lambda t: t.float(), params)
    del params, cut_params
    measure("f32_decode_vs_forward",
            decode_vs_forward(f32_model, params32, prompts, device, audio32))
    out["f32_batch_sensitivity"] = batch_sensitivity(f32_model, params32, forward, prompts,
                                                     audio32)
    cut32, cut_params32 = with_layers(f32_model, n), leading(params32, n)
    del params32
    out["cut_f32_batch_sensitivity"] = batch_sensitivity(cut32, cut_params32, forward, prompts,
                                                         audio32)
    hold_to(out, "cut_f32_decode_vs_forward",
            decode_vs_forward(cut32, cut_params32, prompts, device, audio32), F32_TOL)
    tokens = serve.prompts_for(seed + 11, 1, SERVE_FORWARD_TOKENS, cfg.vocab, device)
    hold_to(out, "cut_f32_card_vs_cpu",
            cpu_forward_check(cut32, cut_params32, forward, tokens, audio32[:1]), F32_TOL)
    return out


def vlm_prefill_path(seed: int, device, args=VLM_SERVE_ARGS) -> dict:
    """Main path, part 11: the vlm's prefill step (``build_prefill_step``) over
    a seeded ``vis_embed`` of 256 patch embeddings and 128 tokens for a batch
    of 4: its logits must equal ``logits_mm``' last position (within a bf16
    ulp, ``PREFILL_TOL``), and the card's f32 ``logits_mm`` of one sequence
    the port's own f32 one on the CPU (``F32_TOL``)."""
    from repro_torch.launch import serve
    from repro_torch.launch.steps import build_prefill_step

    model = smoke_model(args)
    cfg = model.cfg
    params = model.init_params(seed, device)
    B = SERVE_BATCH
    tokens = serve.prompts_for(seed + 11, B, SERVE_FORWARD_TOKENS, cfg.vocab, device)
    vis = seeded_embeddings(seed + 17, B, cfg.n_vis_tokens, model, device)
    prefill = build_prefill_step(model).fn
    batch = {"tokens": tokens, "vis_embed": vis}
    prefill(params, batch)                                    # warm-up
    sync(device)
    t0 = time.perf_counter()
    last = prefill(params, batch)
    sync(device)
    prefill_s = time.perf_counter() - t0
    with torch.no_grad():
        full = model.logits_mm(params, tokens, vis)[:, -1:].float()
    err = float((last.float() - full).abs().max())
    check(err <= PREFILL_TOL * float(full.abs().max()),
          f"the vlm prefill step's logits equal logits_mm's last position: {err:.4g}")
    out = {"arch": _arg(args, "--arch"), "layers": cfg.n_layers, "batch": B,
           "vis_tokens": cfg.n_vis_tokens, "text_tokens": SERVE_FORWARD_TOKENS,
           "prefill_ms": prefill_s * 1e3, "prefill_max_abs_err": err,
           "prefill_scale": float(full.abs().max()), "prefill_tolerance": PREFILL_TOL}

    def forward(m, p, tok, v):
        return m.logits_mm(p, tok, v)

    hold_to(out, "f32_card_vs_cpu",
            cpu_forward_check(model, params, forward, tokens[:1], vis[:1]), F32_TOL)
    return out


def long_cache(model, T: int, start: int, seed: int, dev, tile: int, mesh=None,
               specs=None) -> dict:
    """A dense LM's decode cache of ``T`` positions at batch 1 that holds
    positions 0 .. ``start`` - 1 (each slot the newest of them it would
    hold, -1 where none), its keys and values standard normal draws of one
    generator per (leaf, layer, ``tile`` slots). Under ``specs`` (over
    ``mesh``) this rank's blocks, drawing only the tiles it holds: every
    cut holds the same whole cache."""
    import zlib

    from repro_torch.distributed.mesh import P, shard

    cfg, nb = model.cfg, model.n_blocks
    cache = {}
    for i, kind in enumerate(model.pattern):
        Ti = model.cache_len(kind, T)
        slots = torch.arange(Ti)
        if specs is not None:
            slots = shard(mesh, slots, P(specs[f"p{i}"][2]))
        lo, n = int(slots[0]), slots.numel()
        check(lo % tile == 0 and n % tile == 0,
              f"a block of {n} slots from {lo} is whole tiles of {tile}")
        s = slots.to(dev)
        newest = s + Ti * torch.div(start - 1 - s, Ti, rounding_mode="floor")
        cache[f"p{i}"] = torch.where(newest >= 0, newest, -1).to(torch.int32) \
            .expand(nb, 1, n).contiguous()
        for leaf in ("k", "v"):
            t = torch.empty((nb, 1, n, cfg.n_kv_heads, cfg.hd), dtype=cfg.dtype, device=dev)
            for b in range(nb):
                for a in range(lo, lo + n, tile):
                    gen = torch.Generator(device=dev)
                    gen.manual_seed(zlib.crc32(f"{seed}/{leaf}{i}/{b}/{a}".encode()))
                    t[b, 0, a - lo:a - lo + tile] = torch.randn(
                        (tile, cfg.n_kv_heads, cfg.hd), generator=gen, device=dev)
            cache[f"{leaf}{i}"] = t
    return cache


def long_decode(model, params, cache, tokens, start: int, specs=None):
    """(each step's logits (1, S, V) in f32, the cache) of decoding
    ``tokens`` (1, S) token by token from position ``start`` (teacher
    forced), over this rank's blocks of ``cache`` under ``specs``."""
    kw = {} if specs is None else {"cache_specs": specs}
    out = []
    with torch.no_grad():
        for t in range(tokens.shape[1]):
            pos = torch.full((1,), start + t, dtype=torch.int32, device=tokens.device)
            lg, cache = model.decode_step(params, cache, tokens[:, t:t + 1], pos, **kw)
            out.append(lg.float())
    return torch.cat(out, dim=1), cache


def long_written(model, cache, T: int, start: int, steps: int, mesh=None, specs=None) -> int:
    """The slots of this rank's blocks of the position caches that hold one
    of the decoded positions ``start`` .. ``start + steps - 1``, each at
    its own slot (pos % the cache's length)."""
    from repro_torch.distributed.mesh import P, shard

    n = 0
    for i, kind in enumerate(model.pattern):
        Ti = model.cache_len(kind, T)
        slots = torch.arange(Ti)
        if specs is not None:
            slots = shard(mesh, slots, P(specs[f"p{i}"][2]))
        p = cache[f"p{i}"].cpu()
        hit = (p >= start) & (p < start + steps)
        check(bool((p[hit] % Ti == slots.expand_as(p)[hit]).all()),
              f"serve_long: every decoded position of p{i} at its own slot")
        n += int(hit.sum())
    return n


def serve_long_path(seed: int, device) -> dict:
    """Main path, part 12: gemma2-2b (``LONG_ARGS``) at full width and
    depth, bf16, at batch 1 over a cache of the long_500k cell's
    ``LONG_T`` positions (``long_cache``), ``LONG_STEPS`` teacher-forced
    tokens decoded from ``LONG_START`` after a two-token warm-up: ms a
    decode step, cache and peak bytes. Checked: finite logits of the
    vocab's width, every decoded position written at its slot of every
    layer's cache."""
    from repro_torch.launch import serve

    model = smoke_model(LONG_ARGS)
    reset_peak(device)
    params = model.init_params(seed, device)
    t0 = time.perf_counter()
    cache = long_cache(model, LONG_T, LONG_START, seed, device, LONG_TILE)
    sync(device)
    fill_s = time.perf_counter() - t0
    tokens = serve.prompts_for(seed + 7, 1, LONG_STEPS, model.cfg.vocab, device)
    long_decode(model, params, cache, tokens[:, :2], LONG_START)     # rewrites its two slots
    sync(device)
    t0 = time.perf_counter()
    logits, cache = long_decode(model, params, cache, tokens, LONG_START)
    sync(device)
    ms = 1e3 * (time.perf_counter() - t0) / LONG_STEPS
    check(tuple(logits.shape) == (1, LONG_STEPS, model.cfg.vocab)
          and bool(torch.isfinite(logits).all()), "serve_long: finite logits of the vocab's width")
    written = long_written(model, cache, LONG_T, LONG_START, LONG_STEPS)
    check(written == LONG_STEPS * model.cfg.n_layers,
          f"serve_long: {LONG_STEPS} positions written in each of {model.cfg.n_layers} layers "
          f"({written})")
    out = {"arch": _arg(LONG_ARGS, "--arch"), "layers": model.cfg.n_layers, "batch": 1,
           "positions": LONG_T, "start": LONG_START, "steps": LONG_STEPS,
           "ms_per_decode_step": ms, "cache_fill_s": fill_s,
           "cache_bytes": sum(t.numel() * t.element_size() for t in cache.values()),
           "param_bytes": sum(t.numel() * t.element_size() for t in
                              flat_tree(params).values()),
           "peak_bytes": peak_bytes(device), "max_logit": float(logits.abs().max())}
    del params, cache, logits
    torch.cuda.empty_cache()
    return out


def remat_path(seed: int, device) -> dict:
    """Main path, part 13: ``REMAT_STEPS`` train steps of ``TRAIN_ARGS``'
    model (gemma-2b at full width, 2 layers, its sequence length and batch)
    under ``remat`` "none", "full" and "dots", from the same seeded weights
    and batches: step ms, losses and the card's peak bytes of each, then
    the peak bytes of one forward and backward alone (the AdamW update's
    temporaries, the same under every policy, set the step's peak where the
    activations are fewer). Checked: the losses of "dots" within
    ``LOSS_RTOL`` of "full"'s (whether bit-equal is recorded) and the
    forward and backward's peak under "dots" above "full"'s and below
    "none"'s."""
    import dataclasses

    from repro_torch.configs.registry import ShapeCell
    from repro_torch.launch.steps import _value_and_grad, build_train_step
    from repro_torch.launch.train import rebuild
    from repro_torch.optim import adamw

    base = smoke_model(TRAIN_ARGS)
    seq, B = int(_arg(TRAIN_ARGS, "--seq-len")), int(_arg(TRAIN_ARGS, "--global-batch"))
    gen = torch.Generator(device=device).manual_seed(seed + 11)
    batches = [{"tokens": torch.randint(0, base.cfg.vocab, (B, seq + 1), generator=gen,
                                        device=device, dtype=torch.int32)}
               for _ in range(REMAT_STEPS)]
    ocfg = adamw.AdamWConfig(lr=float(_arg(TRAIN_ARGS, "--lr")))
    out = {"arch": base.cfg.name, "layers": base.cfg.n_layers, "seq": seq, "batch": B}
    for remat in ("none", "full", "dots"):
        model = rebuild(base, dataclasses.replace(base.cfg, remat=remat))
        step = build_train_step(model, None, ocfg, cell=ShapeCell("remat", seq, B, "train")).fn
        reset_peak(device)
        params = model.init_params(seed, device)
        opt = adamw.init(params, ocfg)
        losses, ms = [], []
        for batch in batches:
            sync(device)
            t0 = time.perf_counter()
            params, opt, stats = step(params, opt, batch)
            losses.append(float(stats["loss"]))
            ms.append(1e3 * (time.perf_counter() - t0))
        out[remat] = {"losses": losses, "step_ms": ms, "peak_bytes": peak_bytes(device)}
        reset_peak(device)
        grads = _value_and_grad(model, params, batches[0])[1]
        out[remat]["grad_peak_bytes"] = peak_bytes(device)
        del params, opt, stats, grads
        torch.cuda.empty_cache()
    dots, full, none = out["dots"], out["full"], out["none"]
    for i, (d, f) in enumerate(zip(dots["losses"], full["losses"])):
        check(abs(d - f) <= LOSS_RTOL * abs(f),
              f"remat: step {i + 1}'s loss under dots within {LOSS_RTOL} of full's ({d} vs {f})")
    out["dots_losses_bit_equal_full"] = dots["losses"] == full["losses"]
    check(torch.device(device).type != "cuda"         # the host counts no peak
          or full["grad_peak_bytes"] < dots["grad_peak_bytes"] < none["grad_peak_bytes"],
          f"remat: the forward and backward's peak under dots between full's and none's "
          f"({dots['grad_peak_bytes']} of {full['grad_peak_bytes']} .. "
          f"{none['grad_peak_bytes']})")
    return out


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


def dryrun_cells():
    """Part (a) of the dry-run phase: (name, arch, depths, build(depth, batch)
    -> StepBundle, batch) for each cell the card checks, at full width."""
    from repro_torch.configs.registry import SHAPES, ShapeCell, build_model
    from repro_torch.launch.steps import (_with_layers, build_cell, build_prefill_step,
                                          build_train_step)

    def cut(arch, n):
        return _with_layers(build_model(arch), n)

    def train(n, batch):
        return build_train_step(cut("gemma-2b", n), cell=ShapeCell(
            "train_smoke", DRYRUN_TRAIN_SEQ, batch, "train"))

    def prefill(n, batch):
        cell = SHAPES["prefill_32k"]
        return build_prefill_step(cut("mamba2-370m", n), cell=ShapeCell(
            cell.name, cell.seq_len, batch, cell.kind))

    return [
        ("train", "gemma-2b", [1, 2], train, DRYRUN_TRAIN_BATCH),
        ("decode", "qwen3-moe-30b-a3b", [1, 2],
         lambda n, _b: build_cell("qwen3-moe-30b-a3b", "decode_32k", layers_override=n),
         SHAPES["decode_32k"].global_batch),
        ("prefill", "mamba2-370m", [1, 2], prefill, DRYRUN_PREFILL_BATCH),
        ("long", "recurrentgemma-2b", [3, 6, 8],
         lambda n, _b: build_cell("recurrentgemma-2b", "long_500k", layers_override=n),
         SHAPES["long_500k"].global_batch),
    ]


def dryrun_path(device, reset, counts) -> dict:
    """Main path, part 14: the dry run (``launch.dryrun``). (a) On each cell
    of ``dryrun_cells``, at each depth, in this process: the walk on fake
    tensors against ``measure`` on the card — FLOPs and argument bytes
    equal, the walk's peak within ``DRYRUN_PEAK_REL`` of the card's; the
    prefill cell's batch is halved until its walk's peak is under
    ``DRYRUN_PREFILL_MAX_BYTES``. (b) ``dryrun.main`` over ``DRYRUN_FULL``
    (one cell a family, full depth, the registry's batch, ``--mesh one
    --no-probes``): no cell may fail. (c) ``dryrun.main --mesh both
    --no-probes`` over ``DRYRUN_MESH`` on fake card tensors, then on fake
    host tensors: no cell may fail, each records collectives, and the two
    devices' FLOPs, argument and output bytes and collectives are equal;
    no process group is left after them."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    reset()
    out: dict = {"checked": [], "full": {}}
    for name, arch, depths, build, batch in dryrun_cells():
        if name == "prefill":
            while dryrun.walk(build(max(depths), batch), device)["peak_bytes"] \
                    >= DRYRUN_PREFILL_MAX_BYTES:
                batch //= 2
                print(f"dryrun: {arch} prefill_32k cut to batch {batch} "
                      f"(walk's peak at {max(depths)} layers over "
                      f"{DRYRUN_PREFILL_MAX_BYTES / 1e9:.0f} GB)")
        for n in depths:
            bundle = build(n, batch)
            walked = dryrun.walk(bundle, device)
            torch.cuda.empty_cache()
            card = dryrun.measure(bundle, device)
            del bundle
            torch.cuda.empty_cache()
            row = {"cell": name, "arch": arch, "layers": n, "batch": batch,
                   "walk": walked, "card": card, "step_ms": card["step_ms"],
                   "flop_share": card["flops_per_device"] / (card["step_ms"] * 1e-3)
                   / BF16_PEAK_FLOPS,
                   "peak_rel_err": walked["peak_bytes"] / card["peak_bytes"] - 1}
            out["checked"].append(row)
            what = f"dryrun {name} {arch} at {n} layers"
            check(walked["flops_per_device"] == card["flops_per_device"],
                  f"{what}: walk FLOPs {walked['flops_per_device']} == card "
                  f"{card['flops_per_device']}")
            check(walked["argument_bytes"] == card["argument_bytes"],
                  f"{what}: walk argument bytes {walked['argument_bytes']} == card "
                  f"{card['argument_bytes']}")
            check(abs(row["peak_rel_err"]) <= DRYRUN_PEAK_REL,
                  f"{what}: walk peak {walked['peak_bytes']} within "
                  f"{DRYRUN_PEAK_REL:.0%} of the card's {card['peak_bytes']}")
    out["checked_s"] = time.perf_counter() - t0

    t1 = time.perf_counter()
    path = os.path.join(tempfile.mkdtemp(prefix="chip-smoke-dryrun-"), "dryrun.json")
    for arch, shape in DRYRUN_FULL:
        one = dryrun.main(["--arch", arch, "--shape", shape, "--mesh", "one", "--no-probes",
                           "--device", "cuda", "--out", path])
    for arch, shape in DRYRUN_FULL:
        rec = one[f"{arch}|{shape}|one|auto|mb0"]
        check("error" not in rec, f"dryrun {arch} {shape} walked: {rec.get('error')}")
        out["full"][f"{arch}|{shape}"] = {k: rec[k] for k in (
            "flops_per_device", "bytes_accessed", "argument_bytes", "output_bytes",
            "temp_bytes", "peak_bytes", "walk_s", "microbatches")}
    out["full_s"] = time.perf_counter() - t1

    t2 = time.perf_counter()
    recs = {}
    for dev in ("cuda", "cpu"):
        dev_path = os.path.join(os.path.dirname(path), f"dryrun_mesh_{dev}.json")
        for arch, shape in DRYRUN_MESH:
            recs[dev] = dryrun.main(["--arch", arch, "--shape", shape, "--mesh", "both",
                                     "--no-probes", "--device", dev, "--out", dev_path])
    check(not dist.is_initialized(), "no world is left after the production walks")
    out["mesh"] = {}
    for arch, shape in DRYRUN_MESH:
        for mk in ("single", "multi"):
            key = f"{arch}|{shape}|{mk}|auto|mb0"
            card, host = recs["cuda"][key], recs["cpu"][key]
            what = f"dryrun mesh {arch} {shape} {mk}"
            check("error" not in card and "error" not in host,
                  f"{what} walked: {card.get('error')} / {host.get('error')}")
            check(card["collectives"]["n_ops"] > 0, f"{what} recorded collectives")
            for k in ("flops_per_device", "argument_bytes", "output_bytes", "collectives"):
                check(card[k] == host[k], f"{what}: {k} on the card {card[k]} == host {host[k]}")
            out["mesh"][f"{arch}|{shape}|{mk}"] = {
                **{k: card[k] for k in ("devices", "flops_per_device", "argument_bytes",
                                        "output_bytes", "temp_bytes", "peak_bytes",
                                        "collectives", "microbatches")},
                "walk_s": card["walk_s"], "host_walk_s": host["walk_s"]}
    out["mesh_s"] = time.perf_counter() - t2
    torch.cuda.synchronize(device)
    out["launches"] = counts()
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# the four-card phase: the chunked collectives and the chunked gradient sync
# ---------------------------------------------------------------------------
COLL_CARDS = 4                   # one rank a card, NCCL over the four
COLL_BYTES = 256 * MiB           # a rank's tensor in each collective
COLL_ROWS = 4096                 # rows of a gathered / all-reduced shard
COLL_CHUNKS = (1, 4, 16)         # n_chunks timed; default_n_chunks(256 MiB) is 4
COLL_ITERS = 20
# mistral-nemo-12b's up-projection (src/repro/configs/mistral_nemo_12b.py:10): K 5120,
# N 14336, 4096 tokens, bf16; the weight's K rows sharded over the four ranks
AGMM_TOKENS, AGMM_K, AGMM_N = 4096, 5120, 14336
# gemma-2b at full width, 2 layers, 4 sequences a card (global batch 16) on a 2x2x1 mesh
TRAIN_DIST_ARGS = ["--arch", "gemma-2b", "--layers", "2", "--seq-len", "2048",
                   "--global-batch", "16", "--lr", "3e-3", "--log-every", "1"]
TRAIN_DIST_MESH, ELASTIC_MESH = "2x2x1", "1x2x1"
TRAIN_DIST_STEPS, TRAIN_DIST_CKPT = 6, 4
ONE_CARD_MICROBATCHES = 4        # the one-card step 1 over the same 16 sequences
ELASTIC_MICROBATCHES = 2         # 8 sequences a card on two ranks, 4 at a time
RANKS_TIMEOUT_S = 600            # a world of ranks that runs longer fails the phase
MODEL_AXIS_TIMEOUT_S = 300       # each world of the model-axis part
# every other family over pod x data (model 1): one cut each at full width, 4 sequences a
# card on 2x2x1, each held at step 1 to one card on the same 16 (ONE_CARD_MICROBATCHES)
FAMILY_DIST_RUNS = [["--arch", "qwen3-moe-30b-a3b", "--layers", "2", "--seq-len", "2048"],
                    ["--arch", "mamba2-370m", "--layers", "8", "--seq-len", "2048"],
                    ["--arch", "recurrentgemma-2b", "--layers", "3", "--seq-len", "2048"],
                    ["--arch", "whisper-large-v3", "--layers", "1", "--seq-len", "448"],
                    ["--arch", "internvl2-2b", "--layers", "2", "--seq-len", "2048"]]
FAMILY_DIST_COMMON = ["--global-batch", "16", "--lr", "3e-3", "--log-every", "0"]
FAMILY_DIST_STEPS = 3
# the model axis: gemma-2b (TRAIN_DIST_ARGS) over pod x data x model, the same 16
# sequences a step as on 2x2x1; the checkpoint's root resumed on two ranks
TP_MESHES, TP_CKPT_MESH, TP_VLM_MESH, TP_ELASTIC_MESH = ("1x2x2", "1x1x4"), "1x2x2", "1x1x4", "1x1x2"
TP_F32_LAYERS, TP_F32_TOKENS = 1, 128   # the f32 forward against one card's
TP_F32_TOL = 2e-5      # of the largest logit (model axis); of the largest |h| @ |W| (expert axis)
VLM_TP_ARGS = ["--arch", "internvl2-2b", "--layers", "2", "--seq-len", "2048",
               "--global-batch", "4", "--lr", "3e-3", "--log-every", "0"]
VLM_TP_STEPS = 3
# the expert axis: qwen3-moe-30b-a3b at full width, 1 of 48 layers (cut from 2 to keep the
# whole four-card phase inside its time), the same 16 sequences a step, on 1x2x2 (64 experts
# a card) and 1x1x4 (32 a card); its checkpoint
# saved on 1x2x2, resumed there and on two ranks (1x1x2, 8 sequences at a time, so each
# column routes the rows it routed on 1x2x2); grok-1-314b at 1 of 64 layers on 1x1x4 (2
# of its 8 experts a card), which one card cannot train
EP_ARGS = ["--arch", "qwen3-moe-30b-a3b", "--layers", "1", "--seq-len", "2048",
           "--global-batch", "16", "--lr", "3e-3", "--log-every", "0"]
EP_MESHES, EP_CKPT_MESH, EP_ELASTIC_MESH = ("1x2x2", "1x1x4"), "1x2x2", "1x1x2"
EP_STEPS, EP_CKPT = 6, 4
EP_ELASTIC_MICROBATCHES = 2
GROK_EP_ARGS = ["--arch", "grok-1-314b", "--layers", "1", "--seq-len", "2048",
                "--global-batch", "16", "--lr", "3e-3", "--log-every", "0"]
GROK_EP_MESH, GROK_EP_STEPS = "1x1x4", 3
GROK_PEAK_MAX = 70e9             # bytes a card: over it the grok run halves its batch
EXPERT_AXIS_TIMEOUT_S = 480      # each world of the expert-axis part
# the model axis of the ssm, hybrid and encdec families: FAMILY_DIST_RUNS' cuts at full
# width, the same 16 sequences a step, each mesh one world that trains the three in turn;
# recurrentgemma-2b's checkpoint (the most leaves cut, wa and wxg among them) saved by rank
# 0 at step 2 from 1x2x2, resumed there and on 1x1x2
FAMILY_TP_ARCHS = ("mamba2-370m", "recurrentgemma-2b", "whisper-large-v3")
FAMILY_TP_MESHES, FAMILY_TP_CKPT_MESH, FAMILY_TP_ELASTIC_MESH = ("1x2x2", "1x1x4"), "1x2x2", "1x1x2"
FAMILY_TP_CKPT_ARCH, FAMILY_TP_STEPS, FAMILY_TP_CKPT = "recurrentgemma-2b", 3, 2
FAMILY_TP_TIMEOUT_S = 480        # each world of the family part
# whisper's init amplifies rounding ~3x a layer (ROADMAP Queue 3 item 3): its f32 forward at
# 1+1 layers is held to serve_encdec's f32 bound at that depth (ENCDEC_CHECK_LAYERS)
ENCDEC_TP_F32_TOL = F32_TOL


# ZeRO-3 over data: gemma-2b (TRAIN_DIST_ARGS) on 1x4x1, 6 steps, its root saved at step 4
# resumed there and on 1x2x1 (the same sequences a pass as on the saving mesh); ZeRO on
# 2x2x1 and 1x2x2 runs in the train_dist and model-axis parts (the same worlds this part
# ran there until the serving parts needed its time); then mistral-nemo-12b at its full 40
# layers on 1x4x1, whose training state (147 GB whole) fits only cut over the four cards: 3
# steps of 16 sequences, 4 a card a pass, halved while the steps' peak passes ZERO_PEAK_MAX
ZERO_MESHES = ("1x4x1",)
ZERO_ELASTIC = {"1x4x1": ("1x2x1", ELASTIC_MICROBATCHES)}
ZERO_NEMO_ARGS = ["--arch", "mistral-nemo-12b", "--seq-len", "2048", "--global-batch", "16",
                  "--lr", "3e-3", "--log-every", "0"]
ZERO_NEMO_MESH, ZERO_NEMO_STEPS = "1x4x1", 3
# its step 1 held to one card's: the loss of the same weights and sequences under no_grad, in
# ONE_CARD_MICROBATCHES passes, and the gradient's norm where that pass fits the card under
# ZERO_PEAK_MAX without AdamW's state (tried with the allocator held to that bound)
# the deepest cut whose whole train step fits one card under ZERO_PEAK_MAX with the caching
# allocator's reserve counted (bf16 params and gradients, AdamW's f32 moments, the f32 sum of
# four microbatches' gradients and its temporaries: 6.0 GB a layer allocated on an H100; GB
# allocated / reserved 60.0 / 70.5 at 4 layers, 2.43 B params, 66.0 / 77.7 at 5, 72.0 / 83.4
# at 6, which once ran out of the card: tools/nemo_cut_peaks.py), 3 steps on 1x4x1 in
# gemma-2b's world and on one card from the same weights and sequences
ZERO_NEMO_CUT_ARGS = ZERO_NEMO_ARGS + ["--layers", "4"]
ZERO_NEMO_CUT_STEPS = 3
ZERO_PEAK_MAX = 75e9             # bytes a card: over it the steps run in more passes
CARD_BYTES = 80e9                # an H100's memory: every peak below it
ZERO_TIMEOUT_S = 480             # each world of the ZeRO part

# serving over the model axis: gemma-2b (SERVE_ARGS) from a params-only root, each
# (mesh, weight-stationary) run in one world of four: the train specs on 1x1x4, the serve
# specs on 1x2x2 (the serve specs on 1x1x4 left out to keep the whole four-card phase
# inside its time with serve_families beside it)
SERVE_TP_RUNS = (("1x1x4", False), ("1x2x2", True))
SERVE_TP_TIMEOUT_S = 600
# in the same world, gemma2-2b (LONG_ARGS) at batch 1 over the long_500k cache (long_cache), its
# time cut over model and data (1x2x2) or model and pod (2x1x2), under the serve specs: in f32 at
# 1 global layer and at 2 (local, global) against rank 0's one card, then at all 26 layers in bf16
# on LONG_DEEP_MESH
LONG_TP_MESHES = ("1x2x2", "2x1x2")
LONG_DEEP_MESH = "1x2x2"

# serving over the model axis for the moe, ssm, hybrid and encdec families, each at full width
# at the depth the four-card train parts use, from a params-only root, under its train specs
# (the reference serves them with those): one world of four serves them in turn on 1x1x4,
# qwen3-moe also on 1x2x2 (its experts over two columns, the batch over data, the weights
# gathered over data a layer at a time); SERVE_BATCH sequences, SERVE_PROMPT + SERVE_GEN
# (args, meshes at SERVE_BATCH, meshes at batch 1): at batch 1 the cache's time is cut over model
# and data (the ssm's state and conv window stay whole in the batch), SERVE_B1_PROMPT +
# SERVE_B1_GEN tokens
SERVE_FAMILY_RUNS = ((["--arch", "qwen3-moe-30b-a3b", "--layers", "2"], ("1x1x4", "1x2x2"), ()),
                     (["--arch", "mamba2-370m", "--layers", "8"], ("1x1x4",), ("1x2x2",)),
                     (["--arch", "recurrentgemma-2b", "--layers", "3"], ("1x1x4",), ("1x2x2",)),
                     (["--arch", "whisper-large-v3", "--layers", "1"], ("1x1x4",), ("1x2x2",)))
SERVE_B1_PROMPT, SERVE_B1_GEN = 8, 8
SERVE_FAMILIES_TIMEOUT_S = 900


def launch_counters():
    """(reset, counts) of the kernels' launch counters: ``counts()`` maps each
    kernel wrapper to its launches since the last ``reset()``."""
    from repro_torch.kernels import checksum as ck
    from repro_torch.kernels import matmul_digest as mm

    def reset() -> None:
        ck.reset_launch_counts()
        mm.reset_launch_counts()

    def counts() -> dict:
        return {**ck.launch_counts(), **mm.launch_counts()}

    return reset, counts


def unit_roundoff(dtype) -> float:
    return 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -24


def world_ms(fn, device, iters: int = COLL_ITERS) -> float:
    """Mean milliseconds a call of a collective on this rank, after one warm
    call and a barrier: CUDA events on the card, the host clock on the CPU
    (a rehearsal, never printed as a card's number)."""
    import torch.distributed as dist

    fn()
    sync(device)
    dist.barrier()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rank_inputs(cfg: dict, tag: int, shape, dtype, device, rank: int) -> torch.Tensor:
    """Rank ``rank``'s seeded input: any rank can draw any other's."""
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg["seed"] * 1_000_003 + tag * 101 + rank)
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def collectives_worker(cfg: dict) -> dict:
    """One rank of the collectives' world: every chunked collective of
    ``repro_torch.distributed.chunked`` against NCCL's monolithic one on
    ``COLL_BYTES`` a rank, in f32 and bf16, at each of ``COLL_CHUNKS``;
    then ``ag_matmul`` and ``matmul_rs`` at mistral-nemo-12b's
    up-projection. Gathers must be byte-equal; reductions within
    (A-1)·u·Σ|x| of the float64 sum (u the dtype's unit roundoff); the
    matmuls within (K·2^-24 + (2A-1)·2^-8)·(|x|@|w|) of the float64 product
    (f32 accumulation, then bf16 rounding of the A block products and the
    A-1 running sums). Times by CUDA events, chunked against monolithic."""
    import torch.distributed as dist

    from repro_torch.distributed import chunked as C
    from repro_torch.distributed.mesh import DATA, make_mesh

    device = cfg["device"]
    mesh = make_mesh((COLL_CARDS,), (DATA,), device=device)
    dev, g, A = mesh.device, mesh.group(DATA), COLL_CARDS
    me = dist.get_rank(g)
    out = {"rank": dist.get_rank(), "device": str(dev), "rows": [], "matmuls": []}
    for tag, dtype in enumerate((torch.float32, torch.bfloat16)):
        u, cols = unit_roundoff(dtype), cfg["bytes"] // (cfg["rows"] * dtype.itemsize)
        name = str(dtype).replace("torch.", "")
        for k, kind in enumerate(("all_gather", "reduce_scatter", "all_reduce")):
            rows = cfg["rows"] // A if kind == "reduce_scatter" else cfg["rows"]
            shape = (rows * (A if kind == "reduce_scatter" else 1), cols)
            xs = [rank_inputs(cfg, 3 * tag + k, shape, dtype, dev, r) for r in range(A)]
            x = xs[me]
            if kind == "all_gather":
                want = x.new_empty((A * shape[0], cols))
                mono = lambda: dist.all_gather_into_tensor(want, x, group=g)     # noqa: E731
                mono()
                size, factor = want.numel() * dtype.itemsize, (A - 1) / A
            else:
                tot = sum(t.double() for t in xs)
                mag = sum(t.double().abs() for t in xs)
                if kind == "reduce_scatter":
                    tot, mag = tot[me * rows:(me + 1) * rows], mag[me * rows:(me + 1) * rows]
                    want = x.new_empty((rows, cols))
                    mono = lambda: dist.reduce_scatter_tensor(want, x, group=g)  # noqa: E731
                    mono()
                    factor = (A - 1) / A
                else:
                    want = x.clone()
                    dist.all_reduce(want, group=g)
                    scratch = x.clone()
                    mono = lambda: dist.all_reduce(scratch, group=g)             # noqa: E731
                    factor = 2 * (A - 1) / A
                size = x.numel() * dtype.itemsize
                limit = (A - 1) * u * mag
            nccl_ms = world_ms(mono, dev)
            for nc in cfg["chunks"]:
                fn = {"all_gather": C.chunked_all_gather, "reduce_scatter": C.chunked_reduce_scatter,
                      "all_reduce": C.chunked_all_reduce}[kind]
                got = fn(x, g, n_chunks=nc)
                row = {"collective": kind, "dtype": name, "n_chunks": nc, "bytes": size,
                       "rank_bytes": x.numel() * dtype.itemsize,
                       "default_n_chunks": C.default_n_chunks(x.numel() * dtype.itemsize)}
                if kind == "all_gather":
                    row["byte_equal"] = bool(torch.equal(got.view(torch.uint8),
                                                         want.view(torch.uint8)))
                else:
                    err = (got.double() - tot).abs()
                    row.update(max_abs_err=float(err.max()),
                               within_bound=bool((err <= limit).all()),
                               nccl_max_abs_err=float((want.double() - tot).abs().max()),
                               nccl_within_bound=bool(((want.double() - tot).abs()
                                                       <= limit).all()))
                del got
                ms = world_ms(lambda: fn(x, g, n_chunks=nc), dev)
                row.update(ms=ms, nccl_ms=nccl_ms, algbw_GBps=size / ms / 1e6,
                           busbw_GBps=size / ms / 1e6 * factor,
                           nccl_algbw_GBps=size / nccl_ms / 1e6,
                           nccl_busbw_GBps=size / nccl_ms / 1e6 * factor)
                out["rows"].append(row)
            del xs, x, want
            sync(dev)
    # the collective matmuls, bf16, at the up-projection
    T, K, N = cfg["agmm"]
    bf = torch.bfloat16
    x = rank_inputs(cfg, 10, (T, K), bf, dev, 0)                   # replicated
    ws = [rank_inputs(cfg, 11, (K // A, N), bf, dev, r) for r in range(A)]
    w_full = torch.cat(ws)
    exact, mag = x.double() @ w_full.double(), x.double().abs() @ w_full.double().abs()
    limit = (K * 2.0 ** -24 + (2 * A - 1) * 2.0 ** -8) * mag
    got = C.ag_matmul(x, ws[me], g)
    gathered = torch.empty_like(w_full)

    def mono_ag():
        dist.all_gather_into_tensor(gathered, ws[me], group=g)
        return torch.mm(x, gathered)

    ref = mono_ag()
    out["matmuls"].append({
        "name": "ag_matmul", "shape": [T, K, N],
        "max_abs_err": float((got.double() - exact).abs().max()),
        "within_bound": bool(((got.double() - exact).abs() <= limit).all()),
        "monolithic_max_abs_err": float((ref.double() - exact).abs().max()),
        "max_share_of_bound": float(((got.double() - exact).abs() / limit).max()),
        "ms": world_ms(lambda: C.ag_matmul(x, ws[me], g), dev),
        "monolithic_ms": world_ms(mono_ag, dev),
        "mm_only_ms": world_ms(lambda: torch.mm(x, w_full), dev)})
    del got, ref, exact, mag, limit, gathered, w_full
    xs = [rank_inputs(cfg, 12, (T, K // A), bf, dev, r) for r in range(A)]
    rows = T // A
    exact = sum(xs[r][me * rows:(me + 1) * rows].double() @ ws[r].double() for r in range(A))
    mag = sum(xs[r][me * rows:(me + 1) * rows].double().abs() @ ws[r].double().abs()
              for r in range(A))
    limit = (K * 2.0 ** -24 + (2 * A - 1) * 2.0 ** -8) * mag
    got = C.matmul_rs(xs[me], ws[me], g, n_chunks=4)
    scattered = torch.empty((rows, N), dtype=bf, device=dev)

    def mono_rs():
        dist.reduce_scatter_tensor(scattered, torch.mm(xs[me], ws[me]), group=g)
        return scattered

    ref = mono_rs()
    out["matmuls"].append({
        "name": "matmul_rs", "shape": [T, K, N], "n_chunks": 4,
        "max_abs_err": float((got.double() - exact).abs().max()),
        "within_bound": bool(((got.double() - exact).abs() <= limit).all()),
        "monolithic_max_abs_err": float((ref.double() - exact).abs().max()),
        "max_share_of_bound": float(((got.double() - exact).abs() / limit).max()),
        "ms": world_ms(lambda: C.matmul_rs(xs[me], ws[me], g, n_chunks=4), dev),
        "monolithic_ms": world_ms(mono_rs, dev),
        "mm_only_ms": world_ms(lambda: torch.mm(xs[me], ws[me]), dev)})
    return out


def train_dist_worker(cfg: dict) -> dict:
    """One rank of the training world: ``launch.train.main`` on gemma-2b at
    full width (``TRAIN_DIST_ARGS``) over ``cfg["mesh"]``, every host digest
    patched to raise. On four ranks: ``TRAIN_DIST_STEPS`` steps under
    "auto", then under "chunked" with a checkpoint at ``TRAIN_DIST_CKPT``
    (written by rank 0), then a fresh ``main`` on every rank that restores
    it and runs the rest. On two ranks (``cfg["elastic"]``): that root's
    elastic resume. Records losses, step and sync seconds (the sync calls
    of ``launch.steps`` timed between synchronisations), the save's and
    each restore's seconds and launches, and whether each rank's restored
    tree equals rank 0's restored tree, and rank 0's its saved tree, bit
    for bit."""
    import torch.distributed as dist

    from repro_torch.distributed.mesh import init_world
    from repro_torch.launch import steps, train

    device = cfg["device"]
    init_world(device)
    rank = dist.get_rank()
    reset, counts = launch_counters()

    sync_s: dict[str, list] = {}

    def timed(fn, key):
        def call(*a, **kw):
            sync(device)
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            sync(device)
            sync_s.setdefault(key, []).append(time.perf_counter() - t0)
            return res
        return call

    records: dict = {}
    base = cfg["args"] + ["--seed", str(cfg["seed"]), "--device", device,
                          "--steps", str(cfg["steps"]), "--mesh", cfg["mesh"]]
    real = (steps.world_mean, steps.cross_pod_mean, train.CheckpointManager)
    steps.world_mean = timed(real[0], "world_mean")
    steps.cross_pod_mean = timed(real[1], "cross_pod_mean")
    train.CheckpointManager = recording_manager(records, device, reset, counts)
    out: dict = {"rank": rank, "world": dist.get_world_size()}
    try:
        with host_digests_raise():
            if cfg["elastic"]:
                res = train.main(base + ["--sync-mode", "chunked", "--ckpt-dir", cfg["root"],
                                         "--microbatches", str(cfg["microbatches"])])
                out["elastic"] = {"losses": res["losses"], "step_s": res["step_seconds"]}
            else:
                for mode in ("auto", "chunked"):
                    sync_s.clear()
                    extra = (["--ckpt-dir", cfg["root"], "--ckpt-every", str(cfg["ckpt_step"])]
                             if mode == "chunked" else [])
                    reset_peak(rank_device(device))
                    res = train.main(base + ["--sync-mode", mode] + extra)
                    out[mode] = {"losses": res["losses"], "grad_norms": res["grad_norms"],
                                 "step_s": res["step_seconds"],
                                 "sync_s": {k: list(v) for k, v in sync_s.items()},
                                 "peak_bytes": peak_bytes(rank_device(device))}
                    del res
                res = train.main(base + ["--sync-mode", "chunked", "--ckpt-dir", cfg["root"],
                                         "--ckpt-every", "0"])
                out["resumed"] = {"losses": res["losses"], "step_s": res["step_seconds"]}
    finally:
        steps.world_mean, steps.cross_pod_mean, train.CheckpointManager = real
    from repro_torch.launch.train import parse_mesh

    mesh = parse_mesh(cfg["mesh"], device)
    checkpoint_records(records, out, mesh, ckpt_specs(cfg["args"], mesh))
    return out


class collective_timer:
    """Times every collective of the model axis in ``models.common``'s
    operators and in AdamW's clip norm (``dist.all_reduce``, kind "model",
    the norm's sums over ``data`` included; ``dist.all_gather``, kind
    "gather"; the reduce-scatter of ``_GatherSumModel``'s backward, kind
    "rs"; the MoE's ``dist.all_to_all_single``, kind "a2a"), ZeRO's
    gathers over ``data`` and the reduce-scatters of their backward (kinds
    "gather_data" and "rs_data") and every mean over the batch axes
    (``launch.steps.world_mean``, kind "batch") while entered: CUDA events around each call on the card (the
    compute stream's wait for the collective; no host synchronisation), the
    host clock on the CPU. ``per_step(n)`` sums each kind's calls a step."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.calls: dict[str, list] = {"model": [], "gather": [], "rs": [], "a2a": [],
                                       "batch": [], "gather_data": [], "rs_data": []}

    def _timed(self, fn, key):
        def call(*a, **kw):
            if self.device.type != "cuda":
                t0 = time.perf_counter()
                res = fn(*a, **kw)
                self.calls[key].append(time.perf_counter() - t0)
                return res
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            res = fn(*a, **kw)
            e1.record()
            self.calls[key].append((e0, e1))
            return res
        return call

    def __enter__(self):
        import types

        import torch.distributed as dist

        from repro_torch.launch import steps
        from repro_torch.models import common
        from repro_torch.optim import adamw

        proxy = types.SimpleNamespace(**{k: getattr(dist, k) for k in dir(dist)
                                         if not k.startswith("__")})
        proxy.all_reduce = self._timed(dist.all_reduce, "model")
        proxy.all_gather = self._timed(dist.all_gather, "gather")
        for name in ("reduce_scatter_tensor", "reduce_scatter_single"):
            if hasattr(dist, name):
                setattr(proxy, name, self._timed(getattr(dist, name), "rs"))
        proxy.all_to_all_single = self._timed(dist.all_to_all_single, "a2a")
        self.saved = [(common, "dist", common.dist), (adamw, "dist", adamw.dist),
                      (steps, "world_mean", steps.world_mean),
                      (common, "all_gather_into", common.all_gather_into),
                      (common, "reduce_scatter_into", common.reduce_scatter_into)]
        common.dist = adamw.dist = proxy
        steps.world_mean = self._timed(steps.world_mean, "batch")
        common.all_gather_into = self._timed(common.all_gather_into, "gather_data")
        common.reduce_scatter_into = self._timed(common.reduce_scatter_into, "rs_data")
        return self

    def __exit__(self, *_exc):
        for obj, name, value in self.saved:
            setattr(obj, name, value)

    def per_step(self, n_steps: int) -> dict:
        """{kind: [ms in step 1, ..., step n]}: every step makes the same
        calls, so they split evenly over the steps."""
        sync(self.device)
        out = {}
        for key, calls in self.calls.items():
            ms = [c[0].elapsed_time(c[1]) if isinstance(c, tuple) else 1e3 * c for c in calls]
            k = len(ms) // n_steps
            out[key] = [sum(ms[i * k:(i + 1) * k]) for i in range(n_steps)]
        return out


def release(device) -> None:
    """Give this process's cached card memory back before a world of ranks
    runs: rank 0 shares this process's card."""
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    """Bytes allocated at the peak on this rank's card since ``reset_peak``
    (0 on the CPU)."""
    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0


def rank_device(device):
    return torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else "cpu"


def family_dist_worker(cfg: dict) -> dict:
    """One rank of the families' world: ``launch.train.main`` on each cut of
    ``FAMILY_DIST_RUNS`` at full width over a 2x2x1 mesh (model 1),
    ``FAMILY_DIST_STEPS`` steps each; records losses, grad norms, step
    seconds and the card's peak bytes."""
    import torch.distributed as dist

    from repro_torch.distributed.mesh import init_world
    from repro_torch.launch import train

    init_world(cfg["device"])
    dev = rank_device(cfg["device"])
    out = {"rank": dist.get_rank(), "world": dist.get_world_size(), "runs": []}
    for args in cfg["runs"]:
        reset_peak(dev)
        res = train.main(args + ["--seed", str(cfg["seed"]), "--device", cfg["device"],
                                 "--steps", str(cfg["steps"]), "--mesh", cfg["mesh"]])
        out["runs"].append({"arch": _arg(args, "--arch"), "losses": res["losses"],
                            "grad_norms": res["grad_norms"], "step_s": res["step_seconds"],
                            "peak_bytes": peak_bytes(dev)})
        del res
    return out


def blocks_agree(params, specs, mesh) -> bool:
    """Every leaf of this rank's ``params`` bit-equal on the ranks that hold
    the same block of it: those whose indices on the axes that cut the leaf
    under ``specs`` agree (every rank, for a leaf no axis cuts). Each leaf
    is gathered over the world (``dist.all_gather_into_tensor``), in tree
    order, and every rank compares the blocks it sees."""
    import itertools

    from repro_torch.distributed.mesh import all_gather_into, cut_axes
    from repro_torch.optim.adamw import tree_map

    names = mesh.axis_names
    coords = list(itertools.product(*(range(mesh.shape[a]) for a in names)))   # row-major
    equal = []

    def leaf(t, spec):
        axes = [names.index(a) for a in cut_axes(mesh, spec)]
        mine = t.contiguous().view(-1).view(torch.uint8)[None]
        every = mine.new_empty((len(coords), mine.numel()))
        all_gather_into(every, mine, None)
        first: dict = {}
        for r, c in enumerate(coords):
            at = tuple(c[i] for i in axes)
            if at in first:
                equal.append(bool(torch.equal(every[r], every[first[at]])))
            else:
                first[at] = r

    tree_map(leaf, params, specs)
    return bool(equal) and all(equal)


def gathered_routes(route_log: list, mesh, n_tokens: int) -> list:
    """Each logged MoE layer's router probabilities over all ``n_tokens``
    rows: column r logs rows j ≡ r (mod tp) of the padded flat tokens, so
    the columns' logs are gathered over ``model`` and interleaved."""
    import torch.distributed as dist

    from repro_torch.distributed.mesh import MODEL, axis_size

    tp = axis_size(mesh, MODEL)
    if tp == 1:
        return route_log
    out = []
    for p in route_log:
        parts = [torch.empty_like(p) for _ in range(tp)]
        dist.all_gather(parts, p.contiguous(), group=mesh.group(MODEL))
        out.append(torch.stack(parts, 1).reshape(-1, p.shape[-1])[:n_tokens])
    return out


def one_column(params: dict, cfg, tp: int) -> dict:
    """A MoE's whole params laid out for ``tp`` columns, laid out for one:
    expert e's F-slice h lives in column e·SPLIT + h, so ``we_g`` / ``we_i``
    ``(nb, E, SPLIT, D, fs)`` become ``(nb, 1, E, D, F)`` and ``we_o``
    ``(nb, E, SPLIT, fs, D)`` becomes ``(nb, 1, E, F, D)`` (with SPLIT 1,
    reshapes)."""
    from repro_torch.models.moe import expert_layout

    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff
    split = expert_layout(cfg, tp)[1]

    def leaf(key, t):
        nb = t.shape[0]
        if key in ("we_g", "we_i"):
            return t.reshape(nb, E, split, D, Fd // split).transpose(2, 3).reshape(nb, 1, E, D, Fd)
        if key == "we_o":
            return t.reshape(nb, 1, E, Fd, D)
        return t

    return {k: one_column(v, cfg, tp) if isinstance(v, dict) else leaf(k, v)
            for k, v in params.items()}


def lm_forward(model, params, tok, audio=None):
    """(logits, final hidden states) of ``tok``; an encdec's decoder over
    the encoder's output of the frames ``audio``."""
    if audio is None:
        return model.logits(params, tok), model.hidden(params, tok)
    enc = model.encode(params, audio)
    return model.dec_logits(params, tok, enc), model.dec_hidden(params, tok, enc)


def f32_forward_error(args: list, seed: int, mesh, dev) -> dict:
    """``args``' model at ``TP_F32_LAYERS`` layer(s), in f32: the logits of
    ``TP_F32_TOKENS`` seeded tokens from the whole weights on this card (a
    one-card forward) against the same weights cut over ``model``
    (``launch.train.shard_state``) and gathered; max |difference| over max
    |logit| (``rel``), and over the largest sum of magnitudes behind a
    logit, max (|h| @ |W|) of the final hidden states and the unembedding
    (``rel_sum``). A MoE's weights are drawn for the mesh's columns and laid out
    for one card (``one_column``); it runs at ``NO_DROP_CF`` with its
    routing logged, and a
    token whose top-k experts differ between the two runs (a near tie that
    the last bits flip) is left out of the error and counted in
    ``flipped_share``."""
    from repro_torch.launch import train

    one = train.with_layers(smoke_model(args, dtype=torch.float32), TP_F32_LAYERS)
    moe = one.cfg.family == "moe"
    kw = {"cf": NO_DROP_CF} if moe else {}
    one = type(one)(one.cfg, **kw)
    tp = type(one)(one.cfg, mesh, **kw)
    params = tp.init_params(seed, dev)                     # whole, laid out for tp columns
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 5)
    tok = torch.randint(0, one.cfg.vocab, (1, TP_F32_TOKENS), generator=gen, device=dev)
    one.route_log, tp.route_log = ([], []) if moe else (None, None)
    whole = one_column(params, one.cfg, tp.tp) if moe else params
    # an encdec's decoder reads seeded frames through the encoder
    audio = (seeded_embeddings(seed + 6, 1, one.cfg.enc_positions, one, dev)
             if one.cfg.family == "encdec" else None)
    with torch.no_grad():
        want, hidden = lm_forward(one, whole, tok, audio)
        got = lm_forward(tp, train.shard_state(mesh, params, tp.param_specs(mesh)), tok, audio)[0]
        # the largest sum of magnitudes behind a logit, max (|h| @ |W|): the scale of
        # the f32 rounding in the logits (a random untied unembedding's logits are
        # about sqrt(D) times smaller than the sums behind them)
        sums = float((hidden.abs() @ one._out_w(whole).abs()).max())
    flipped = torch.zeros(TP_F32_TOKENS, dtype=torch.bool)
    if moe:
        k = one.cfg.top_k
        for a, b in zip(topk_sets(one.route_log, k),
                        topk_sets(gathered_routes(tp.route_log, mesh, TP_F32_TOKENS), k)):
            flipped |= (a != b).any(-1)
    kept = (~flipped).to(dev)
    err = float((got.double() - want.double()).abs()[0][kept].max())
    top = float(want.abs().max())
    out = {"max_abs_err": err, "max_logit": top, "rel": err / top, "layers": TP_F32_LAYERS,
           "tokens": TP_F32_TOKENS, "max_magnitude_sum": sums, "rel_sum": err / sums}
    if moe:
        out.update(flipped_share=float(flipped.float().mean()), capacity_factor=NO_DROP_CF)
    return out


def step1_dropped(args: list, seed: int, mesh, dev, microbatches: int = 1) -> int:
    """The assignments that step 1's forward of ``args``' MoE drops on this
    rank (its rows of the global batch, its column's slice of them, in
    ``microbatches`` as the train step takes them): each logged layer's
    assignments to an expert past the capacity of the rows that routed
    them (``models.moe.capacity``)."""
    from repro_torch.data.pipeline import DataConfig, TokenPipeline, _batch_at
    from repro_torch.launch import train
    from repro_torch.models.moe import capacity

    base = smoke_model(args)
    model = type(base)(base.cfg, mesh, cf=base.cf)
    cfg = model.cfg
    params = train.shard_state(mesh, model.init_params(seed, dev), model.param_specs(mesh))
    gb = int(_arg(args, "--global-batch"))
    tok = torch.from_numpy(np.asarray(_batch_at(DataConfig(
        vocab=cfg.vocab, seq_len=int(_arg(args, "--seq-len")), global_batch=gb, seed=seed),
        0)))[TokenPipeline._rows(gb, mesh)].to(dev)
    model.route_log = []
    with torch.no_grad():
        for part in tok.chunk(microbatches, dim=0):
            model.loss(params, {"tokens": part})
    dropped = 0
    for p in model.route_log:
        C = capacity(p.shape[0], cfg, model.tp, model.cf)
        counts = torch.bincount(torch.topk(p, cfg.top_k, dim=-1).indices.reshape(-1),
                                minlength=cfg.n_experts)
        dropped += int(torch.clamp(counts - C, min=0).sum())
    return dropped


class step_memory:
    """While entered: the card's peak bytes up to the first train step (the
    whole params drawn, then cut into this rank's blocks: ``init_peak``),
    after which the peak restarts, so ``peak_bytes`` afterwards is the
    steps' own; and the bytes of this rank's params, gradients and AdamW
    moments as the first step's ``adamw.apply`` receives them
    (``state_bytes``)."""

    def __init__(self, dev):
        self.dev, self.init_peak, self.state_bytes = dev, None, None

    def __enter__(self):
        from repro_torch.launch import train
        from repro_torch.optim import adamw

        def nbytes(tree):
            return sum(t.numel() * t.element_size() for t in adamw.tree_leaves(tree))

        def build(*a, **kw):
            bundle = real_build(*a, **kw)
            fn = bundle.fn

            def first(*args):
                if self.init_peak is None:
                    self.init_peak = peak_bytes(self.dev)
                    reset_peak(self.dev)
                return fn(*args)

            bundle.fn = first
            return bundle

        def apply(params, grads, state, *a, **kw):
            if self.state_bytes is None:
                self.state_bytes = {"params": nbytes(params), "grads": nbytes(grads),
                                    "moments": nbytes(state.m) + nbytes(state.v)}
            return real_apply(params, grads, state, *a, **kw)

        real_build, real_apply = train.build_train_step, adamw.apply
        self.saved = [(train, "build_train_step", real_build), (adamw, "apply", real_apply)]
        train.build_train_step, adamw.apply = build, apply
        return self

    def __exit__(self, *_exc):
        for obj, name, value in self.saved:
            setattr(obj, name, value)


def tp_train(cfg: dict, args: list, base: list, extra: list, mesh, dev) -> dict:
    """One model-axis run of ``args`` on this rank: the f32 forward check
    (``f32_forward_error``), then ``launch.train.main`` with every
    model-axis, data-axis and batch-axes collective timed
    (``collective_timer``) and the card's memory split at the first step
    (``step_memory``), with ``extra`` (a checkpoint) where given, then a
    fresh ``main`` that restores it and runs the rest; after each run,
    whether every leaf is bit-equal on the ranks that hold its block
    (``blocks_agree``). With ``cfg["peak_max"]`` (no checkpoint), a run
    whose peak passes it on any card runs again at half the global batch;
    with ``cfg["halve"] == "microbatches"``, a run whose steps' peak passes
    it, at the same batch in twice the microbatches (down to one sequence
    a card a pass). A MoE also
    counts the assignments its step-1 forward drops on this rank
    (``step1_dropped``)."""
    import torch.distributed as dist

    from repro_torch.launch import train

    out = {"f32": f32_forward_error(args, cfg["seed"], mesh, dev)}
    specs = smoke_model(args).param_specs(mesh)
    by_micro = cfg.get("halve") == "microbatches"
    while True:
        reset_peak(dev)
        with collective_timer(dev) as timer, step_memory(dev) as memory:
            res = train.main(args + base + extra)
        step_peak = peak_bytes(dev)
        run_peak = max(step_peak, memory.init_peak or 0)
        worst = torch.tensor([float(step_peak if by_micro else run_peak)], device=dev)
        dist.all_reduce(worst, op=dist.ReduceOp.MAX)
        batch = int(_arg(args, "--global-batch"))
        micro = int(_arg(args, "--microbatches", 1))
        per_card = batch // (mesh.shape.get("pod", 1) * mesh.shape.get("data", 1) * micro)
        if (not cfg.get("peak_max") or float(worst) <= cfg["peak_max"] or extra
                or (by_micro and per_card == 1)):
            break
        # over the bound on some card: the same run at half the sequences a pass
        del res
        release(dev)
        args = (with_arg(args, "--microbatches", 2 * micro) if "--microbatches" in args
                else args + ["--microbatches", "2"]) if by_micro else \
            with_arg(args, "--global-batch", batch // 2)
    out["train"] = {"losses": res["losses"], "grad_norms": res["grad_norms"],
                    "step_s": res["step_seconds"], "peak_bytes": run_peak,
                    "step_peak_bytes": step_peak, "init_peak_bytes": memory.init_peak,
                    "state_bytes": memory.state_bytes, "sequences_a_pass": per_card,
                    "collective_ms": timer.per_step(cfg["steps"]), "global_batch": batch,
                    "blocks_equal": blocks_agree(res["params"], specs, mesh)}
    del res
    if smoke_model(args).cfg.family == "moe":
        out["dropped"] = step1_dropped(args, cfg["seed"], mesh, dev)
    if extra:
        res = train.main(args + base + extra[:2])
        out["resumed"] = {"losses": res["losses"],
                          "blocks_equal": blocks_agree(res["params"], specs, mesh)}
        del res
    release(dev)
    return out


def checkpoint_records(records: dict, out: dict, mesh=None, specs=None) -> None:
    """Into ``out``: whether rank 0 restored what it saved bit for bit, the
    MANIFEST and the save's seconds, launches and bytes (rank 0), and
    whether this rank's restored tree equals rank 0's, with the restore's
    seconds and launches. A restore that kept this rank's blocks (``specs``,
    the checkpoint's, over ``mesh``) is gathered whole leaf by leaf, in key
    order on every rank, before it is compared."""
    import torch.distributed as dist

    from repro_torch.distributed.mesh import gather

    if "restored" not in records:
        if "save" in records:
            raise RuntimeError("rank 0 saved a checkpoint but restored none")
        return
    flat = flat_tree(specs) if specs is not None else {}
    equal, saved_equal = True, True
    saved = records.get("saved")
    restored = records["restored"]
    for key in sorted(restored):          # every rank's restored tree against rank 0's
        t = restored[key]
        if key in flat:
            t = gather(mesh, t, flat[key])
        t = t.reshape(-1).contiguous()
        if saved is not None:
            saved_equal = saved_equal and key in saved and torch.equal(
                t.view(torch.uint8), saved[key].to(t.device).reshape(-1).view(torch.uint8))
        theirs = t.clone()
        dist.broadcast(theirs, src=0)
        equal = equal and bool(torch.equal(theirs.view(torch.uint8), t.view(torch.uint8)))
    out["restored_equal_rank0"] = equal
    out["restore"] = records["restore"]
    out["restored_bytes"] = sum(t.numel() * t.element_size() for t in restored.values())
    out["device"] = str(restored[sorted(restored)[0]].device)
    if "save" in records:
        out["saved_equal_restored"] = saved_equal and sorted(saved) == sorted(restored)
        with open(os.path.join(records["save"]["path"], "MANIFEST.json")) as fh:
            out["manifest"] = json.load(fh)
        out["save"] = {k: records["save"][k] for k in ("seconds", "launches", "bytes")}


def ckpt_specs(args: list, mesh):
    """The checkpoint tree's specs of ``args``' model over ``mesh``
    (``launch.train.checkpoint_specs``)."""
    from repro_torch.launch import train

    return train.checkpoint_specs(smoke_model(args), mesh)


def tp_dist_worker(cfg: dict) -> dict:
    """One rank of a model-axis world (``cfg["mesh"]``, e.g. 1x2x2 or
    1x1x4): ``tp_train`` on ``cfg["args"]`` for ``cfg["steps"]`` steps with
    every host digest patched to raise, with a checkpoint at
    ``cfg["ckpt_step"]`` when given (rank 0 writes the whole tree). Then
    each of ``cfg["also"]`` (another arch on the same mesh, trained for
    ``cfg["also_steps"]`` steps with its collectives timed, its losses and
    grad norms kept and its blocks checked). With ``cfg["runs"]`` in place of ``cfg["args"]``,
    ``tp_train`` on each of them in turn (``out["runs"]``), the checkpoint
    on the run whose arch is ``cfg["ckpt_arch"]``. On ``cfg["elastic"]``,
    only the resume of ``cfg["root"]``."""
    import torch.distributed as dist

    from repro_torch.distributed.mesh import MODEL, init_world
    from repro_torch.launch import train
    from repro_torch.launch.train import parse_mesh

    device = cfg["device"]
    init_world(device)
    dev = rank_device(device)
    mesh = parse_mesh(cfg["mesh"], device)
    rank = dist.get_rank()
    reset, counts = launch_counters()
    records: dict = {}
    real = train.CheckpointManager
    train.CheckpointManager = recording_manager(records, dev, reset, counts)
    base = ["--seed", str(cfg["seed"]), "--device", device, "--mesh", cfg["mesh"],
            "--steps", str(cfg["steps"])]
    out: dict = {"rank": rank, "world": dist.get_world_size(), "mesh": cfg["mesh"],
                 "model_rank": mesh.rank(MODEL), "device": str(dev)}
    ckpt = (["--ckpt-dir", cfg["root"], "--ckpt-every", str(cfg["ckpt_step"])]
            if cfg.get("ckpt_step") else [])
    try:
        with host_digests_raise():
            if cfg["elastic"]:
                res = train.main(cfg["args"] + base + ["--ckpt-dir", cfg["root"],
                                                       "--microbatches", str(cfg["microbatches"])])
                out["elastic"] = {"losses": res["losses"], "step_s": res["step_seconds"]}
            elif "runs" in cfg:
                out["runs"] = []
                for args in cfg["runs"]:
                    extra = ckpt if _arg(args, "--arch") == cfg.get("ckpt_arch") else []
                    out["runs"].append({"arch": _arg(args, "--arch"),
                                        **tp_train(cfg, args, base, extra, mesh, dev)})
            else:
                out.update(tp_train(cfg, cfg["args"], base, ckpt, mesh, dev))
                out["also"] = []
                for args in cfg.get("also", []):
                    reset_peak(dev)
                    with collective_timer(dev) as timer:
                        res = train.main(args + base[:-2] + ["--steps", str(cfg["also_steps"])])
                    out["also"].append({
                        "arch": _arg(args, "--arch"), "losses": res["losses"],
                        "grad_norms": res["grad_norms"], "step_s": res["step_seconds"],
                        "peak_bytes": peak_bytes(dev),
                        "collective_ms": timer.per_step(cfg["also_steps"]),
                        "blocks_equal": blocks_agree(
                            res["params"], smoke_model(args).param_specs(mesh), mesh)})
                    del res
    finally:
        train.CheckpointManager = real
    ck_args = cfg.get("args") or next(
        (a for a in cfg.get("runs", []) if _arg(a, "--arch") == cfg.get("ckpt_arch")), None)
    checkpoint_records(records, out, mesh, ckpt_specs(ck_args, mesh) if ck_args else None)
    return out


def teacher_forced(model, params, prompts, cache_specs=None, audio=None):
    """Each step's logits (B, S, V) in f32 of decoding ``prompts`` token by
    token (an encdec's after ``prefill_cross`` of the frames ``audio``);
    under ``cache_specs`` (over the model's mesh), this rank's rows of
    them, over its blocks of the cache."""
    from repro_torch.distributed.mesh import P, shard
    from repro_torch.launch.train import shard_state
    from repro_torch.models.common import cache_batch_spec

    B, S = prompts.shape
    cache = model.init_cache(B, S, device=prompts.device)
    kw = {}
    if cache_specs is not None:
        rows = cache_batch_spec(model.mesh, B)
        cache = shard_state(model.mesh, cache, cache_specs)
        prompts = shard(model.mesh, prompts, P(rows, None))
        if audio is not None:
            audio = shard(model.mesh, audio, P(rows, None, None))
        kw = {"cache_specs": cache_specs}
    out = []
    with torch.no_grad():
        if audio is not None:
            cache = model.prefill_cross(params, cache, audio, **kw)
        for t in range(S):
            pos = torch.full((prompts.shape[0],), t, dtype=torch.int32, device=prompts.device)
            lg, cache = model.decode_step(params, cache, prompts[:, t:t + 1], pos, **kw)
            out.append(lg.float())
    return torch.cat(out, dim=1)


def f32_cut(model, params, n_layers: int):
    """``model`` (on its mesh) in f32 at its first ``n_layers`` layers, and
    ``params`` (whole or this rank's blocks: the layer dim is never cut)
    cut to them, in f32."""
    import dataclasses

    from repro_torch.launch.train import with_layers
    from repro_torch.optim.adamw import tree_map

    cut = with_layers(type(model)(dataclasses.replace(model.cfg, dtype=torch.float32),
                                  model.mesh), n_layers)
    blocks = {i: {k: t[:cut.n_blocks] for k, t in lp.items()}
              for i, lp in params["blocks"].items()}
    return cut, tree_map(lambda t: t.float(), {**params, "blocks": blocks})


def timed_generate(model, params, prompts, gen: int, dev, timer=None):
    """(rows, ms a decode step) of ``launch.serve.generate`` after a
    two-token warm-up, with ``timer`` (a ``collective_timer``) entered
    around the timed run only."""
    import contextlib

    from repro_torch.launch import serve

    Lp = prompts.shape[1]
    serve.generate(model, params, prompts, 2, Lp + 2)
    sync(dev)
    t0 = time.perf_counter()
    with timer if timer is not None else contextlib.nullcontext():
        rows = serve.generate(model, params, prompts, gen, Lp + gen)
        sync(dev)
    return rows, 1e3 * (time.perf_counter() - t0) / (Lp + gen - 1)


def serve_dist_worker(cfg: dict) -> dict:
    """One rank of the serve world: rank 0 draws the one-device params of
    ``cfg["args"]`` (gemma-2b, full width), saves them as a params-only
    root and decodes on its card alone (the f32 teacher-forced logits of
    the prompt at the whole depth and at ``TP_F32_LAYERS``, with its own
    f32 forward's distance from them; the bf16 greedy tokens and their ms
    a step); then each of ``cfg["runs"]`` (mesh, weight-stationary): every
    rank restores its blocks of the root under those specs (every host
    digest patched to raise; compared bit for bit, gathered, with rank 0's
    saved tree), cuts the cache by ``cache_specs``, decodes the prompt in
    f32 at both depths (rank 0 holds the gathered logits to its one-card
    ones) and then ``cfg["gen"]`` greedy tokens in bf16 with every
    model-axis collective timed, and checks its blocks bit-equal on the
    ranks that hold them."""
    import torch.distributed as dist

    from repro_torch.distributed.mesh import P, cut_axes, gather, shard
    from repro_torch.launch import serve, train

    device = cfg["device"]
    dev = rank_device(device)
    rank = dist.get_rank()
    one = smoke_model(cfg["args"])
    B, Lp, gen = cfg["batch"], cfg["prompt"], cfg["gen"]
    reset, counts = launch_counters()
    records: dict = {}
    mgr = recording_manager(records, dev, reset, counts)(cfg["root"], device=dev)
    prompts = serve.prompts_for(cfg["seed"], B, Lp, one.cfg.vocab, dev)
    out: dict = {"rank": rank, "world": dist.get_world_size(), "runs": []}
    depths = (one.cfg.n_layers, TP_F32_LAYERS)
    want_f32 = {}
    if rank == 0:
        params = one.init_params(cfg["seed"], dev)
        with host_digests_raise():
            mgr.save(0, {"params": params})
        out["one_card"] = {}
        for n in depths:
            m32, p32 = f32_cut(one, params, n)
            want_f32[n] = teacher_forced(m32, p32, prompts)
            with torch.no_grad():       # one card's own spread: its forward's order of sums
                fwd = m32.logits(p32, prompts).float()
            out["one_card"][str(n)] = {
                "max_logit": float(want_f32[n].abs().max()),
                "decode_vs_forward": float((fwd - want_f32[n]).abs().max())}
            del p32, fwd
        want_rows, one_ms = timed_generate(one, params, prompts, gen, dev)
        out["one_card"]["ms_per_decode_step"] = one_ms
        del params
    dist.barrier()
    meshes: dict = {}
    for mesh_spec, stationary in cfg["runs"]:
        release(dev)
        mesh = mesh_for(mesh_spec, device, meshes)
        model = type(one)(one.cfg, mesh)
        pspecs = model.param_specs(mesh, serve=stationary)
        flat = flat_tree({"params": pspecs})

        def keep(key, t):
            s = flat[key]
            return shard(mesh, t, s).clone() if cut_axes(mesh, s) else t

        with host_digests_raise():
            params = mgr.restore(keep=keep)[0]["params"]
        run = {"mesh": mesh_spec, "weight_stationary": stationary}
        checkpoint_records(records, run, mesh, {"params": pspecs})
        if "manifest" in run:
            out["manifest"] = run.pop("manifest")
        run["blocks_equal"] = blocks_agree(params, pspecs, mesh)
        run["f32_max_abs_err"] = {}
        for n in depths:
            m32, p32 = f32_cut(model, params, n)
            specs = m32.cache_specs(mesh, B, Lp)
            got = gather(mesh, teacher_forced(m32, p32, prompts, specs),
                         P(specs["p0"][1], None, None))
            if rank == 0:
                run["f32_max_abs_err"][str(n)] = float((got - want_f32[n]).abs().max())
            del got, p32
        reset_peak(dev)
        timer = collective_timer(dev)
        mine, ms = timed_generate(model, params, prompts, gen, dev, timer)
        cache = model.init_cache(B, Lp + gen, device=dev)
        cspecs = model.cache_specs(mesh, B, Lp + gen)
        run["cache_bytes"] = sum(t.numel() * t.element_size() for t in
                                 train.shard_state(mesh, cache, cspecs).values())
        run["cache_bytes_whole"] = sum(t.numel() * t.element_size() for t in cache.values())
        del cache
        steps = Lp + gen - 1
        run.update(ms_per_decode_step=ms, peak_bytes=peak_bytes(dev),
                   collective_ms=timer.per_step(steps),
                   collective_calls={k: len(v) // steps for k, v in timer.calls.items()})
        whole = gather(mesh, mine, P(cspecs["p0"][1], None))
        if rank == 0:
            new, ref = whole[:, Lp:], want_rows[:, Lp:]
            run["prompt_equal"] = bool(torch.equal(whole[:, :Lp], want_rows[:, :Lp]))
            run["greedy_agree"] = int((new == ref).sum())
            run["greedy_tokens"] = int(new.numel())
            run["first_divergence"] = [int((r != w).nonzero()[0]) if bool((r != w).any())
                                       else None for r, w in zip(new, ref)]
        del params
        out["runs"].append(run)
    if cfg.get("long"):
        release(dev)
        out["long"] = long_ranks(cfg["long"], cfg["seed"], device, dev, rank, meshes)
    return out


def long_ranks(cfg: dict, seed: int, device, dev, rank: int, meshes: dict) -> dict:
    """This rank's part of gemma2-2b (``cfg["args"]``, ``LONG_ARGS``) at
    batch 1 over the long_500k cache (``long_cache``) in the serve world:
    rank 0 decodes
    ``cfg["steps"]`` teacher-forced tokens from ``cfg["start"]`` on its card
    alone in f32 at 1 global layer and at 2 (local, global) over the whole
    cache; then on each of ``cfg["meshes"]`` every rank decodes the same
    over its blocks of the cache (``cache_specs``: the time cut over every
    axis over 1) and of the weights (the serve specs), and rank 0 holds
    the logits to its one-card ones; then at the whole depth in bf16 on
    ``cfg["deep_mesh"]``, timed with every collective (``collective_timer``):
    ms a decode step, cache and peak bytes a card, the positions each
    rank wrote. Meshes come from ``meshes`` (``mesh_for``)."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.distributed.mesh import block_index, entry_cut
    from repro_torch.launch import serve
    from repro_torch.launch.train import shard_state

    T, start, steps, tile = cfg["T"], cfg["start"], cfg["steps"], cfg["tile"]
    deep = smoke_model(cfg["args"])
    tokens = serve.prompts_for(seed + 7, 1, steps, deep.cfg.vocab, dev)
    cuts = {"1": dataclasses.replace(deep.cfg, n_layers=1, attn_pattern="g", dtype=torch.float32),
            "2": dataclasses.replace(deep.cfg, n_layers=2, dtype=torch.float32)}
    out: dict = {"one_card": {}, "runs": []}
    want = {}
    if rank == 0:
        for n, c in cuts.items():
            m = type(deep)(c)
            want[n] = long_decode(m, m.init_params(seed, dev),
                                  long_cache(m, T, start, seed, dev, tile), tokens, start)[0]
            out["one_card"][n] = {"max_logit": float(want[n].abs().max())}
            release(dev)
    dist.barrier()
    for mesh_spec in cfg["meshes"]:
        mesh = mesh_for(mesh_spec, device, meshes)
        run: dict = {"mesh": mesh_spec, "f32_max_abs_err": {}}
        for n, c in cuts.items():
            m = type(deep)(c, mesh)
            params = shard_state(mesh, type(deep)(c).init_params(seed, dev),
                                 m.param_specs(mesh, serve=True))
            specs = m.cache_specs(mesh, 1, T)
            got = long_decode(m, params, long_cache(m, T, start, seed, dev, tile, mesh, specs),
                              tokens, start, specs)[0]
            run["time_axes"] = list(m._time_cut(specs["p0"]))
            if rank == 0:
                run["f32_max_abs_err"][n] = float((got - want[n]).abs().max())
            del params, got
            release(dev)
        out["runs"].append(run)
    mesh = mesh_for(cfg["deep_mesh"], device, meshes)
    model = on_mesh(deep, mesh)
    params = shard_state(mesh, deep.init_params(seed, dev), model.param_specs(mesh, serve=True))
    specs = model.cache_specs(mesh, 1, T)
    release(dev)
    reset_peak(dev)
    cache = long_cache(model, T, start, seed, dev, tile, mesh, specs)
    long_decode(model, params, cache, tokens[:, :2], start, specs)      # rewrites its two slots
    sync(dev)
    timer = collective_timer(dev)
    t0 = time.perf_counter()
    with timer:
        logits, cache = long_decode(model, params, cache, tokens, start, specs)
        sync(dev)
    ms = 1e3 * (time.perf_counter() - t0) / steps
    cache_bytes = {k: t.numel() * t.element_size() for k, t in cache.items()}
    out["deep"] = {
        "mesh": cfg["deep_mesh"], "layers": deep.cfg.n_layers, "ms_per_decode_step": ms,
        "dtype": str(deep.cfg.dtype).removeprefix("torch."),
        "time_axes": list(model._time_cut(specs["p1"])),
        "cache_bytes": sum(cache_bytes.values()),
        "cache_bytes_whole": sum(b * block_index(mesh, entry_cut(mesh, specs[k][2]))[1]
                                 for k, b in cache_bytes.items()),
        "peak_bytes": peak_bytes(dev), "finite": bool(torch.isfinite(logits).all()),
        "logits_sum": float(logits.double().sum()),
        "written": long_written(model, cache, T, start, steps, mesh, specs),
        "collective_ms": timer.per_step(steps),
        "collective_calls": {k: len(v) // steps for k, v in timer.calls.items()}}
    del params, cache, logits
    release(dev)
    return out


def mesh_for(spec: str, device, meshes: dict):
    """``launch.train.parse_mesh(spec)``, made once a world and kept in
    ``meshes``: every rank asks for the same specs in the same order, and a
    mesh's process groups cost seconds each to set up on NCCL."""
    from repro_torch.launch.train import parse_mesh

    if spec not in meshes:
        meshes[spec] = parse_mesh(spec, device)
    return meshes[spec]


def on_mesh(model, mesh):
    """``model`` (its config and its own arguments) over ``mesh``."""
    kw = {"max_target": model.max_target} if model.cfg.family == "encdec" else {}
    if model.cfg.family == "moe":
        kw["cf"] = model.cf
    return type(model)(model.cfg, mesh, **kw)


def column_leaf(key: str, t: torch.Tensor, cfg, tp: int) -> torch.Tensor:
    """A leaf (its key ends in its name) of a MoE's one-device params laid
    out for ``tp`` columns: an expert leaf ``(nb, 1, E, ...)`` becomes
    ``(nb, tp, E / tp, ...)``, expert g·E_loc + el in column g (SPLIT 1:
    ``one_column``'s inverse, a view of the same bytes); every other leaf
    is returned as it is."""
    from repro_torch.models.moe import expert_layout

    if key.rsplit("/", 1)[-1] not in ("we_g", "we_i", "we_o") or tp == 1:
        return t
    e_loc, split, _ = expert_layout(cfg, tp)
    if split != 1:
        raise ValueError(f"{cfg.name}: {cfg.n_experts} experts on {tp} columns split them")
    return t.reshape(t.shape[0], tp, e_loc, *t.shape[3:])


def to_columns(params: dict, cfg, tp: int) -> dict:
    """``column_leaf`` of every leaf of a MoE's one-device params."""
    return {k: to_columns(v, cfg, tp) if isinstance(v, dict) else column_leaf(k, v, cfg, tp)
            for k, v in params.items()}


def encdec_generate(model, params, prompts, audio, gen: int, timer=None):
    """An encdec's serve protocol, the reference's (``generate`` refuses
    one): ``prefill_cross`` of the frames ``audio``, then
    ``build_serve_step``'s step over the prompt and ``gen`` greedy tokens,
    over the model's mesh on this rank's rows and blocks of the cache (cut
    by the bundle's ``cache_specs``), with ``timer`` entered around the
    loop only. (rows, ``prefill_cross`` seconds, the loop's seconds)."""
    import contextlib

    from repro_torch.configs.registry import ShapeCell
    from repro_torch.distributed.mesh import P, shard
    from repro_torch.launch.steps import build_serve_step
    from repro_torch.launch.train import shard_state
    from repro_torch.models.common import cache_batch_spec

    B, Lp = prompts.shape
    mesh, dev = model.mesh, prompts.device
    bundle = build_serve_step(model, mesh, cell=ShapeCell("d", Lp + gen, B, "decode"))
    cache, cspecs, kw = model.init_cache(B, Lp + gen, device=dev), bundle.specs[1], {}
    if cspecs is not None:
        rows = cache_batch_spec(mesh, B)
        cache = shard_state(mesh, cache, cspecs)
        prompts = shard(mesh, prompts, P(rows, None))
        audio = shard(mesh, audio, P(rows, None, None))
        kw = {"cache_specs": cspecs}
    sync(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        cache = model.prefill_cross(params, cache, audio, **kw)
    sync(dev)
    t1 = time.perf_counter()
    tok, out = prompts[:, :1], [prompts[:, :1]]
    pos = torch.zeros(prompts.shape[0], dtype=torch.int32, device=dev)
    with timer if timer is not None else contextlib.nullcontext():
        for t in range(Lp + gen - 1):
            tok, cache, pos = bundle.fn(params, cache, tok, pos)
            if t + 1 < Lp:
                tok = prompts[:, t + 1:t + 2]
            out.append(tok)
        sync(dev)
    return torch.cat(out, dim=1), t1 - t0, time.perf_counter() - t1


def timed_greedy(model, params, prompts, gen: int, dev, timer=None, audio=None):
    """(rows, ms a decode step, ``prefill_cross`` ms or None): ``timed_generate``,
    and for an encdec (``audio`` given) ``encdec_generate`` after a
    two-token warm-up."""
    if audio is None:
        rows, ms = timed_generate(model, params, prompts, gen, dev, timer)
        return rows, ms, None
    encdec_generate(model, params, prompts, audio, 2)
    rows, pre_s, loop_s = encdec_generate(model, params, prompts, audio, gen, timer)
    return rows, 1e3 * loop_s / (prompts.shape[1] + gen - 1), 1e3 * pre_s


def serve_families_worker(cfg: dict) -> dict:
    """One rank of the families' world. For each of ``cfg["families"]``
    (launcher args, meshes at ``cfg["batch"]``, meshes at batch 1): rank 0
    draws the one-device params (full width, bf16) and saves them as a
    params-only root. Then for each batch with meshes (``cfg["batch"]`` with
    ``cfg["prompt"]`` + ``cfg["gen"]`` tokens; 1 with ``cfg["b1_prompt"]`` +
    ``cfg["b1_gen"]``, whose cache time is cut over ``data`` too) rank 0
    decodes on its card alone: the f32 teacher-forced logits of the prompt
    at ``TP_F32_LAYERS`` and at the family's depth (each from its own f32
    draw, which every rank also makes), a MoE's top-k choices at every
    step, and the bf16 greedy tokens with their ms a step (an encdec's after
    ``prefill_cross``, timed). Then on each mesh every rank restores its
    blocks of the root under the train specs (a MoE's expert leaves laid
    out for the mesh's columns, ``to_columns``; every host digest patched
    to raise; compared, gathered, with rank 0's saved tree), decodes the
    prompt in f32 at both depths over a cache cut by ``cache_specs`` (rank
    0 holds the gathered logits to its one-card ones, leaving out each
    row's steps where a MoE layer chose other experts, which it counts)
    and then the greedy tokens in bf16 with every model-axis collective
    timed, and checks its blocks bit-equal on the ranks that hold them."""
    import shutil

    import torch.distributed as dist

    from repro_torch.distributed.mesh import P, axis_size, cut_axes, gather, shard
    from repro_torch.launch import serve, train
    from repro_torch.models.common import cache_batch_spec

    device = cfg["device"]
    dev = rank_device(device)
    rank = dist.get_rank()
    reset, counts = launch_counters()
    out: dict = {"rank": rank, "world": dist.get_world_size(), "families": []}
    made: dict = {}
    for args, meshes, b1_meshes in cfg["families"]:
        release(dev)
        one = smoke_model(args)
        moe, encdec = one.cfg.family == "moe", one.cfg.family == "encdec"
        records: dict = {}
        root = os.path.join(cfg["root"], _arg(args, "--arch"))
        mgr = recording_manager(records, dev, reset, counts)(root, device=dev)
        depths = sorted({TP_F32_LAYERS, one.cfg.n_layers})
        fam: dict = {"arch": _arg(args, "--arch"), "layers": one.cfg.n_layers,
                     "f32_tolerance": {str(n): ENCDEC_TP_F32_TOL if encdec else
                                       (TP_F32_TOL if n == TP_F32_LAYERS else F32_TOL)
                                       for n in depths}}

        def f32_model(n, mesh=None):
            m = smoke_model(with_arg(args, "--layers", n), dtype=torch.float32)
            return m if mesh is None else on_mesh(m, mesh)

        params = None
        if rank == 0:
            params = one.init_params(cfg["seed"], dev)
            with host_digests_raise():
                mgr.save(0, {"params": params})
        for B, Lp, gen, where, key in ((cfg["batch"], cfg["prompt"], cfg["gen"], meshes, ""),
                                       (1, cfg["b1_prompt"], cfg["b1_gen"], b1_meshes, "b1_")):
            fam[f"{key}runs"] = []
            if not where:
                continue
            prompts = serve.prompts_for(cfg["seed"], B, Lp, one.cfg.vocab, dev)
            audio = seeded_embeddings(cfg["seed"] + 6, B, one.cfg.enc_positions, one, dev) \
                if encdec else None
            want_f32, want_top = {}, {}
            if rank == 0:
                fam[f"{key}one_card"] = one_card = {}
                for n in depths:
                    m32 = f32_model(n)
                    if moe:
                        m32.route_log = []
                    want_f32[n] = teacher_forced(m32, m32.init_params(cfg["seed"], dev), prompts,
                                                 audio=None if audio is None else audio.float())
                    if moe:
                        want_top[n] = topk_sets(m32.route_log, one.cfg.top_k)
                    one_card[str(n)] = {"max_logit": float(want_f32[n].abs().max())}
                    del m32
                want_rows, one_ms, one_pre = timed_greedy(one, params, prompts, gen, dev,
                                                          audio=audio)
                one_card.update(ms_per_decode_step=one_ms, prefill_cross_ms=one_pre)
            dist.barrier()
            for mesh_spec in where:
                release(dev)
                mesh = mesh_for(mesh_spec, device, made)
                model = on_mesh(one, mesh)
                tp = model._tp()
                pspecs = model.param_specs(mesh)
                flat = flat_tree({"params": pspecs})

                def keep(key, t):
                    t = column_leaf(key, t, one.cfg, tp) if moe else t
                    s = flat[key]
                    return shard(mesh, t, s).clone() if cut_axes(mesh, s) else t

                with host_digests_raise():
                    blocks = mgr.restore(keep=keep)[0]["params"]
                run = {"mesh": mesh_spec}
                # gathered, a MoE's expert leaf holds the saved leaf's bytes (a view of them)
                checkpoint_records(records, run, mesh, {"params": pspecs})
                if "manifest" in run:
                    fam["manifest"] = run.pop("manifest")
                run["blocks_equal"] = blocks_agree(blocks, pspecs, mesh)
                run["f32_max_abs_err"], run["route_flips"] = {}, {}
                rows = cache_batch_spec(mesh, B)
                b_loc = B if rows is None else B // (axis_size(mesh, "pod")
                                                     * axis_size(mesh, "data"))
                run["time_axes"] = list(model._time_cut(next(
                    (v for k, v in model.cache_specs(mesh, B, Lp).items()
                     if k in ("p0", "p", "ap")), None)))
                for n in depths:
                    m32 = f32_model(n, mesh)
                    if moe:
                        m32.route_log = []
                    p32 = f32_model(n).init_params(cfg["seed"], dev)
                    p32 = train.shard_state(mesh, to_columns(p32, one.cfg, tp) if moe else p32,
                                            m32.param_specs(mesh))
                    specs = m32.cache_specs(mesh, B, Lp)
                    got = gather(mesh, teacher_forced(m32, p32, prompts, specs,
                                                      None if audio is None else audio.float()),
                                 P(rows, None, None))
                    flipped = torch.zeros((B, Lp), dtype=torch.bool)
                    if moe:     # each logged layer's choices at each step, over the whole batch
                        mine = [gather(mesh, g, P(rows, None))
                                for g in gathered_routes(m32.route_log, mesh, b_loc)]
                        if rank == 0:
                            layers = len(mine) // Lp
                            for i, (a, b) in enumerate(zip(want_top[n],
                                                           topk_sets(mine, one.cfg.top_k))):
                                flipped[:, i // layers] |= (a != b).any(-1)
                            run["route_flips"][str(n)] = [int(flipped.sum()), B * Lp]
                    if rank == 0:
                        err = (got - want_f32[n]).abs()[~flipped.to(got.device)]
                        run["f32_max_abs_err"][str(n)] = float(err.max())
                    del got, p32, m32
                reset_peak(dev)
                timer = collective_timer(dev)
                mine_rows, ms, pre_ms = timed_greedy(model, blocks, prompts, gen, dev, timer,
                                                     audio)
                cache = model.init_cache(B, Lp + gen, device=dev)
                cspecs = model.cache_specs(mesh, B, Lp + gen)
                run["cache_bytes"] = sum(t.numel() * t.element_size() for t in
                                         train.shard_state(mesh, cache, cspecs).values())
                run["cache_bytes_whole"] = sum(t.numel() * t.element_size()
                                               for t in cache.values())
                del cache
                steps = Lp + gen - 1
                run.update(ms_per_decode_step=ms, prefill_cross_ms=pre_ms,
                           peak_bytes=peak_bytes(dev), collective_ms=timer.per_step(steps),
                           collective_calls={k: len(v) // steps for k, v in timer.calls.items()})
                whole = gather(mesh, mine_rows, P(rows, None))
                if rank == 0:
                    new, ref = whole[:, Lp:], want_rows[:, Lp:]
                    run["prompt_equal"] = bool(torch.equal(whole[:, :Lp], want_rows[:, :Lp]))
                    run["greedy_agree"] = int((new == ref).sum())
                    run["greedy_tokens"] = int(new.numel())
                del blocks
                fam[f"{key}runs"].append(run)
        del params
        out["families"].append(fam)
        dist.barrier()
        if rank == 0:
            shutil.rmtree(root, ignore_errors=True)
    return out


def run_ranks(name: str, n: int, cfg: dict, timeout: float = RANKS_TIMEOUT_S) -> list[dict]:
    """Run ``name``'s worker on ``n`` ranks under ``python -m
    torch.distributed.run`` (this file in its rank-worker mode, the port on
    ``PYTHONPATH``), and return each rank's result. A rank's failure or the
    timeout fails the phase; the whole process group is killed on either."""
    import signal
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix=f"chip-smoke-{name}-")
    cfg_path = os.path.join(work, "config.json")
    with open(cfg_path, "w") as fh:
        json.dump({**cfg, "out": work, "timeout": timeout}, fh)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(here, "src") + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(n), os.path.abspath(__file__),
           "--rank-worker", name, "--config", cfg_path]
    log_path = os.path.join(work, "log.txt")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env,
                                start_new_session=True)
        rc = None
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            pass
        finally:
            try:                         # whatever of the world is left
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
    with open(log_path) as fh:
        tail = fh.read()[-20000:]
    if rc != 0:
        print(tail)
        raise RuntimeError(f"{name} on {n} ranks: " + (f"timed out after {timeout} s"
                                                       if rc is None else f"exit code {rc}"))
    results = []
    for r in range(n):
        with open(os.path.join(work, f"rank{r}.json")) as fh:
            results.append(json.load(fh))
    results[0]["wall_s"] = time.perf_counter() - t0
    return results


def rank_worker(name: str, cfg_path: str) -> int:
    """This file's rank-worker mode: one rank of ``run_ranks``' world."""
    import torch.distributed as dist

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
    from repro_torch.distributed.mesh import init_world

    with open(cfg_path) as fh:
        cfg = json.load(fh)
    # a rank still running shortly before its world's timeout prints every
    # thread's stack into the world's log
    faulthandler.dump_traceback_later(max(10.0, cfg["timeout"] - 30.0), exit=False)
    init_world(cfg["device"])
    try:
        res = {"collectives": collectives_worker, "train_dist": train_dist_worker,
               "family_dist": family_dist_worker, "tp_dist": tp_dist_worker,
               "serve_dist": serve_dist_worker, "serve_families": serve_families_worker}[name](cfg)
    except BaseException:
        # leave at once, before any teardown: NCCL's would wait for the
        # peers' collectives, and this rank's error would never be printed
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    with open(os.path.join(cfg["out"], f"rank{dist.get_rank()}.json"), "w") as fh:
        json.dump(res, fh)
    dist.destroy_process_group()
    return 0


def four_cards(device, smi: str) -> dict | None:
    """The four cards' names and power limits (None with fewer than
    ``COLL_CARDS`` cards), printed."""
    if torch.device(device).type == "cuda" and torch.cuda.device_count() < COLL_CARDS:
        return None
    dev = torch.device(device).type
    cards = nvidia_smi_cards("name,power.limit")[:COLL_CARDS] if dev == "cuda" else [smi]
    if len(set(cards)) == 1:
        smi = f"{len(cards)} x {cards[0]}"
    else:
        smi = "; ".join(cards)
    print(f"collectives cards: {smi}")
    return {"card": smi, "cards": cards}


COLL_PARTS = ("collectives", "expert_axis", "family_model_axis", "zero_axis", "serve_model_axis",
              "serve_families")


def collectives_path(seed: int, device, smi: str, parts=COLL_PARTS) -> dict | None:
    """The four-card phase. With fewer than ``COLL_CARDS`` cards it runs
    nothing (None). Else: (a) ``collectives_worker`` on four ranks; (b)
    ``train_dist_worker`` on four ranks, then the elastic resume of its
    root on two, and step 1 of the same 16 sequences on one card in this
    process (``ONE_CARD_MICROBATCHES``); (c) the model axis and the other
    families (``model_axis_path``); (d) the expert axis
    (``expert_axis_path``); (e) the model axis of the ssm, hybrid and
    encdec families (``family_model_axis_path``); (f) serving over the
    model axis (``serve_model_axis_path``); (g) serving the moe, ssm,
    hybrid and encdec families over it (``serve_families_path``); first of
    all, ZeRO-3 over ``data`` (``zero_axis_path``). ``parts`` without
    "collectives" runs those of (d)-(g) and ZeRO it names alone. Every
    check fails the phase."""
    import shutil
    import tempfile

    from repro_torch.launch import train

    out = four_cards(device, smi)
    if out is None:
        return None
    smi, dev = out["card"], torch.device(device).type
    t0 = time.perf_counter()
    if "collectives" not in parts:
        if "expert_axis" in parts:
            out.update(expert_axis_path(seed, device, dev))
        if "family_model_axis" in parts:
            out.update(family_model_axis_path(seed, device, dev))
        if "zero_axis" in parts:
            out.update(zero_axis_path(seed, device, dev))
        if "serve_model_axis" in parts:
            out.update(serve_model_axis_path(seed, device, dev))
        if "serve_families" in parts:
            out.update(serve_families_path(seed, device, dev))
        out["seconds"] = time.perf_counter() - t0
        return out
    if "zero_axis" in parts:      # first: its mistral-nemo-12b run is the heaviest
        out.update(zero_axis_path(seed, device, dev))
    coll = run_ranks("collectives", COLL_CARDS, {
        "device": dev, "seed": seed, "bytes": COLL_BYTES, "rows": COLL_ROWS,
        "chunks": list(COLL_CHUNKS), "agmm": [AGMM_TOKENS, AGMM_K, AGMM_N]})
    out["collectives_s"] = time.perf_counter() - t0
    for r in coll:
        for row in r["rows"]:
            what = f"rank {r['rank']} {row['collective']} {row['dtype']} n_chunks {row['n_chunks']}"
            if row["collective"] == "all_gather":
                check(row["byte_equal"], f"{what}: byte-equal to all_gather_into_tensor")
            else:
                check(row["within_bound"], f"{what}: within (A-1)·u·Σ|x| of the float64 sum "
                                           f"(max abs err {row['max_abs_err']})")
        for m in r["matmuls"]:
            check(m["within_bound"], f"rank {r['rank']} {m['name']}: within its bound "
                                     f"(share {m['max_share_of_bound']})")
    # each row: rank 0's checks, the slowest rank's times
    out["rows"] = []
    for i, row in enumerate(coll[0]["rows"]):
        out["rows"].append({**row, "ms": max(r["rows"][i]["ms"] for r in coll),
                            "nccl_ms": max(r["rows"][i]["nccl_ms"] for r in coll)})
        for key, ms in (("algbw_GBps", "ms"), ("busbw_GBps", "ms"),
                        ("nccl_algbw_GBps", "nccl_ms"), ("nccl_busbw_GBps", "nccl_ms")):
            out["rows"][-1][key] = row[key] * row[ms] / out["rows"][-1][ms]
    out["matmuls"] = []
    for i, m in enumerate(coll[0]["matmuls"]):
        out["matmuls"].append({**m, **{k: max(r["matmuls"][i][k] for r in coll)
                                       for k in ("ms", "monolithic_ms", "mm_only_ms",
                                                 "max_share_of_bound")}})
    print_collective_rows(out, smi)
    root = tempfile.mkdtemp(prefix="chip-smoke-train-dist-")
    try:
        cfg = {"device": dev, "seed": seed, "args": TRAIN_DIST_ARGS, "root": root,
               "steps": TRAIN_DIST_STEPS, "ckpt_step": TRAIN_DIST_CKPT}
        ranks = run_ranks("train_dist", COLL_CARDS, {**cfg, "mesh": TRAIN_DIST_MESH,
                                                     "elastic": False})
        elastic = run_ranks("train_dist", 2, {**cfg, "mesh": ELASTIC_MESH, "elastic": True,
                                              "microbatches": ELASTIC_MICROBATCHES})
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if dev == "cuda":
        torch.cuda.empty_cache()
    one = train.main(TRAIN_DIST_ARGS + ["--seed", str(seed), "--device", str(device),
                                        "--mesh", "1x1", "--steps", "1",
                                        "--microbatches", str(ONE_CARD_MICROBATCHES)])
    del one["params"]
    release(device)
    r0 = ranks[0]
    auto, chunked, resumed = r0["auto"]["losses"], r0["chunked"]["losses"], r0["resumed"]["losses"]

    def close(a, b):
        return len(a) == len(b) and all(abs(x - y) <= LOSS_RTOL * abs(y) for x, y in zip(a, b))

    for mode, losses in (("auto", auto), ("chunked", chunked)):
        check(len(losses) == TRAIN_DIST_STEPS and all(np.isfinite(losses))
              and losses[-1] < losses[0], f"{mode}: finite losses that fall: {losses}")
        check(all(r[mode]["losses"] == losses for r in ranks), f"{mode}: every rank's loss")
    check(close(chunked, auto), f"chunked losses {chunked} within {LOSS_RTOL} of auto's {auto}")
    check(close(auto[:1], one["losses"]) and close(chunked[:1], one["losses"]),
          f"step 1 on four cards {auto[0]} / {chunked[0]} within {LOSS_RTOL} of one card's "
          f"{one['losses'][0]}")
    tail = chunked[TRAIN_DIST_CKPT:]
    check(all(close(r["resumed"]["losses"], tail) for r in ranks),
          f"the resumed steps repeat the uninterrupted run's losses: {resumed} vs {tail}")
    check(all(close(e["elastic"]["losses"], tail) for e in elastic),
          f"the elastic resume on two ranks repeats them: {elastic[0]['elastic']['losses']} "
          f"vs {tail}")
    check(r0["saved_equal_restored"], "rank 0 restored the saved tree bit for bit")
    want = ckpt_launches(r0["manifest"])
    got = r0["save"]["launches"]
    check(got == {**got, **want["save"]} and got["checksum_copy_words"] == 0,
          f"rank 0's save launched exactly {want['save']}: {got}")
    for r in ranks + elastic:
        check(r["restored_equal_rank0"], f"rank {r['rank']} of {r['world']} restored rank 0's "
                                         "tree bit for bit")
        got = r["restore"]["launches"]
        check(got == {**got, **want["restore"]} and got["checksum_copy_words"] == 0,
              f"rank {r['rank']} of {r['world']}'s restore launched exactly "
              f"{want['restore']}: {got}")

    def median(xs):
        return sorted(xs)[len(xs) // 2]

    def step_sums(r, mode, key):
        calls = r[mode]["sync_s"][key]
        n = len(calls) // TRAIN_DIST_STEPS            # calls of ``key`` a step
        return [sum(calls[i * n:(i + 1) * n]) for i in range(TRAIN_DIST_STEPS)]

    per_step = {}
    for mode in ("auto", "chunked"):
        steady = [max(r[mode]["step_s"][i] for r in ranks) for i in range(1, TRAIN_DIST_STEPS)]
        # each step's seconds in each sync call, the slowest rank's; step 1 sets up
        # the subgroups' communicators, so the steady figure is the median of the rest
        sync_s = {k: [max(step_sums(r, mode, k)[i] for r in ranks)
                      for i in range(TRAIN_DIST_STEPS)] for k in r0[mode]["sync_s"]}
        per_step[mode] = {"step_ms": [1e3 * max(r[mode]["step_s"][i] for r in ranks)
                                      for i in range(TRAIN_DIST_STEPS)],
                          "steady_step_ms": 1e3 * median(steady),
                          "sync_ms_first_step": {k: 1e3 * v[0] for k, v in sync_s.items()},
                          "sync_ms_steady": {k: 1e3 * median(v[1:]) for k, v in sync_s.items()},
                          "sync_ms": {k: [1e3 * x for x in v] for k, v in sync_s.items()}}
    grad_bytes = sum(e["nbytes"] for k, e in r0["manifest"]["leaves"].items()
                     if k.startswith("params/"))
    out.update(train={
        "arch": "gemma-2b", "mesh": TRAIN_DIST_MESH, "losses": {"auto": auto, "chunked": chunked},
        "one_card_step1_loss": one["losses"][0], "resumed_losses": resumed,
        "elastic_losses": elastic[0]["elastic"]["losses"], "loss_rtol": LOSS_RTOL,
        "grad_norms": {"auto": r0["auto"]["grad_norms"], "chunked": r0["chunked"]["grad_norms"]},
        **per_step, "grad_bytes": grad_bytes,
        "ckpt_bytes": r0["save"]["bytes"], "save_s": r0["save"]["seconds"],
        "launches_save_rank0": r0["save"]["launches"],
        "restore_s": [r["restore"]["seconds"] for r in ranks],
        "launches_restore": [r["restore"]["launches"] for r in ranks],
        "elastic_restore_s": [e["restore"]["seconds"] for e in elastic],
        "elastic_launches_restore": [e["restore"]["launches"] for e in elastic],
        "expected_launches": want, "devices": [r["device"] for r in ranks],
        "wall_s": {"four": ranks[0]["wall_s"], "two": elastic[0]["wall_s"]}})
    out.update(model_axis_path(seed, device, dev, ranks, one, per_step))
    if "expert_axis" in parts:
        out.update(expert_axis_path(seed, device, dev))
    if "family_model_axis" in parts:
        out.update(family_model_axis_path(seed, device, dev, out["families"]))
    if "serve_model_axis" in parts:
        out.update(serve_model_axis_path(seed, device, dev))
    if "serve_families" in parts:
        out.update(serve_families_path(seed, device, dev))
    out["seconds"] = time.perf_counter() - t0
    return out


def manifest_layout(manifest: dict) -> dict:
    """A MANIFEST's leaves without their digests: names, shapes, dtypes,
    sizes, files and chunk plans."""
    return {k: ({f: e[f] for f in ("shape", "dtype", "nbytes", "file", "chunk_bytes")},
                [(c["offset"], c["length"]) for c in e["chunks"]])
            for k, e in manifest["leaves"].items()}


def model_axis_path(seed: int, device, dev: str, ranks: list, one: dict,
                    per_step: dict) -> dict:
    """The collectives phase's model-axis part, after the 2x2x1 training
    (its ranks' results ``ranks``, one card's step 1 ``one``, its step
    times ``per_step``): (a) every other family over pod x data
    (``family_dist_worker``), each held at step 1 to one card on the same
    sequences; (b) gemma-2b over 1x2x2 and 1x1x4 (``tp_dist_worker``), with a
    checkpoint on 1x2x2 resumed there and elastically on 1x1x2; (c)
    internvl2-2b on 1x1x4. Every check fails the phase."""
    import shutil
    import tempfile

    from repro_torch.launch import train

    def close(a, b):
        return len(a) == len(b) and all(abs(x - y) <= LOSS_RTOL * abs(y) for x, y in zip(a, b))

    def median(xs):
        return sorted(xs)[len(xs) // 2]

    t0 = time.perf_counter()
    r0 = ranks[0]
    release(device)
    fam = run_ranks("family_dist", COLL_CARDS, {
        "device": dev, "seed": seed, "steps": FAMILY_DIST_STEPS, "mesh": TRAIN_DIST_MESH,
        "runs": [a + FAMILY_DIST_COMMON for a in FAMILY_DIST_RUNS]}, MODEL_AXIS_TIMEOUT_S)
    families = []
    for i, args in enumerate(FAMILY_DIST_RUNS):
        runs = [r["runs"][i] for r in fam]
        arch, losses = runs[0]["arch"], runs[0]["losses"]
        first = train.main(args + FAMILY_DIST_COMMON + [
            "--seed", str(seed), "--device", str(device), "--mesh", "1x1", "--steps", "1",
            "--microbatches", str(ONE_CARD_MICROBATCHES)])["losses"]
        release(device)
        check(len(losses) == FAMILY_DIST_STEPS and all(np.isfinite(losses)),
              f"{arch} on {TRAIN_DIST_MESH}: finite losses {losses}")
        check(all(r["losses"] == losses for r in runs), f"{arch}: every rank's loss")
        check(close(losses[:1], first), f"{arch}: step 1 on four cards {losses[0]} within "
                                         f"{LOSS_RTOL} of one card's {first[0]}")
        families.append({"arch": arch, "args": args, "losses": losses, "one_card_step1": first[0],
                         "steady_step_ms": 1e3 * median([max(r["step_s"][s] for r in runs)
                                                         for s in range(1, FAMILY_DIST_STEPS)]),
                         "peak_bytes": [r["peak_bytes"] for r in runs]})
    root = tempfile.mkdtemp(prefix="chip-smoke-tp-")
    cfg = {"device": dev, "seed": seed, "args": TRAIN_DIST_ARGS, "steps": TRAIN_DIST_STEPS,
           "elastic": False}
    try:
        tp = {}
        for mesh in TP_MESHES:
            extra = ({"root": root, "ckpt_step": TRAIN_DIST_CKPT} if mesh == TP_CKPT_MESH
                     else {"also": [VLM_TP_ARGS], "also_steps": VLM_TP_STEPS})
            tp[mesh] = run_ranks("tp_dist", COLL_CARDS, {**cfg, "mesh": mesh, **extra},
                                 MODEL_AXIS_TIMEOUT_S)
        elastic = run_ranks("tp_dist", 2, {**cfg, "mesh": TP_ELASTIC_MESH, "elastic": True,
                                           "root": root, "microbatches": ONE_CARD_MICROBATCHES},
                            MODEL_AXIS_TIMEOUT_S)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    vlm_one = train.main(VLM_TP_ARGS + ["--seed", str(seed), "--device", str(device),
                                        "--mesh", "1x1", "--steps", "1"])["losses"]
    auto = r0["auto"]["losses"]
    meshes = {TRAIN_DIST_MESH: {
        "step_ms": per_step["auto"]["steady_step_ms"],
        "collective_ms": {"model": 0.0, "batch": per_step["auto"]["sync_ms_steady"]["world_mean"]},
        "peak_bytes": [r["auto"]["peak_bytes"] for r in ranks]}}
    for mesh, ranks in tp.items():
        t = ranks[0]["train"]
        losses = t["losses"]
        check(len(losses) == TRAIN_DIST_STEPS and all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"gemma-2b on {mesh}: finite losses that fall: {losses}")
        check(all(r["train"]["losses"] == losses for r in ranks), f"{mesh}: every rank's loss")
        check(close(losses[:1], one["losses"]) and close(losses[:1], auto[:1]),
              f"{mesh}: step 1 {losses[0]} within {LOSS_RTOL} of one card's {one['losses'][0]} "
              f"and {TRAIN_DIST_MESH}'s {auto[0]}")
        for r in ranks:
            check(r["f32"]["rel"] <= TP_F32_TOL,
                  f"{mesh} rank {r['rank']}: f32 logits within {TP_F32_TOL} of the largest of one "
                  f"card's ({r['f32']['max_abs_err']} of {r['f32']['max_logit']})")
            check(r["train"]["blocks_equal"], f"{mesh} rank {r['rank']}: every leaf "
                                              "bit-equal on the ranks that hold its block")
        coll = {k: [max(r["train"]["collective_ms"][k][s] for r in ranks)
                    for s in range(TRAIN_DIST_STEPS)] for k in ("model", "batch")}
        meshes[mesh] = {
            "losses": losses, "f32_rel": max(r["f32"]["rel"] for r in ranks),
            "step_ms": 1e3 * median([max(r["train"]["step_s"][s] for r in ranks)
                                     for s in range(1, TRAIN_DIST_STEPS)]),
            "collective_ms": {k: median(v[1:]) for k, v in coll.items()},
            "collective_ms_first_step": {k: v[0] for k, v in coll.items()},
            "peak_bytes": [r["train"]["peak_bytes"] for r in ranks]}
    ck_ranks = tp[TP_CKPT_MESH]
    c0 = ck_ranks[0]
    tail = c0["train"]["losses"][TRAIN_DIST_CKPT:]
    check(all(close(r["resumed"]["losses"], tail) and r["resumed"]["blocks_equal"]
              for r in ck_ranks),
          f"{TP_CKPT_MESH}: the resumed steps repeat the uninterrupted run's losses "
          f"{c0['resumed']['losses']} vs {tail}, every block bit-equal on its ranks")
    check(all(close(e["elastic"]["losses"], tail) for e in elastic),
          f"{TP_CKPT_MESH}'s root resumed on {TP_ELASTIC_MESH} repeats them: "
          f"{elastic[0]['elastic']['losses']} vs {tail}")
    check(manifest_layout(c0["manifest"]) == manifest_layout(r0["manifest"]),
          f"the {TP_CKPT_MESH} MANIFEST names the {TRAIN_DIST_MESH} run's leaves, shapes, dtypes "
          "and chunks")
    check(c0["saved_equal_restored"], f"{TP_CKPT_MESH}: rank 0 restored the whole saved tree "
                                      "bit for bit")
    want = ckpt_launches(c0["manifest"])
    got = c0["save"]["launches"]
    check(got == r0["save"]["launches"] and got == {**got, **want["save"]},
          f"{TP_CKPT_MESH}: rank 0's save launched exactly {want['save']} (as "
          f"{TRAIN_DIST_MESH}'s): {got}")
    for r in ck_ranks + elastic:
        check(r["restored_equal_rank0"], f"{r['mesh']} rank {r['rank']} restored rank 0's tree "
                                         "bit for bit")
        got = r["restore"]["launches"]
        check(got == {**got, **want["restore"]} and got["checksum_copy_words"] == 0,
              f"{r['mesh']} rank {r['rank']}'s restore launched exactly {want['restore']}: {got}")
    vlm = [r["also"][0] for r in tp[TP_VLM_MESH]]
    check(all(np.isfinite(vlm[0]["losses"])) and all(v["blocks_equal"] for v in vlm)
          and all(v["losses"] == vlm[0]["losses"] for v in vlm),
          f"internvl2-2b on {TP_VLM_MESH}: finite losses on every rank, every block bit-equal on its ranks")
    check(close(vlm[0]["losses"][:1], vlm_one),
          f"internvl2-2b on {TP_VLM_MESH}: step 1 {vlm[0]['losses'][0]} within {LOSS_RTOL} of "
          f"one card's {vlm_one[0]}")
    return {"families": families, "model_axis": {
        "arch": "gemma-2b", "meshes": meshes,
        "ckpt": {"mesh": TP_CKPT_MESH, "save_s": c0["save"]["seconds"],
                 "bytes": c0["save"]["bytes"], "launches_save_rank0": c0["save"]["launches"],
                 "launches_restore": [r["restore"]["launches"] for r in ck_ranks],
                 "restore_s": [r["restore"]["seconds"] for r in ck_ranks],
                 "elastic_restore_s": [e["restore"]["seconds"] for e in elastic],
                 "resumed": c0["resumed"]["losses"], "elastic": elastic[0]["elastic"]["losses"]},
        "vlm": {"mesh": TP_VLM_MESH, "losses": vlm[0]["losses"], "one_card_step1": vlm_one[0],
                "steady_step_ms": 1e3 * median([max(v["step_s"][s] for v in vlm)
                                                for s in range(1, VLM_TP_STEPS)]),
                "peak_bytes": [v["peak_bytes"] for v in vlm]},
        "seconds": time.perf_counter() - t0}}


def expert_axis_path(seed: int, device, dev: str) -> dict:
    """The collectives phase's expert-axis part: qwen3-moe-30b-a3b
    (``EP_ARGS``) over ``EP_MESHES`` with ``tp_dist_worker``, a checkpoint
    on ``EP_CKPT_MESH`` resumed there and on ``EP_ELASTIC_MESH``, step 1
    held to one card on the same 16 sequences (``ONE_CARD_MICROBATCHES``),
    with the assignments each run drops at step 1; then grok-1-314b
    (``GROK_EP_ARGS``) on ``GROK_EP_MESH``. Every check fails the phase."""
    import shutil
    import tempfile

    from repro_torch.launch import train

    def close(a, b):
        return len(a) == len(b) and all(abs(x - y) <= LOSS_RTOL * abs(y) for x, y in zip(a, b))

    def median(xs):
        return sorted(xs)[len(xs) // 2]

    t0 = time.perf_counter()
    release(device)
    root = tempfile.mkdtemp(prefix="chip-smoke-ep-")
    cfg = {"device": dev, "seed": seed, "args": EP_ARGS, "steps": EP_STEPS, "elastic": False}
    try:
        ep = {}
        for mesh in EP_MESHES:
            extra = {"root": root, "ckpt_step": EP_CKPT} if mesh == EP_CKPT_MESH else {}
            ep[mesh] = run_ranks("tp_dist", COLL_CARDS, {**cfg, "mesh": mesh, **extra},
                                 EXPERT_AXIS_TIMEOUT_S)
        elastic = run_ranks("tp_dist", 2, {**cfg, "mesh": EP_ELASTIC_MESH, "elastic": True,
                                           "root": root, "microbatches": EP_ELASTIC_MICROBATCHES},
                            EXPERT_AXIS_TIMEOUT_S)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    grok = run_ranks("tp_dist", COLL_CARDS, {
        "device": dev, "seed": seed, "args": GROK_EP_ARGS, "steps": GROK_EP_STEPS,
        "elastic": False, "mesh": GROK_EP_MESH, "peak_max": GROK_PEAK_MAX}, EXPERT_AXIS_TIMEOUT_S)
    one = train.main(EP_ARGS + ["--seed", str(seed), "--device", str(device), "--mesh", "1x1",
                                "--steps", "1", "--microbatches", str(ONE_CARD_MICROBATCHES)])
    del one["params"]
    one_dropped = step1_dropped(EP_ARGS, seed, train.parse_mesh("1x1", device), device,
                                ONE_CARD_MICROBATCHES)
    release(device)

    def runs(arch, mesh, ranks, steps, one_losses=None):
        t = ranks[0]["train"]
        losses = t["losses"]
        check(len(losses) == steps and all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"{arch} on {mesh}: finite losses that fall: {losses}")
        check(all(r["train"]["losses"] == losses for r in ranks),
              f"{arch} {mesh}: every rank's loss")
        if one_losses is not None:
            check(close(losses[:1], one_losses), f"{arch} {mesh}: step 1 {losses[0]} within "
                                                 f"{LOSS_RTOL} of one card's {one_losses[0]}")
        for r in ranks:
            f = r["f32"]
            check(f["flipped_share"] <= FLIP_SHARE_F32,
                  f"{arch} {mesh} rank {r['rank']}: the f32 forward routes as one card's: "
                  f"{f['flipped_share']:.3%} of tokens flipped > {FLIP_SHARE_F32:.0%}")
            check(f["rel_sum"] <= TP_F32_TOL,
                  f"{arch} {mesh} rank {r['rank']}: f32 logits within {TP_F32_TOL} of the largest "
                  f"sum of magnitudes behind a logit of one card's ({f['max_abs_err']} of "
                  f"{f['max_magnitude_sum']}; the largest logit {f['max_logit']})")
            check(r["train"]["blocks_equal"], f"{arch} {mesh} rank {r['rank']}: every leaf "
                                              "bit-equal on the ranks that hold its block")
        coll = {k: [max(r["train"]["collective_ms"][k][s] for r in ranks) for s in range(steps)]
                for k in ("model", "gather", "a2a", "batch")}
        return {"losses": losses, "global_batch": t["global_batch"],
                "f32_rel": max(r["f32"]["rel"] for r in ranks),
                "f32_rel_sum": max(r["f32"]["rel_sum"] for r in ranks),
                "f32_flipped_share": max(r["f32"]["flipped_share"] for r in ranks),
                "step_ms": 1e3 * median([max(r["train"]["step_s"][s] for r in ranks)
                                         for s in range(1, steps)]),
                "collective_ms": {k: median(v[1:]) for k, v in coll.items()},
                "collective_ms_first_step": {k: v[0] for k, v in coll.items()},
                "peak_bytes": [r["train"]["peak_bytes"] for r in ranks],
                "dropped_step1": sum(r["dropped"] for r in ranks)}

    meshes = {mesh: runs("qwen3-moe-30b-a3b", mesh, ranks, EP_STEPS, one["losses"])
              for mesh, ranks in ep.items()}
    ck_ranks = ep[EP_CKPT_MESH]
    c0 = ck_ranks[0]
    tail = c0["train"]["losses"][EP_CKPT:]
    check(all(close(r["resumed"]["losses"], tail) and r["resumed"]["blocks_equal"]
              for r in ck_ranks),
          f"{EP_CKPT_MESH}: the resumed steps repeat the uninterrupted run's losses "
          f"{c0['resumed']['losses']} vs {tail}, every block bit-equal on its ranks")
    check(all(close(e["elastic"]["losses"], tail) for e in elastic),
          f"{EP_CKPT_MESH}'s root resumed on {EP_ELASTIC_MESH} repeats them: "
          f"{elastic[0]['elastic']['losses']} vs {tail}")
    mcfg = smoke_model(EP_ARGS).cfg
    tp = int(EP_CKPT_MESH.split("x")[-1])
    for key in ("params", "opt/m", "opt/v"):
        for leaf in ("we_g", "we_i", "we_o"):
            shape = c0["manifest"]["leaves"][f"{key}/blocks/0/{leaf}"]["shape"]
            check(shape[:3] == [mcfg.n_layers, tp, mcfg.n_experts // tp],
                  f"{EP_CKPT_MESH}: the MANIFEST's {key}/{leaf} is laid out for {tp} "
                  f"columns: {shape}")
    check(c0["saved_equal_restored"], f"{EP_CKPT_MESH}: rank 0 restored the whole saved tree "
                                      "bit for bit")
    want = ckpt_launches(c0["manifest"])
    got = c0["save"]["launches"]
    check(got == {**got, **want["save"]} and got["checksum_copy_words"] == 0,
          f"{EP_CKPT_MESH}: rank 0's save launched exactly {want['save']}: {got}")
    for r in ck_ranks + elastic:
        check(r["restored_equal_rank0"], f"{r['mesh']} rank {r['rank']} restored rank 0's tree "
                                         "bit for bit")
        got = r["restore"]["launches"]
        check(got == {**got, **want["restore"]} and got["checksum_copy_words"] == 0,
              f"{r['mesh']} rank {r['rank']}'s restore launched exactly {want['restore']}: {got}")
    return {"expert_axis": {
        "arch": "qwen3-moe-30b-a3b", "meshes": meshes, "one_card_step1": one["losses"][0],
        "one_card_dropped_step1": one_dropped,
        "ckpt": {"mesh": EP_CKPT_MESH, "save_s": c0["save"]["seconds"],
                 "bytes": c0["save"]["bytes"], "launches_save_rank0": c0["save"]["launches"],
                 "launches_restore": [r["restore"]["launches"] for r in ck_ranks],
                 "launches_restore_elastic": [e["restore"]["launches"] for e in elastic],
                 "expected_launches": want,
                 "restore_s": [r["restore"]["seconds"] for r in ck_ranks],
                 "elastic_restore_s": [e["restore"]["seconds"] for e in elastic],
                 "resumed": c0["resumed"]["losses"], "elastic": elastic[0]["elastic"]["losses"]},
        "grok": {"mesh": GROK_EP_MESH, **runs("grok-1-314b", GROK_EP_MESH, grok, GROK_EP_STEPS)},
        "seconds": time.perf_counter() - t0}}


def family_model_axis_path(seed: int, device, dev: str, families=None) -> dict:
    """The collectives phase's part for the model axis of the ssm, hybrid and
    encdec families: FAMILY_DIST_RUNS' cuts of ``FAMILY_TP_ARCHS`` over
    each of ``FAMILY_TP_MESHES`` (``tp_dist_worker`` with ``runs``: one
    world a mesh trains the three in turn), recurrentgemma-2b's checkpoint
    saved on ``FAMILY_TP_CKPT_MESH`` and resumed there and on
    ``FAMILY_TP_ELASTIC_MESH``. Step 1 of each is held to one card's on the
    same 16 sequences (``ONE_CARD_MICROBATCHES``; taken from ``families``,
    the pod x data part's runs, where given). Every check fails the
    phase."""
    import shutil
    import tempfile

    from repro_torch.launch import train
    from repro_torch.launch.steps import _param_shapes

    def close(a, b):
        return len(a) == len(b) and all(abs(x - y) <= LOSS_RTOL * abs(y) for x, y in zip(a, b))

    def median(xs):
        return sorted(xs)[len(xs) // 2]

    t0 = time.perf_counter()
    release(device)
    runs = [a + FAMILY_DIST_COMMON for a in FAMILY_DIST_RUNS if _arg(a, "--arch") in FAMILY_TP_ARCHS]
    ck_args = next(a for a in runs if _arg(a, "--arch") == FAMILY_TP_CKPT_ARCH)
    root = tempfile.mkdtemp(prefix="chip-smoke-family-tp-")
    cfg = {"device": dev, "seed": seed, "runs": runs, "steps": FAMILY_TP_STEPS, "elastic": False}
    try:
        worlds = {}
        for mesh in FAMILY_TP_MESHES:
            extra = ({"root": root, "ckpt_step": FAMILY_TP_CKPT, "ckpt_arch": FAMILY_TP_CKPT_ARCH}
                     if mesh == FAMILY_TP_CKPT_MESH else {})
            worlds[mesh] = run_ranks("tp_dist", COLL_CARDS, {**cfg, "mesh": mesh, **extra},
                                     FAMILY_TP_TIMEOUT_S)
        elastic = run_ranks("tp_dist", 2, {
            "device": dev, "seed": seed, "args": ck_args, "steps": FAMILY_TP_STEPS,
            "elastic": True, "mesh": FAMILY_TP_ELASTIC_MESH, "root": root,
            "microbatches": ONE_CARD_MICROBATCHES}, FAMILY_TP_TIMEOUT_S)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    one = {f["arch"]: f["one_card_step1"] for f in families or []}
    for args in runs:
        arch = _arg(args, "--arch")
        if arch not in one:
            one[arch] = train.main(args + [
                "--seed", str(seed), "--device", str(device), "--mesh", "1x1", "--steps", "1",
                "--microbatches", str(ONE_CARD_MICROBATCHES)])["losses"][0]
            release(device)
    meshes = {}
    for mesh, ranks in worlds.items():
        meshes[mesh] = {}
        for i, args in enumerate(runs):
            arch = _arg(args, "--arch")
            tol = ENCDEC_TP_F32_TOL if smoke_model(args).cfg.family == "encdec" else TP_F32_TOL
            rr = [r["runs"][i] for r in ranks]
            t = rr[0]["train"]
            losses = t["losses"]
            check(len(losses) == FAMILY_TP_STEPS and all(np.isfinite(losses)),
                  f"{arch} on {mesh}: finite losses {losses}")
            check(all(r["train"]["losses"] == losses for r in rr), f"{arch} {mesh}: every rank's loss")
            check(close(losses[:1], [one[arch]]), f"{arch} {mesh}: step 1 {losses[0]} within "
                                                  f"{LOSS_RTOL} of one card's {one[arch]}")
            for rank, r in enumerate(rr):
                f = r["f32"]
                check(f["rel"] <= tol, f"{arch} {mesh} rank {rank}: f32 logits within {tol:.3g} of "
                                       f"the largest of one card's ({f['max_abs_err']} of "
                                       f"{f['max_logit']}; of the largest magnitude sum "
                                       f"{f['rel_sum']:.3g})")
                check(r["train"]["blocks_equal"], f"{arch} {mesh} rank {rank}: every leaf "
                                                 "bit-equal on the ranks that hold its block")
            coll = {k: [max(r["train"]["collective_ms"][k][s] for r in rr)
                        for s in range(FAMILY_TP_STEPS)] for k in ("model", "gather", "rs", "batch")}
            meshes[mesh][arch] = {
                "args": args, "losses": losses, "one_card_step1": one[arch],
                "global_batch": t["global_batch"], "f32_tol": tol,
                "f32_rel": max(r["f32"]["rel"] for r in rr),
                "f32_rel_sum": max(r["f32"]["rel_sum"] for r in rr),
                "step_ms": 1e3 * median([max(r["train"]["step_s"][s] for r in rr)
                                         for s in range(1, FAMILY_TP_STEPS)]),
                "collective_ms": {k: median(v[1:]) for k, v in coll.items()},
                "collective_ms_first_step": {k: v[0] for k, v in coll.items()},
                "peak_bytes": [r["train"]["peak_bytes"] for r in rr]}
    ck_ranks = worlds[FAMILY_TP_CKPT_MESH]
    i = runs.index(ck_args)
    c0 = ck_ranks[0]
    tail = c0["runs"][i]["train"]["losses"][FAMILY_TP_CKPT:]
    check(all(close(r["runs"][i]["resumed"]["losses"], tail) and r["runs"][i]["resumed"]["blocks_equal"]
              for r in ck_ranks),
          f"{FAMILY_TP_CKPT_ARCH} {FAMILY_TP_CKPT_MESH}: the resumed step repeats the uninterrupted "
          f"run's loss {c0['runs'][i]['resumed']['losses']} vs {tail}, every block bit-equal on its ranks")
    check(all(close(e["elastic"]["losses"], tail) for e in elastic),
          f"{FAMILY_TP_CKPT_MESH}'s root resumed on {FAMILY_TP_ELASTIC_MESH} repeats it: "
          f"{elastic[0]['elastic']['losses']} vs {tail}")
    # a one-device run's MANIFEST, leaf for leaf: the whole params and both moments
    whole = flat_tree(_param_shapes(smoke_model(ck_args)))
    want = {f"{tree}{k}": list(t.shape) for tree in ("params/", "opt/m/", "opt/v/")
            for k, t in whole.items()}
    got = {k: e["shape"] for k, e in c0["manifest"]["leaves"].items() if k != "opt/step"}
    check(got == want, f"{FAMILY_TP_CKPT_MESH}: the MANIFEST names a one-device run's leaves and "
                       "shapes")
    check(c0["saved_equal_restored"], f"{FAMILY_TP_CKPT_MESH}: rank 0 restored the whole saved "
                                      "tree bit for bit")
    want_launches = ckpt_launches(c0["manifest"])
    got = c0["save"]["launches"]
    check(got == {**got, **want_launches["save"]} and got["checksum_copy_words"] == 0,
          f"{FAMILY_TP_CKPT_MESH}: rank 0's save launched exactly {want_launches['save']}: {got}")
    for r in ck_ranks + elastic:
        check(r["restored_equal_rank0"], f"{r['mesh']} rank {r['rank']} restored rank 0's tree "
                                         "bit for bit")
        got = r["restore"]["launches"]
        check(got == {**got, **want_launches["restore"]} and got["checksum_copy_words"] == 0,
              f"{r['mesh']} rank {r['rank']}'s restore launched exactly "
              f"{want_launches['restore']}: {got}")
    return {"family_model_axis": {
        "meshes": meshes,
        "ckpt": {"arch": FAMILY_TP_CKPT_ARCH, "mesh": FAMILY_TP_CKPT_MESH, "step": FAMILY_TP_CKPT,
                 "save_s": c0["save"]["seconds"], "bytes": c0["save"]["bytes"],
                 "launches_save_rank0": c0["save"]["launches"],
                 "launches_restore": [r["restore"]["launches"] for r in ck_ranks],
                 "launches_restore_elastic": [e["restore"]["launches"] for e in elastic],
                 "expected_launches": want_launches,
                 "restore_s": [r["restore"]["seconds"] for r in ck_ranks],
                 "elastic_restore_s": [e["restore"]["seconds"] for e in elastic],
                 "uninterrupted": tail, "resumed": c0["runs"][i]["resumed"]["losses"],
                 "elastic": elastic[0]["elastic"]["losses"]},
        "wall_s": {mesh: ranks[0]["wall_s"] for mesh, ranks in worlds.items()}
        | {FAMILY_TP_ELASTIC_MESH: elastic[0]["wall_s"]},
        "seconds": time.perf_counter() - t0}}


def zero_state_bytes(args: list, mesh_spec: str) -> dict:
    """The bytes of ``args``' training state whole and on one rank of
    ``mesh_spec`` (pod x data x model), by arithmetic on the whole param
    shapes and the blocks ``param_specs`` cuts: the params and their
    gradients in the model's dtype, AdamW's m and v in f32."""
    from repro_torch.distributed.mesh import Mesh, cut_axes
    from repro_torch.launch.steps import _param_shapes

    model = smoke_model(args)
    shape = dict(zip(("pod", "data", "model"), (int(x) for x in mesh_spec.split("x"))))
    mesh = Mesh(shape, (torch.device("cpu"),))
    specs = flat_tree(model.param_specs(mesh))
    whole = rank = 0
    for key, t in flat_tree(_param_shapes(model)).items():
        n = int(np.prod(t.shape))
        whole += n
        rank += n // int(np.prod([shape[a] for a in cut_axes(mesh, specs[key])] or [1]))
    size = model.cfg.dtype.itemsize
    return {"whole": {"params": whole * size, "grads": whole * size, "moments": whole * 8},
            "rank": {"params": rank * size, "grads": rank * size, "moments": rank * 8}}


def one_card_step1(args: list, seed: int, device) -> dict:
    """Step 1 of ``args``' model on this card without AdamW's state: the
    whole params drawn as ``launch.train.main`` draws them on ``1x1``, the
    step's sequences in ``ONE_CARD_MICROBATCHES`` passes. The loss under
    ``no_grad`` (the passes' mean), its seconds and the card's peak; then
    the gradient of that mean, each pass's backward adding into the params'
    ``.grad`` in place, and its norm, with the card's allocator held to
    ``ZERO_PEAK_MAX``: where a pass would reserve more, the allocator
    raises, and the gradient does not fit (``grad_norm`` None; the peak
    reached is kept)."""
    from repro_torch.configs.registry import build_model
    from repro_torch.data.pipeline import DataConfig, _batch_at
    from repro_torch.launch import train
    from repro_torch.optim.adamw import tree_leaves

    cuda = torch.device(device).type == "cuda"
    model = train.with_layers(build_model(_arg(args, "--arch"), train.parse_mesh("1x1", str(device)),
                                          smoke="--smoke" in args), int(_arg(args, "--layers", 0)))
    gb = int(_arg(args, "--global-batch"))
    tok = torch.from_numpy(np.asarray(_batch_at(DataConfig(
        vocab=model.cfg.vocab, seq_len=int(_arg(args, "--seq-len")), global_batch=gb,
        seed=seed), 0))).to(device)
    parts = tok.chunk(ONE_CARD_MICROBATCHES, dim=0)
    reset_peak(device)
    params = model.init_params(seed, device)
    out = {"init_peak_bytes": peak_bytes(device), "passes": len(parts),
           "sequences_a_pass": gb // len(parts)}
    reset_peak(device)
    sync(device)
    t0 = time.perf_counter()
    with torch.no_grad():
        loss = sum(model.loss(params, {"tokens": p}).float() for p in parts) / len(parts)
    out.update(loss=float(loss), forward_s=time.perf_counter() - t0,
               forward_peak_bytes=peak_bytes(device))
    reset_peak(device)
    card = torch.cuda.current_device() if cuda and torch.device(device).index is None else device
    if cuda:
        torch.cuda.set_per_process_memory_fraction(
            ZERO_PEAK_MAX / torch.cuda.get_device_properties(card).total_memory, card)
    leaves = list(tree_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    t0 = time.perf_counter()
    try:
        with torch.enable_grad():
            for p in parts:
                (model.loss(params, {"tokens": p}) / len(parts)).backward()
        # sqrt of the sum of squares in f32, a layer of a stacked leaf at a time
        sq = sum(torch.sum(torch.square(s.float())) for t in leaves
                 for s in (t.grad.unbind(0) if t.grad.dim() > 2 else (t.grad,)))
        out["grad_norm"] = float(torch.sqrt(sq))
    except torch.OutOfMemoryError as e:
        out["grad_norm"] = None
        out["grad_refused"] = str(e).splitlines()[0]
    finally:
        out.update(grad_s=time.perf_counter() - t0, grad_peak_bytes=peak_bytes(device),
                   grad_reserved_bytes=torch.cuda.max_memory_reserved(device) if cuda else 0)
        del params, leaves
        if cuda:
            torch.cuda.set_per_process_memory_fraction(1.0, card)
        release(device)
    return out


def zero_axis_path(seed: int, device, dev: str) -> dict:
    """The collectives phase's ZeRO-3 part: gemma-2b (``TRAIN_DIST_ARGS``)
    over each of ``ZERO_MESHES`` with ``tp_dist_worker``, its roots saved on
    the meshes of ``ZERO_ELASTIC`` and resumed there and on the smaller
    mesh, step 1 held to one card's on the same 16 sequences, and in the
    ``ZERO_NEMO_MESH`` world mistral-nemo-12b at a cut depth
    (``ZERO_NEMO_CUT_ARGS``), whose losses and step 1's grad norm are held
    to a one-card run's; then mistral-nemo-12b at full depth
    (``ZERO_NEMO_ARGS``) on ``ZERO_NEMO_MESH``, its state bytes a rank
    held to the arithmetic (``zero_state_bytes``), its step 1 to one
    card's (``one_card_step1``) and its f32 forward to one card's. Every
    check fails the phase."""
    import shutil
    import tempfile

    from repro_torch.launch import train
    from repro_torch.launch.steps import _param_shapes

    def close(a, b):
        return len(a) == len(b) and all(abs(x - y) <= LOSS_RTOL * abs(y) for x, y in zip(a, b))

    def median(xs):
        return sorted(xs)[len(xs) // 2]

    def coll_ms(ranks, steps, kinds=("gather_data", "rs_data", "model", "gather", "rs", "batch")):
        c = {k: [max(r["train"]["collective_ms"][k][i] for r in ranks) for i in range(steps)]
             for k in kinds}
        return {k: median(v[1:]) for k, v in c.items()}, {k: v[0] for k, v in c.items()}

    t0 = time.perf_counter()
    release(device)
    cfg = {"device": dev, "seed": seed, "args": TRAIN_DIST_ARGS, "steps": TRAIN_DIST_STEPS,
           "elastic": False}
    roots = {mesh: tempfile.mkdtemp(prefix=f"chip-smoke-zero-{mesh}-") for mesh in ZERO_ELASTIC}
    try:
        gemma, elastic = {}, {}
        for mesh in ZERO_MESHES:
            extra = {"root": roots[mesh], "ckpt_step": TRAIN_DIST_CKPT} if mesh in roots else {}
            if mesh == ZERO_NEMO_MESH:      # the cut depth in this world: no start-up of its own
                extra.update(also=[ZERO_NEMO_CUT_ARGS], also_steps=ZERO_NEMO_CUT_STEPS)
            gemma[mesh] = run_ranks("tp_dist", COLL_CARDS, {**cfg, "mesh": mesh, **extra},
                                    ZERO_TIMEOUT_S)
        for mesh, (small, micro) in ZERO_ELASTIC.items():
            elastic[mesh] = run_ranks("tp_dist", 2, {**cfg, "mesh": small, "elastic": True,
                                                     "root": roots[mesh], "microbatches": micro},
                                      ZERO_TIMEOUT_S)
    finally:
        for root in roots.values():
            shutil.rmtree(root, ignore_errors=True)
    nemo = run_ranks("tp_dist", COLL_CARDS, {
        "device": dev, "seed": seed, "args": ZERO_NEMO_ARGS, "steps": ZERO_NEMO_STEPS,
        "elastic": False, "mesh": ZERO_NEMO_MESH, "peak_max": ZERO_PEAK_MAX,
        "halve": "microbatches"}, ZERO_TIMEOUT_S)
    one = train.main(TRAIN_DIST_ARGS + ["--seed", str(seed), "--device", str(device),
                                        "--mesh", "1x1", "--steps", "1",
                                        "--microbatches", str(ONE_CARD_MICROBATCHES)])
    del one["params"]
    release(device)
    reset_peak(device)
    cut_one = train.main(ZERO_NEMO_CUT_ARGS + [
        "--seed", str(seed), "--device", str(device), "--mesh", "1x1",
        "--steps", str(ZERO_NEMO_CUT_STEPS), "--microbatches", str(ONE_CARD_MICROBATCHES)])
    cut_one["peak_bytes"] = peak_bytes(device)
    cut_one["reserved_bytes"] = torch.cuda.max_memory_reserved(device) if dev == "cuda" else 0
    del cut_one["params"]
    release(device)
    nemo_one = one_card_step1(ZERO_NEMO_ARGS, seed, device)
    meshes = {}
    for mesh, ranks in gemma.items():
        t = ranks[0]["train"]
        losses = t["losses"]
        check(len(losses) == TRAIN_DIST_STEPS and all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"zero gemma-2b on {mesh}: finite losses that fall: {losses}")
        check(all(r["train"]["losses"] == losses for r in ranks), f"zero {mesh}: every rank's loss")
        check(close(losses[:1], one["losses"]), f"zero {mesh}: step 1 {losses[0]} within "
                                                f"{LOSS_RTOL} of one card's {one['losses'][0]}")
        for r in ranks:
            check(r["f32"]["rel"] <= TP_F32_TOL,
                  f"zero {mesh} rank {r['rank']}: f32 logits within {TP_F32_TOL} of the largest "
                  f"of one card's ({r['f32']['max_abs_err']} of {r['f32']['max_logit']})")
            check(r["train"]["blocks_equal"], f"zero {mesh} rank {r['rank']}: every leaf "
                                               "bit-equal on the ranks that hold its block")
        steady, first = coll_ms(ranks, TRAIN_DIST_STEPS)
        meshes[mesh] = {
            "losses": losses, "f32_rel": max(r["f32"]["rel"] for r in ranks),
            "step_ms": 1e3 * median([max(r["train"]["step_s"][i] for r in ranks)
                                     for i in range(1, TRAIN_DIST_STEPS)]),
            "collective_ms": steady, "collective_ms_first_step": first,
            "peak_bytes": [r["train"]["peak_bytes"] for r in ranks],
            "step_peak_bytes": [r["train"]["step_peak_bytes"] for r in ranks],
            "state_bytes": ranks[0]["train"]["state_bytes"]}
    whole = flat_tree(_param_shapes(smoke_model(TRAIN_DIST_ARGS)))
    one_device = {f"{tree}{k}": list(t.shape) for tree in ("params/", "opt/m/", "opt/v/")
                  for k, t in whole.items()}
    ckpts, layouts = {}, []
    for mesh, (small, _micro) in ZERO_ELASTIC.items():
        ranks, el = gemma[mesh], elastic[mesh]
        c0 = ranks[0]
        tail = c0["train"]["losses"][TRAIN_DIST_CKPT:]
        check(all(close(r["resumed"]["losses"], tail) and r["resumed"]["blocks_equal"]
                  for r in ranks),
              f"zero {mesh}: the resumed steps repeat the uninterrupted run's losses "
              f"{c0['resumed']['losses']} vs {tail}, every block bit-equal on its ranks")
        check(all(close(e["elastic"]["losses"], tail) for e in el),
              f"zero {mesh}'s root resumed on {small} repeats them: "
              f"{el[0]['elastic']['losses']} vs {tail}")
        got = {k: e["shape"] for k, e in c0["manifest"]["leaves"].items() if k != "opt/step"}
        check(got == one_device, f"zero {mesh}: the MANIFEST names a one-device run's leaves "
                                 "and shapes")
        layouts.append(manifest_layout(c0["manifest"]))
        check(c0["saved_equal_restored"], f"zero {mesh}: rank 0 restored the whole saved tree "
                                          "bit for bit")
        want = ckpt_launches(c0["manifest"])
        got = c0["save"]["launches"]
        check(got == {**got, **want["save"]} and got["checksum_copy_words"] == 0,
              f"zero {mesh}: rank 0's save launched exactly {want['save']}: {got}")
        for r in ranks + el:
            check(r["restored_equal_rank0"], f"zero {r['mesh']} rank {r['rank']} restored rank "
                                             "0's tree bit for bit")
            got = r["restore"]["launches"]
            check(got == {**got, **want["restore"]} and got["checksum_copy_words"] == 0,
                  f"zero {r['mesh']} rank {r['rank']}'s restore launched exactly "
                  f"{want['restore']}: {got}")
        ckpts[mesh] = {
            "elastic_mesh": small, "save_s": c0["save"]["seconds"], "bytes": c0["save"]["bytes"],
            "launches_save_rank0": c0["save"]["launches"], "expected_launches": want,
            "launches_restore": [r["restore"]["launches"] for r in ranks],
            "launches_restore_elastic": [e["restore"]["launches"] for e in el],
            "restore_s": [r["restore"]["seconds"] for r in ranks],
            "elastic_restore_s": [e["restore"]["seconds"] for e in el],
            "restored_bytes": [r["restored_bytes"] for r in ranks],
            "uninterrupted": tail, "resumed": c0["resumed"]["losses"],
            "elastic": el[0]["elastic"]["losses"]}
    check(all(x == layouts[0] for x in layouts), "zero: every root's MANIFEST has the same layout")
    def rel(x, y):
        return abs(x - y) / abs(y)

    t = nemo[0]["train"]
    losses = t["losses"]
    check(len(losses) == ZERO_NEMO_STEPS and all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"zero mistral-nemo-12b on {ZERO_NEMO_MESH}: finite losses that fall: {losses}")
    check(all(r["train"]["losses"] == losses for r in nemo), "zero mistral-nemo-12b: every "
                                                              "rank's loss")
    held = {"loss_rel": rel(losses[0], nemo_one["loss"]),
            "grad_norm_rel": (rel(t["grad_norms"][0], nemo_one["grad_norm"])
                              if nemo_one["grad_norm"] is not None else None)}
    check(held["loss_rel"] <= LOSS_RTOL,
          f"zero mistral-nemo-12b on {ZERO_NEMO_MESH}: step 1 {losses[0]} within {LOSS_RTOL} of "
          f"one card's forward {nemo_one['loss']} ({held['loss_rel']:.3g})")
    check(nemo_one["grad_norm"] is None or held["grad_norm_rel"] <= LOSS_RTOL,
          f"zero mistral-nemo-12b on {ZERO_NEMO_MESH}: step 1's grad norm {t['grad_norms'][0]} "
          f"within {LOSS_RTOL} of one card's {nemo_one['grad_norm']} ({held['grad_norm_rel']})")
    arith = zero_state_bytes(ZERO_NEMO_ARGS, ZERO_NEMO_MESH)
    for r in nemo:
        check(r["f32"]["rel"] <= TP_F32_TOL,
              f"zero mistral-nemo-12b rank {r['rank']}: f32 logits within {TP_F32_TOL} of the "
              f"largest of one card's ({r['f32']['max_abs_err']} of {r['f32']['max_logit']})")
        check(r["train"]["peak_bytes"] < CARD_BYTES,
              f"zero mistral-nemo-12b rank {r['rank']}: peak {r['train']['peak_bytes'] / 1e9:.2f} "
              f"GB under {CARD_BYTES / 1e9:.0f} GB")
        check(r["train"]["state_bytes"] == arith["rank"],
              f"zero mistral-nemo-12b rank {r['rank']}: state bytes {r['train']['state_bytes']} "
              f"equal the arithmetic {arith['rank']}")
        check(r["train"]["blocks_equal"], f"zero mistral-nemo-12b rank {r['rank']}: every leaf "
                                           "bit-equal on the ranks that hold its block")
    steady, first = coll_ms(nemo, ZERO_NEMO_STEPS)
    cut = [r["also"][0] for r in gemma[ZERO_NEMO_MESH]]
    c0 = cut[0]
    cut_held = {"losses_rel": [rel(x, y) for x, y in zip(c0["losses"], cut_one["losses"])],
                "grad_norm_rel": rel(c0["grad_norms"][0], cut_one["grad_norms"][0])}
    cut_name = f"zero mistral-nemo-12b at {_arg(ZERO_NEMO_CUT_ARGS, '--layers')} layers"
    check(len(c0["losses"]) == ZERO_NEMO_CUT_STEPS and all(np.isfinite(c0["losses"]))
          and all(c["losses"] == c0["losses"] and c["grad_norms"] == c0["grad_norms"]
                  for c in cut),
          f"{cut_name} on {ZERO_NEMO_MESH}: finite losses, every rank's loss and grad norm")
    check(close(c0["losses"], cut_one["losses"]),
          f"{cut_name} on {ZERO_NEMO_MESH}: losses {c0['losses']} within {LOSS_RTOL} of one "
          f"card's {cut_one['losses']} ({[f'{x:.3g}' for x in cut_held['losses_rel']]})")
    check(cut_held["grad_norm_rel"] <= LOSS_RTOL,
          f"{cut_name} on {ZERO_NEMO_MESH}: step 1's grad norm {c0['grad_norms'][0]} within "
          f"{LOSS_RTOL} of one card's {cut_one['grad_norms'][0]} ({cut_held['grad_norm_rel']:.3g})")
    check(all(c["blocks_equal"] for c in cut),
          f"{cut_name} on {ZERO_NEMO_MESH}: every leaf bit-equal on the ranks that hold its block")
    check(all(c["peak_bytes"] < CARD_BYTES for c in cut),
          f"{cut_name} on {ZERO_NEMO_MESH}: peaks {[c['peak_bytes'] for c in cut]} under "
          f"{CARD_BYTES / 1e9:.0f} GB")
    check(cut_one["peak_bytes"] <= ZERO_PEAK_MAX,
          f"{cut_name} on one card: the whole step's peak {cut_one['peak_bytes'] / 1e9:.2f} GB "
          f"under {ZERO_PEAK_MAX / 1e9:.0f} GB")
    cut_steady = {k: median([max(c["collective_ms"][k][i] for c in cut)
                             for i in range(1, ZERO_NEMO_CUT_STEPS)])
                  for k in ("gather_data", "rs_data", "model", "gather", "rs", "batch")}
    return {"zero_axis": {
        "gemma": {"arch": "gemma-2b", "meshes": meshes, "one_card_step1": one["losses"][0],
                  "ckpt": ckpts},
        "nemo": {"arch": "mistral-nemo-12b", "mesh": ZERO_NEMO_MESH, "losses": losses,
                 "layers": smoke_model(ZERO_NEMO_ARGS).cfg.n_layers,
                 "global_batch": t["global_batch"], "sequences_a_pass": t["sequences_a_pass"],
                 "f32_rel": max(r["f32"]["rel"] for r in nemo),
                 "step_ms": 1e3 * median([max(r["train"]["step_s"][i] for r in nemo)
                                          for i in range(1, ZERO_NEMO_STEPS)]),
                 "step_s": [max(r["train"]["step_s"][i] for r in nemo)
                            for i in range(ZERO_NEMO_STEPS)],
                 "collective_ms": steady, "collective_ms_first_step": first,
                 "peak_bytes": [r["train"]["peak_bytes"] for r in nemo],
                 "step_peak_bytes": [r["train"]["step_peak_bytes"] for r in nemo],
                 "init_peak_bytes": [r["train"]["init_peak_bytes"] for r in nemo],
                 "state_bytes": [r["train"]["state_bytes"] for r in nemo],
                 "state_arithmetic": arith, "wall_s": nemo[0]["wall_s"],
                 "grad_norms": t["grad_norms"], "one_card": nemo_one, "held": held},
        "nemo_cut": {"arch": "mistral-nemo-12b", "mesh": ZERO_NEMO_MESH,
                     "layers": smoke_model(ZERO_NEMO_CUT_ARGS).cfg.n_layers,
                     "losses": c0["losses"], "grad_norms": c0["grad_norms"],
                     "step_ms": 1e3 * median([max(c["step_s"][i] for c in cut)
                                              for i in range(1, ZERO_NEMO_CUT_STEPS)]),
                     "collective_ms": cut_steady, "peak_bytes": [c["peak_bytes"] for c in cut],
                     "one_card": {"losses": cut_one["losses"], "grad_norms": cut_one["grad_norms"],
                                  "step_ms": 1e3 * median(cut_one["step_seconds"][1:]),
                                  "peak_bytes": cut_one["peak_bytes"],
                                  "reserved_bytes": cut_one["reserved_bytes"]},
                     "held": cut_held},
        "seconds": time.perf_counter() - t0}}


def serve_model_axis_path(seed: int, device, dev: str) -> dict:
    """The collectives phase's serving part: ``serve_dist_worker`` on four
    ranks over ``SERVE_TP_RUNS``. Every check fails the phase: rank 0's
    save and each restore launch the chunk plan's digests, each rank's
    restored blocks equal rank 0's saved tree (gathered) and agree on the
    ranks that hold them, the f32 logits lie within ``TP_F32_TOL`` of one
    card's largest at ``TP_F32_LAYERS`` layer (as every four-card part
    holds its f32 forward) and within ``F32_TOL`` at the whole depth (as
    the one-card serve phase holds its f32 decode against its forward),
    and the teacher-forced prompt is echoed. The
    greedy tokens are counted against one card's, not bounded."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    release(device)
    root = tempfile.mkdtemp(prefix="chip-smoke-serve-tp-")
    try:
        ranks = run_ranks("serve_dist", COLL_CARDS, {
            "device": dev, "seed": seed, "args": SERVE_ARGS, "root": root,
            "batch": SERVE_BATCH, "prompt": SERVE_PROMPT, "gen": SERVE_GEN,
            "runs": [list(r) for r in SERVE_TP_RUNS],
            "long": {"args": LONG_ARGS, "T": LONG_T, "start": LONG_START, "steps": LONG_STEPS,
                     "tile": LONG_TILE, "meshes": list(LONG_TP_MESHES),
                     "deep_mesh": LONG_DEEP_MESH}},
            SERVE_TP_TIMEOUT_S)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    r0 = ranks[0]
    want = ckpt_launches(r0["manifest"])
    save = r0["runs"][0]["save"]
    check(save["launches"] == {**save["launches"], **want["save"]}
          and save["launches"]["checksum_copy_words"] == 0,
          f"serve_model_axis: rank 0's save launched exactly {want['save']}: {save['launches']}")
    one = r0["one_card"]
    deep, shallow = str(smoke_model(SERVE_ARGS).cfg.n_layers), str(TP_F32_LAYERS)
    tol = {shallow: TP_F32_TOL, deep: F32_TOL}
    runs = []
    for i, (mesh, stationary) in enumerate(SERVE_TP_RUNS):
        rs = [r["runs"][i] for r in ranks]
        a = rs[0]
        what = f"serve_model_axis {mesh} {'serve' if stationary else 'train'} specs"
        check(a["saved_equal_restored"], f"{what}: rank 0 restored the saved tree bit for bit")
        for r in ranks:
            x = r["runs"][i]
            check(x["restored_equal_rank0"] and x["blocks_equal"],
                  f"{what} rank {r['rank']}: its restored blocks are rank 0's saved tree's, "
                  "bit-equal on the ranks that hold them")
            got = x["restore"]["launches"]
            check(got == {**got, **want["restore"]} and got["checksum_copy_words"] == 0,
                  f"{what} rank {r['rank']}'s restore launched exactly {want['restore']}: {got}")
        for n, err in a["f32_max_abs_err"].items():
            check(err <= tol[n] * one[n]["max_logit"],
                  f"{what}: f32 logits at {n} layer(s) within {tol[n]} of one card's largest "
                  f"({err} of {one[n]['max_logit']})")
        check(a["prompt_equal"], f"{what}: the teacher-forced prompt echoed")
        steps = SERVE_PROMPT + SERVE_GEN - 1
        runs.append({
            "mesh": mesh, "weight_stationary": stationary,
            "ms_per_decode_step": max(x["ms_per_decode_step"] for x in rs),
            "collective_ms_per_step": {k: sum(max(x["collective_ms"][k][j] for x in rs)
                                              for j in range(steps)) / steps
                                       for k in ("model", "gather")},
            "collective_calls_per_step": a["collective_calls"],
            "cache_bytes": [x["cache_bytes"] for x in rs], "cache_bytes_whole": a["cache_bytes_whole"],
            "peak_bytes": [x["peak_bytes"] for x in rs],
            "restore_s": [x["restore"]["seconds"] for x in rs],
            "launches_restore": [x["restore"]["launches"] for x in rs],
            "f32_max_abs_err": a["f32_max_abs_err"],
            "f32_rel": {n: e / one[n]["max_logit"] for n, e in a["f32_max_abs_err"].items()},
            "greedy_agree": a["greedy_agree"], "greedy_tokens": a["greedy_tokens"],
            "first_divergence": a["first_divergence"]})
    return {"serve_model_axis": {
        "long": long_checks([r["long"] for r in ranks]),
        "arch": _arg(SERVE_ARGS, "--arch"), "layers": smoke_model(SERVE_ARGS).cfg.n_layers,
        "batch": SERVE_BATCH, "prompt": SERVE_PROMPT, "generated": SERVE_GEN,
        "one_card_ms_per_decode_step": one["ms_per_decode_step"],
        "one_card_f32": {n: one[n] for n in (deep, shallow)}, "f32_tolerance": tol,
        "save_s": save["seconds"], "bytes": save["bytes"],
        "launches_save_rank0": save["launches"], "expected_launches": want, "runs": runs,
        "wall_s": r0["wall_s"], "seconds": time.perf_counter() - t0}}


def long_checks(ranks: list) -> dict:
    """``long_ranks``' results held: on each mesh the time cut over
    ``data`` or ``pod`` as well as ``model`` and the f32 logits within
    ``TP_F32_TOL`` of one card's largest at 1 layer and ``F32_TOL`` at 2;
    at the whole depth, finite logits equal on every rank, each decoded
    position written once in every layer, and each rank's cache a quarter
    of the whole. Returns the part's numbers."""
    r0 = ranks[0]
    one, tol = r0["one_card"], {"1": TP_F32_TOL, "2": F32_TOL}
    runs = []
    for run in r0["runs"]:
        what = f"serve_model_axis gemma2-2b batch 1 on {run['mesh']}"
        check(set(run["time_axes"]) & {"data", "pod"} and "model" in run["time_axes"],
              f"{what}: the cache's time cut over model and data or pod ({run['time_axes']})")
        for n, err in run["f32_max_abs_err"].items():
            check(err <= tol[n] * one[n]["max_logit"],
                  f"{what}: f32 logits at {n} layer(s) within {tol[n]} of one card's largest "
                  f"({err} of {one[n]['max_logit']})")
        runs.append({**run, "f32_rel": {n: e / one[n]["max_logit"]
                                        for n, e in run["f32_max_abs_err"].items()}})
    ds = [r["deep"] for r in ranks]
    d = ds[0]
    what = f"serve_model_axis gemma2-2b {d['layers']} layers batch 1 on {d['mesh']}"
    check(all(x["finite"] and x["logits_sum"] == d["logits_sum"] for x in ds),
          f"{what}: finite logits, equal on every rank")
    check(sum(x["written"] for x in ds) == LONG_STEPS * d["layers"],
          f"{what}: each decoded position written once in every layer "
          f"({[x['written'] for x in ds]})")
    check(all(4 * x["cache_bytes"] == d["cache_bytes_whole"] for x in ds),
          f"{what}: each card holds a quarter of the cache ({d['cache_bytes']} of "
          f"{d['cache_bytes_whole']})")
    kinds = [k for k, v in d["collective_calls"].items() if v]
    return {"positions": LONG_T, "start": LONG_START, "steps": LONG_STEPS,
            "tolerance": tol, "one_card": one, "runs": runs,
            "deep": {"mesh": d["mesh"], "layers": d["layers"], "time_axes": d["time_axes"],
                     "dtype": d["dtype"],
                     "ms_per_decode_step": max(x["ms_per_decode_step"] for x in ds),
                     "cache_bytes": [x["cache_bytes"] for x in ds],
                     "cache_bytes_whole": d["cache_bytes_whole"],
                     "peak_bytes": [x["peak_bytes"] for x in ds],
                     "collective_ms_per_step": {
                         k: sum(max(x["collective_ms"][k][j] for x in ds)
                                for j in range(LONG_STEPS)) / LONG_STEPS for k in kinds},
                     "collective_calls_per_step": {k: d["collective_calls"][k] for k in kinds}}}


def print_serve_long(m: dict, smi: str) -> None:
    """The batch-1 long-cache lines of the serving part."""
    for r in m["runs"]:
        f32 = ", ".join(f"{rel:.3g} of one card's largest at {n} layer(s) (bound "
                        f"{m['tolerance'][n]:.3g})" for n, rel in r["f32_rel"].items())
        print(f"collectives serve_model_axis gemma2-2b batch 1 on {r['mesh']} (time over "
              f"{'x'.join(r['time_axes'])}), serve specs, {m['steps']} steps from position "
              f"{m['start']} of {m['positions']}: f32 logits within {f32} [{smi}]")
    d = m["deep"]
    c, n = d["collective_ms_per_step"], d["collective_calls_per_step"]
    coll = ", ".join(f"{k} {c[k]:.3f} ({n[k]} calls)" for k in c)
    print(f"collectives serve_model_axis gemma2-2b {d['layers']} layers batch 1 on {d['mesh']} "
          f"(time over {'x'.join(d['time_axes'])}), serve specs, {d['dtype']}: "
          f"{d['ms_per_decode_step']:.2f} ms a decode step; ms a step: {coll}; cache "
          f"{d['cache_bytes'][0] / 1e9:.3f} GB a card of {d['cache_bytes_whole'] / 1e9:.3f}; "
          f"peak GB a card {[round(b / 1e9, 2) for b in d['peak_bytes']]} [{smi}]")


def print_serve_model_axis(m: dict, smi: str) -> None:
    """The serving part's lines."""
    for r in m["runs"]:
        c = r["collective_ms_per_step"]
        n = r["collective_calls_per_step"]
        f32 = ", ".join(
            f"{rel:.3g} of one card's largest at {d} layer(s) (bound {m['f32_tolerance'][d]:.3g}; "
            f"one card's decode vs forward {m['one_card_f32'][d]['decode_vs_forward'] / m['one_card_f32'][d]['max_logit']:.3g})"
            for d, rel in r["f32_rel"].items())
        print(f"collectives serve_model_axis {m['arch']} {m['layers']} layers on {r['mesh']}, "
              f"{'serve' if r['weight_stationary'] else 'train'} specs, batch {m['batch']}, "
              f"{m['prompt']}-token prompt + {m['generated']}: {r['ms_per_decode_step']:.2f} ms a "
              f"decode step (one card {m['one_card_ms_per_decode_step']:.2f}); ms a step: model "
              f"all-reduce {c['model']:.3f} ({n['model']} calls), all-gather {c['gather']:.3f} "
              f"({n['gather']} calls); cache {r['cache_bytes'][0] / 1e6:.3f} MB a card of "
              f"{r['cache_bytes_whole'] / 1e6:.3f}; peak GB a card "
              f"{[round(b / 1e9, 2) for b in r['peak_bytes']]}; f32 logits within "
              f"{f32}; greedy tokens equal to one card's "
              f"{r['greedy_agree']} of {r['greedy_tokens']} (first divergence "
              f"{r['first_divergence']}); restore {', '.join(f'{x:.2f}' for x in r['restore_s'])} "
              f"s (launches {r['launches_restore'][0]} each) [{smi}]")
    print_serve_long(m["long"], smi)
    print(f"collectives serve_model_axis checkpoint: {m['bytes'] / 1e9:.2f} GB of params saved by "
          f"rank 0 in {m['save_s']:.2f} s (launches {m['launches_save_rank0']}); world "
          f"{m['wall_s']:.1f} s; part {m['seconds']:.1f} s [{smi}]")
    sys.stdout.flush()


def serve_families_path(seed: int, device, dev: str) -> dict:
    """The collectives phase's part that serves the moe, ssm, hybrid and
    encdec families over the model axis: ``serve_families_worker`` on four
    ranks over ``SERVE_FAMILY_RUNS``, at ``SERVE_BATCH`` and at batch 1.
    Every check fails the phase: rank 0's save and each restore launch the
    chunk plan's digests, each rank's restored blocks equal rank 0's saved
    tree (gathered) and agree on the ranks that hold them, the f32 logits
    lie within ``TP_F32_TOL`` of one card's largest at ``TP_F32_LAYERS``
    layer and within ``F32_TOL`` at the family's depth (whisper within
    ``ENCDEC_TP_F32_TOL``), a MoE's steps whose routing flipped left out
    and counted, the teacher-forced prompt is echoed, and at batch 1 the
    cache's time is cut over ``data`` too where it has one. The greedy
    tokens are counted against one card's, not bounded."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    release(device)
    root = tempfile.mkdtemp(prefix="chip-smoke-serve-families-")
    try:
        ranks = run_ranks("serve_families", COLL_CARDS, {
            "device": dev, "seed": seed, "root": root, "batch": SERVE_BATCH,
            "prompt": SERVE_PROMPT, "gen": SERVE_GEN, "b1_prompt": SERVE_B1_PROMPT,
            "b1_gen": SERVE_B1_GEN,
            "families": [[list(a), list(m), list(m1)] for a, m, m1 in SERVE_FAMILY_RUNS]},
            SERVE_FAMILIES_TIMEOUT_S)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    r0 = ranks[0]
    fams = []
    for i, (_args, meshes, b1_meshes) in enumerate(SERVE_FAMILY_RUNS):
        f0 = r0["families"][i]
        want = ckpt_launches(f0["manifest"])
        first = (f0["runs"] or f0["b1_runs"])[0]
        save = first["save"]
        check(save["launches"] == {**save["launches"], **want["save"]}
              and save["launches"]["checksum_copy_words"] == 0,
              f"serve_families {f0['arch']}: rank 0's save launched exactly {want['save']}: "
              f"{save['launches']}")
        tol = f0["f32_tolerance"]
        fam = {"arch": f0["arch"], "layers": f0["layers"], "f32_tolerance": tol,
               "save_s": save["seconds"], "bytes": save["bytes"],
               "launches_save_rank0": save["launches"], "expected_launches": want}
        for key, B, Lp, gen, where in (("", SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, meshes),
                                       ("b1_", 1, SERVE_B1_PROMPT, SERVE_B1_GEN, b1_meshes)):
            steps = Lp + gen - 1
            runs = []
            for j, mesh in enumerate(where):
                one = f0[f"{key}one_card"]
                rs = [r["families"][i][f"{key}runs"][j] for r in ranks]
                a = rs[0]
                what = f"serve_families {f0['arch']} {f0['layers']} layers on {mesh}, batch {B}"
                check(a["saved_equal_restored"],
                      f"{what}: rank 0 restored the saved tree bit for bit")
                for r, x in zip(ranks, rs):
                    check(x["restored_equal_rank0"] and x["blocks_equal"],
                          f"{what} rank {r['rank']}: its restored blocks are rank 0's saved "
                          "tree's, bit-equal on the ranks that hold them")
                    got = x["restore"]["launches"]
                    check(got == {**got, **want["restore"]} and got["checksum_copy_words"] == 0,
                          f"{what} rank {r['rank']}'s restore launched exactly "
                          f"{want['restore']}: {got}")
                for n, err in a["f32_max_abs_err"].items():
                    check(err <= tol[n] * one[n]["max_logit"],
                          f"{what}: f32 logits at {n} layer(s) within {tol[n]} of one card's "
                          f"largest ({err} of {one[n]['max_logit']}; route flips "
                          f"{a['route_flips']})")
                check(a["prompt_equal"], f"{what}: the teacher-forced prompt echoed")
                if B == 1 and f0["arch"] != "mamba2-370m":
                    check("data" in a["time_axes"],
                          f"{what}: the cache's time cut over data ({a['time_axes']})")
                kinds = [k for k in ("model", "gather", "a2a", "gather_data")
                         if a["collective_calls"][k]]
                runs.append({
                    "mesh": mesh, "batch": B, "prompt": Lp, "generated": gen,
                    "time_axes": a["time_axes"],
                    "ms_per_decode_step": max(x["ms_per_decode_step"] for x in rs),
                    "one_card_ms_per_decode_step": one["ms_per_decode_step"],
                    "prefill_cross_ms": (max(x["prefill_cross_ms"] for x in rs)
                                         if a["prefill_cross_ms"] is not None else None),
                    "one_card_prefill_cross_ms": one["prefill_cross_ms"],
                    "collective_ms_per_step": {k: sum(max(x["collective_ms"][k][s] for x in rs)
                                                      for s in range(steps)) / steps
                                               for k in kinds},
                    "collective_calls_per_step": {k: a["collective_calls"][k] for k in kinds},
                    "cache_bytes": [x["cache_bytes"] for x in rs],
                    "cache_bytes_whole": a["cache_bytes_whole"],
                    "peak_bytes": [x["peak_bytes"] for x in rs],
                    "restore_s": [x["restore"]["seconds"] for x in rs],
                    "launches_restore": [x["restore"]["launches"] for x in rs],
                    "f32_max_abs_err": a["f32_max_abs_err"],
                    "f32_rel": {n: e / one[n]["max_logit"]
                                for n, e in a["f32_max_abs_err"].items()},
                    "route_flips": a["route_flips"],
                    "greedy_agree": a["greedy_agree"], "greedy_tokens": a["greedy_tokens"]})
            fam[f"{key}runs"] = runs
        fams.append(fam)
    return {"serve_families": {
        "batch": SERVE_BATCH, "prompt": SERVE_PROMPT, "generated": SERVE_GEN,
        "families": fams, "wall_s": r0["wall_s"], "seconds": time.perf_counter() - t0}}


def print_serve_families(m: dict, smi: str) -> None:
    """The families' serving part's lines."""
    for f in m["families"]:
        for r in f["runs"] + f["b1_runs"]:
            c, n = r["collective_ms_per_step"], r["collective_calls_per_step"]
            coll = ", ".join(f"{k} {c[k]:.3f} ({n[k]} calls)" for k in c)
            pre = ("" if r["prefill_cross_ms"] is None else
                   f"; prefill_cross {r['prefill_cross_ms']:.2f} ms "
                   f"(one card {r['one_card_prefill_cross_ms']:.2f})")
            f32 = ", ".join(f"{rel:.3g} of one card's largest at {d} layer(s) (bound "
                            f"{f['f32_tolerance'][d]:.3g})" for d, rel in r["f32_rel"].items())
            flips = f"; route flips {r['route_flips']}" if r["route_flips"] else ""
            cut = "" if r["batch"] != 1 else (
                f" (time over {'x'.join(r['time_axes'])})" if r["time_axes"] else " (no time dim)")
            print(f"collectives serve_families {f['arch']} {f['layers']} layers on {r['mesh']}"
                  f"{cut}, batch {r['batch']}, {r['prompt']}-token prompt + {r['generated']}: "
                  f"{r['ms_per_decode_step']:.2f} ms a decode step (one card "
                  f"{r['one_card_ms_per_decode_step']:.2f}){pre}; ms a step: {coll}; cache "
                  f"{r['cache_bytes'][0] / 1e6:.3f} MB a card of "
                  f"{r['cache_bytes_whole'] / 1e6:.3f}; peak GB a card "
                  f"{[round(b / 1e9, 2) for b in r['peak_bytes']]}; f32 logits within {f32}"
                  f"{flips}; greedy tokens equal to one card's {r['greedy_agree']} of "
                  f"{r['greedy_tokens']}; restore {', '.join(f'{x:.2f}' for x in r['restore_s'])}"
                  f" s (launches {r['launches_restore'][0]} each) [{smi}]")
        print(f"collectives serve_families {f['arch']} checkpoint: {f['bytes'] / 1e9:.2f} GB of "
              f"params saved by rank 0 in {f['save_s']:.2f} s (launches "
              f"{f['launches_save_rank0']}) [{smi}]")
    print(f"collectives serve_families: world {m['wall_s']:.1f} s; part {m['seconds']:.1f} s "
          f"[{smi}]")
    sys.stdout.flush()


def print_zero_axis(m: dict, smi: str) -> None:
    """The ZeRO part's lines."""
    def gb(xs):
        return [round(b / 1e9, 2) for b in xs]

    def ms(c):
        return (f"ZeRO all-gather {c['gather_data']:.2f}, reduce-scatter {c['rs_data']:.2f} over "
                f"data; all-reduce of the model axis and the clip norm {c['model']:.2f}, model "
                f"all-gather {c['gather']:.2f}, reduce-scatter {c['rs']:.2f}; batch axes "
                f"{c['batch']:.2f}")

    g = m["gemma"]
    for mesh, r in g["meshes"].items():
        sb = r["state_bytes"]
        print(f"collectives zero_axis {g['arch']} 2 layers on {mesh}: {r['step_ms']:.1f} ms/step; "
              f"ms a step: {ms(r['collective_ms'])}; peak GB a card {gb(r['peak_bytes'])} "
              f"(steps {gb(r['step_peak_bytes'])}); state GB a rank: params "
              f"{sb['params'] / 1e9:.3f}, grads {sb['grads'] / 1e9:.3f}, moments "
              f"{sb['moments'] / 1e9:.3f}; losses {[round(x, 4) for x in r['losses']]}, step 1 on "
              f"one card {g['one_card_step1']:.6f}; f32 logits within {r['f32_rel']:.3g} of one "
              f"card's [{smi}]")
    for mesh, c in g["ckpt"].items():
        print(f"collectives zero_axis checkpoint on {mesh}: {c['bytes'] / 1e9:.2f} GB, every leaf "
              f"gathered over pod 0 and saved by rank 0 in {c['save_s']:.2f} s (launches "
              f"{c['launches_save_rank0']}), restored leaf by leaf into each rank's blocks "
              f"({gb(c['restored_bytes'])} GB a rank) in "
              f"{', '.join(f'{x:.2f}' for x in c['restore_s'])} s (launches "
              f"{c['launches_restore'][0]} each), on {c['elastic_mesh']} in "
              f"{', '.join(f'{x:.2f}' for x in c['elastic_restore_s'])} s; uninterrupted "
              f"{c['uninterrupted']}, resumed {c['resumed']}, elastic {c['elastic']} [{smi}]")
    n = m["nemo"]
    a = n["state_arithmetic"]
    sb = n["state_bytes"][0]
    print(f"collectives zero_axis {n['arch']} {n['layers']} layers on {n['mesh']}, {n['global_batch']} "
          f"sequences a step, {n['sequences_a_pass']} a card a pass: {n['step_ms']:.1f} ms/step "
          f"(steps {[round(x, 2) for x in n['step_s']]} s); ms a step: {ms(n['collective_ms'])}; "
          f"peak GB a card {gb(n['peak_bytes'])} (steps {gb(n['step_peak_bytes'])}, init "
          f"{gb(n['init_peak_bytes'])}); state GB a rank: params {sb['params'] / 1e9:.2f}, grads "
          f"{sb['grads'] / 1e9:.2f}, moments {sb['moments'] / 1e9:.2f}, "
          f"{sum(sb.values()) / 1e9:.2f} in all against {sum(a['whole'].values()) / 1e9:.2f} "
          f"whole; losses {[round(x, 6) for x in n['losses']]}, grad norms "
          f"{[f'{x:.6g}' for x in n['grad_norms']]}; f32 logits of one layer within "
          f"{n['f32_rel']:.3g} of one card's (bound {TP_F32_TOL:g}); world {n['wall_s']:.1f} s "
          f"[{smi}]")
    o, h = n["one_card"], n["held"]
    grad = (f"grad norm {o['grad_norm']:.6g} against {n['grad_norms'][0]:.6g} on {n['mesh']}, "
            f"{h['grad_norm_rel']:.3g} apart (bound {LOSS_RTOL:g})" if o["grad_norm"] is not None
            else f"gradient pass does not fit under {ZERO_PEAK_MAX / 1e9:.0f} GB ({o['grad_refused']})")
    print(f"collectives zero_axis {n['arch']} {n['layers']} layers on one card, step 1 without "
          f"AdamW's state, {o['passes']} passes of {o['sequences_a_pass']} sequences: forward loss "
          f"{o['loss']:.6f} against {n['losses'][0]:.6f} on {n['mesh']}, {h['loss_rel']:.3g} apart "
          f"(bound {LOSS_RTOL:g}), {o['forward_s']:.2f} s, peak {o['forward_peak_bytes'] / 1e9:.2f} "
          f"GB (init {o['init_peak_bytes'] / 1e9:.2f}); {grad}; gradient pass "
          f"{o['grad_s']:.2f} s, peak {o['grad_peak_bytes'] / 1e9:.2f} GB allocated, "
          f"{o['grad_reserved_bytes'] / 1e9:.2f} reserved [{smi}]")
    c, o, h = m["nemo_cut"], m["nemo_cut"]["one_card"], m["nemo_cut"]["held"]
    print(f"collectives zero_axis {c['arch']} {c['layers']} layers on {c['mesh']} (in gemma-2b's "
          f"world), 16 sequences a step: {c['step_ms']:.1f} ms/step; ms a step: "
          f"{ms(c['collective_ms'])}; peak GB a card {gb(c['peak_bytes'])}; losses "
          f"{[round(x, 6) for x in c['losses']]} against one card's "
          f"{[round(x, 6) for x in o['losses']]}, {[f'{x:.3g}' for x in h['losses_rel']]} apart; "
          f"step 1's grad norm {c['grad_norms'][0]:.6g} against one card's "
          f"{o['grad_norms'][0]:.6g}, {h['grad_norm_rel']:.3g} apart (bound {LOSS_RTOL:g}); one "
          f"card {o['step_ms']:.1f} ms/step, peak {o['peak_bytes'] / 1e9:.2f} GB (bound "
          f"{ZERO_PEAK_MAX / 1e9:.0f}), {o['reserved_bytes'] / 1e9:.2f} reserved [{smi}]")
    print(f"collectives zero_axis part {m['seconds']:.1f} s [{smi}]")
    sys.stdout.flush()


def print_family_model_axis(m: dict, smi: str) -> None:
    """The family part's lines."""
    for mesh, archs in m["meshes"].items():
        for arch, r in archs.items():
            c = r["collective_ms"]
            print(f"collectives family_model_axis {arch} ({' '.join(r['args'][2:6])}) on {mesh}, "
                  f"{r['global_batch']} sequences a step: {r['step_ms']:.1f} ms/step; ms a step: "
                  f"model all-reduce {c['model']:.2f}, all-gather {c['gather']:.2f}, "
                  f"reduce-scatter {c['rs']:.2f}, batch axes {c['batch']:.2f}; peak GB a card "
                  f"{[round(b / 1e9, 2) for b in r['peak_bytes']]}; losses "
                  f"{[round(x, 4) for x in r['losses']]}, step 1 on one card "
                  f"{r['one_card_step1']:.6f}; f32 logits within {r['f32_rel']:.3g} of the largest "
                  f"of one card's ({r['f32_rel_sum']:.3g} of the largest magnitude sum; bound "
                  f"{r['f32_tol']:.3g}) [{smi}]")
    c = m["ckpt"]
    print(f"collectives family_model_axis checkpoint {c['arch']} on {c['mesh']} at step {c['step']}: "
          f"{c['bytes'] / 1e9:.2f} GB, the whole tree gathered and saved by rank 0 in "
          f"{c['save_s']:.2f} s (launches {c['launches_save_rank0']}), restored on each rank in "
          f"{', '.join(f'{x:.2f}' for x in c['restore_s'])} s (launches "
          f"{c['launches_restore'][0]} each), on {FAMILY_TP_ELASTIC_MESH} in "
          f"{', '.join(f'{x:.2f}' for x in c['elastic_restore_s'])} s; uninterrupted "
          f"{c['uninterrupted']}, resumed {c['resumed']}, elastic {c['elastic']}; part "
          f"{m['seconds']:.1f} s [{smi}]")
    sys.stdout.flush()


def print_expert_axis(m: dict, smi: str) -> None:
    """The expert-axis part's lines."""
    def row(arch, layers, mesh, r, one=None):
        c = r["collective_ms"]
        ref = f" (one card {one[0]:.6f}, dropped {one[1]})" if one else ""
        print(f"collectives expert_axis {arch} {layers} on {mesh}, {r['global_batch']} sequences "
              f"a step: {r['step_ms']:.1f} ms/step; ms a step: all-to-all {c['a2a']:.2f}, model "
              f"all-reduce {c['model']:.2f}, all-gather {c['gather']:.2f}, batch axes "
              f"{c['batch']:.2f}; peak GB a card "
              f"{[round(b / 1e9, 2) for b in r['peak_bytes']]}; losses "
              f"{[round(x, 4) for x in r['losses']]}, dropped at step 1 {r['dropped_step1']}{ref}; "
              f"f32 logits within {r['f32_rel_sum']:.3g} of the largest magnitude sum of one "
              f"card's ({r['f32_rel']:.3g} of the largest logit), "
              f"{100 * r['f32_flipped_share']:.2f}% flipped [{smi}]")

    for mesh, r in m["meshes"].items():
        row(m["arch"], f"{smoke_model(EP_ARGS).cfg.n_layers} layer(s)", mesh, r,
            (m["one_card_step1"], m["one_card_dropped_step1"]))
    c = m["ckpt"]
    print(f"collectives expert_axis checkpoint on {c['mesh']}: {c['bytes'] / 1e9:.2f} GB, the "
          f"whole tree gathered and saved by rank 0 in {c['save_s']:.2f} s (launches "
          f"{c['launches_save_rank0']}), restored on each rank in "
          f"{', '.join(f'{x:.2f}' for x in c['restore_s'])} s (launches "
          f"{c['launches_restore'][0]} each), on {EP_ELASTIC_MESH} in "
          f"{', '.join(f'{x:.2f}' for x in c['elastic_restore_s'])} s; resumed {c['resumed']}, "
          f"elastic {c['elastic']} [{smi}]")
    row("grok-1-314b", "1 layer", m["grok"]["mesh"], m["grok"])
    sys.stdout.flush()


PHASES = ("card", "collectives")    # every phase on one card; the four-card phase


def print_collective_rows(coll: dict, smi: str) -> None:
    """The collectives' world's lines: one a collective x dtype x n_chunks,
    one a collective matmul."""
    for r in coll["rows"]:
        held = ("byte-equal" if r["collective"] == "all_gather"
                else f"max abs err {r['max_abs_err']:.3g} (NCCL {r['nccl_max_abs_err']:.3g})")
        print(f"collectives {r['collective']} {r['dtype']} {r['rank_bytes'] / MiB:.0f} MiB a rank "
              f"n_chunks {r['n_chunks']}{' (default)' if r['n_chunks'] == r['default_n_chunks'] else ''}: "
              f"chunked {r['ms']:.3f} ms, algbw {r['algbw_GBps']:.1f} GB/s, busbw "
              f"{r['busbw_GBps']:.1f} GB/s; NCCL {r['nccl_ms']:.3f} ms, algbw "
              f"{r['nccl_algbw_GBps']:.1f} GB/s, busbw {r['nccl_busbw_GBps']:.1f} GB/s; {held} "
              f"[{smi}]")
    for m in coll["matmuls"]:
        print(f"collectives {m['name']} {m['shape']} bf16: {m['ms']:.3f} ms, monolithic "
              f"{m['monolithic_ms']:.3f} ms, mm alone {m['mm_only_ms']:.3f} ms; max abs err "
              f"{m['max_abs_err']:.3g} (monolithic {m['monolithic_max_abs_err']:.3g}), "
              f"{100 * m['max_share_of_bound']:.2f}% of the bound [{smi}]")
    sys.stdout.flush()


def print_collectives(coll: dict, smi: str) -> None:
    """The training world's lines, then the whole phase's JSON (the
    collectives' lines are printed as their world ends)."""
    t = coll["train"]
    for mode in ("auto", "chunked"):
        sync_ms = ", ".join(f"{k} {v:.2f} (step 1: {t[mode]['sync_ms_first_step'][k]:.1f})"
                            for k, v in t[mode]["sync_ms_steady"].items())
        print(f"collectives train_dist {mode}: {t['arch']} 2 layers on {t['mesh']}, "
              f"{t[mode]['steady_step_ms']:.1f} ms/step; sync ms a step of "
              f"{t['grad_bytes'] / 1e9:.2f} GB of gradients: {sync_ms}; "
              f"losses {[round(x, 4) for x in t['losses'][mode]]} [{smi}]")
    print(f"collectives train_dist: step 1 on one card {t['one_card_step1_loss']:.6f}; "
          f"checkpoint {t['ckpt_bytes'] / 1e9:.2f} GB saved by rank 0 in {t['save_s']:.2f} s "
          f"(launches {t['launches_save_rank0']}), restored on each rank in "
          f"{', '.join(f'{x:.2f}' for x in t['restore_s'])} s (launches "
          f"{t['launches_restore'][0]} each), on two ranks in "
          f"{', '.join(f'{x:.2f}' for x in t['elastic_restore_s'])} s; resumed "
          f"{t['resumed_losses']}, elastic {t['elastic_losses']} [{smi}]")
    for f in coll["families"]:
        print(f"collectives family {f['arch']} ({' '.join(f['args'][2:])}) on {t['mesh']}: "
              f"{f['steady_step_ms']:.1f} ms/step; losses {[round(x, 4) for x in f['losses']]}, "
              f"step 1 on one card {f['one_card_step1']:.6f}; peak GB a card "
              f"{[round(b / 1e9, 2) for b in f['peak_bytes']]} [{smi}]")
    m = coll["model_axis"]
    base = m["meshes"][t["mesh"]]
    for mesh, row in m["meshes"].items():
        f32 = f"; f32 logits within {row['f32_rel']:.3g} of one card's" if "f32_rel" in row else ""
        print(f"collectives model_axis {m['arch']} 2 layers on {mesh}: {row['step_ms']:.1f} ms/step; "
              f"all-reduce ms a step: model {row['collective_ms']['model']:.2f}, batch axes "
              f"{row['collective_ms']['batch']:.2f}; peak GB a card "
              f"{[round(b / 1e9, 2) for b in row['peak_bytes']]} ({t['mesh']}: "
              f"{[round(b / 1e9, 2) for b in base['peak_bytes']]}){f32} [{smi}]")
    c = m["ckpt"]
    print(f"collectives model_axis checkpoint on {c['mesh']}: {c['bytes'] / 1e9:.2f} GB, the whole "
          f"tree gathered and saved by rank 0 in {c['save_s']:.2f} s (launches "
          f"{c['launches_save_rank0']}), restored on each rank in "
          f"{', '.join(f'{x:.2f}' for x in c['restore_s'])} s, on {TP_ELASTIC_MESH} in "
          f"{', '.join(f'{x:.2f}' for x in c['elastic_restore_s'])} s; resumed {c['resumed']}, "
          f"elastic {c['elastic']} [{smi}]")
    v = m["vlm"]
    print(f"collectives model_axis internvl2-2b 2 layers on {v['mesh']}: {v['steady_step_ms']:.1f} "
          f"ms/step; losses {[round(x, 4) for x in v['losses']]}, step 1 on one card "
          f"{v['one_card_step1']:.6f}; peak GB a card {[round(b / 1e9, 2) for b in v['peak_bytes']]} "
          f"[{smi}]")
    print_expert_axis(coll["expert_axis"], smi)
    print_family_model_axis(coll["family_model_axis"], smi)
    print_zero_axis(coll["zero_axis"], smi)
    print_serve_model_axis(coll["serve_model_axis"], smi)
    print_serve_families(coll["serve_families"], smi)
    print("collectives " + json.dumps(coll))


# one-card parts --phases runs alone
CARD_PARTS = ("stripes", "engine", "matmul", "serve_long", "remat", "dryrun")


def long_and_remat(seed: int, device, smi: str, parts) -> None:
    """The ``serve_long`` and ``remat`` phases named in ``parts``, each
    printed as its JSON and one line."""
    if "serve_long" in parts:
        torch.cuda.empty_cache()
        lng = serve_long_path(seed, device)
        print("serve_long " + json.dumps(lng))
        print(f"serve_long: {lng['arch']} {lng['layers']} layers, batch 1 over a cache of "
              f"{lng['positions']} positions ({lng['cache_bytes'] / 1e9:.2f} GB; params "
              f"{lng['param_bytes'] / 1e9:.2f} GB; drawn in {lng['cache_fill_s']:.2f} s), "
              f"{lng['steps']} steps from position {lng['start']}: "
              f"{lng['ms_per_decode_step']:.2f} ms a decode step, peak "
              f"{lng['peak_bytes'] / 1e9:.2f} GB [{smi}]")
    if "remat" in parts:
        torch.cuda.empty_cache()
        rem = remat_path(seed, device)
        print("remat " + json.dumps(rem))
        modes = "; ".join(
            f"{k} {sum(rem[k]['step_ms'][1:]) / (REMAT_STEPS - 1):.1f} ms a step (step 1 "
            f"{rem[k]['step_ms'][0]:.1f}), peak {rem[k]['peak_bytes'] / 1e9:.2f} GB (forward "
            f"and backward {rem[k]['grad_peak_bytes'] / 1e9:.2f}), losses "
            f"{', '.join(f'{x:.6g}' for x in rem[k]['losses'])}" for k in ("none", "full", "dots"))
        print(f"remat: {rem['arch']} {rem['layers']} layers, seq {rem['seq']}, batch "
              f"{rem['batch']}: {modes}; dots' losses bit-equal to full's: "
              f"{rem['dots_losses_bit_equal_full']} [{smi}]")
    sys.stdout.flush()


def print_dryrun(dry: dict, smi: str, props) -> None:
    """The dry-run phase's JSON and lines."""
    print("dryrun " + json.dumps(dry))
    for r in dry["checked"]:
        w, c = r["walk"], r["card"]
        print(f"dryrun {r['cell']}: {r['arch']} {r['layers']} layers, batch {r['batch']}: "
              f"{c['flops_per_device'] / 1e12:.2f} TFLOP (walk = card), argument "
              f"{c['argument_bytes'] / 1e9:.3f} GB (walk = card), peak walk "
              f"{w['peak_bytes'] / 1e9:.3f} GB / card {c['peak_bytes'] / 1e9:.3f} GB "
              f"({100 * r['peak_rel_err']:+.2f}%), {r['step_ms']:.2f} ms a step, "
              f"{100 * r['flop_share']:.1f}% of {BF16_PEAK_FLOPS / 1e12:.1f} TFLOP/s [{smi}]")
    for key, r in dry["full"].items():
        print(f"dryrun full {key}: peak {r['peak_bytes'] / 1e9:.2f} GB of "
              f"{props.total_memory / 1e9:.2f} GB on the card, "
              f"{r['flops_per_device'] / 1e12:.2f} TFLOP, {r['bytes_accessed'] / 1e12:.2f} TB "
              f"accessed, walked in {r['walk_s']:.1f} s")
    for key, r in dry["mesh"].items():
        c = r["collectives"]
        groups = ", ".join(f"{g}: {b / 1e9:.3f}" for g, b in sorted(
            c["by_group_size"].items(), key=lambda kv: int(kv[0])))
        print(f"dryrun mesh {key}: rank 0 of {r['devices']}, argument "
              f"{r['argument_bytes'] / 1e9:.3f} GB, peak {r['peak_bytes'] / 1e9:.3f} GB a rank, "
              f"{r['flops_per_device'] / 1e12:.2f} TFLOP, {c['n_ops']} collectives, GB by group "
              f"size {{{groups}}} (walk counts, equal on card and host tensors), walked in "
              f"{r['walk_s']:.1f} s (card) / {r['host_walk_s']:.1f} s (host) [{smi}]")
    print(f"dryrun: checked {dry['checked_s']:.1f} s, full-depth walks {dry['full_s']:.1f} s, "
          f"production meshes {dry['mesh_s']:.1f} s, phase {dry['seconds']:.1f} s")
    sys.stdout.flush()


def matmul_part(seed: int, device, card: dict, smi: str, reset, counts) -> dict:
    """Item 6: the fused matmul + digest at mistral-nemo-12b's up-projection,
    B in bf16 and then in float32, each held (``matmul_check``,
    ``matmul_check_f32b``) and then driven through ``matmul_with_digest``
    with the counts at 0. Returns {"bf16", "f32b": kernels-line rows,
    "path", "path_f32b": the path runs}."""
    out = {}
    a, b = matmul_inputs(seed, device)
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
          f"library + separate digest {mmr['library_plus_digest_ms']:.4f} ms [{smi}]")
    check(mmr["ms"] < mmr["library_plus_digest_ms"],
          "the fused kernel is faster than the library product plus the separate digest pass")
    sync(device)
    reset()
    out["path"] = matmul_path(a, b, dig)
    out["path"]["launches"] = counts()
    print("matmul_path " + json.dumps(out["path"]))
    check(out["path"]["launches"]["matmul_digest"] > 0, "matmul_digest launched on its path")
    del b

    _, b = matmul_inputs(seed, device, torch.float32)
    m32 = matmul_check_f32b(card, a, b)
    print(f"kernel matmul_digest_f32b {m32['shape']} (B float32, three bf16 terms): split "
          f"bit-equal, residues exact, C within K*2^-24*(|A|@|B|) of float64 (max abs err "
          f"{m32['max_abs_err_f64']:.3e}, max rel err {m32['max_rel_err_f64']:.3e}, "
          f"{100 * m32['max_share_of_tolerance']:.2f}% of the tolerance; vs plain "
          f"{m32['max_abs_err']:.3e}), {m32['ms']:.4f} ms (bound {m32['bound_ms']:.4f} ms by "
          f"{m32['bound_by']}, {100 * m32['bound_ms'] / m32['ms']:.1f}% of bound; f32 CUDA-core "
          f"ceiling {m32['bound_fp32_ms']:.4f} ms), split alone {m32['split_ms']:.4f} ms, plain "
          f"{m32['plain_ms']:.2f} ms, library {m32['library_ms']:.4f} ms "
          f"({m32['library_call']}), separate digest {m32['separate_digest_ms']:.4f} ms, "
          f"library + separate digest {m32['library_plus_digest_ms']:.4f} ms [{smi}]")
    check(m32["ms"] < m32["library_plus_digest_ms"],
          "the f32-B kernel is faster than SGEMM plus the separate digest pass")
    sync(device)
    reset()
    out["path_f32b"] = matmul_path(a, b, dig)
    out["path_f32b"]["launches"] = counts()
    print("matmul_path_f32b " + json.dumps(out["path_f32b"]))
    check(out["path_f32b"]["launches"]["matmul_digest"] > 0,
          "matmul_digest launched on its float32-B path")
    out.update(bf16=mmr, f32b=m32)
    return out


def card_phases(seed: int, device, card: dict, smi: str, props, reset, counts) -> list[dict]:
    """Every phase on one card (items 3-15 of the module docstring); returns
    the ``kernels`` entries."""
    rows = kernel_checks(card, seed, device)
    for r in rows:
        print(f"kernel {r['name']} {r['shape']}: exact (tolerance 0), {r['ms']:.4f} ms "
              f"(bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
              f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound), plain {r['plain_ms']:.2f} ms"
              + (f", copy_ {r['copy_ms']:.4f} ms" if "copy_ms" in r else ""))

    torch.cuda.synchronize()
    reset()
    api = digest_api(seed, device, API_BYTES)
    xfer = transfer(seed, device, TRANSFER_BYTES)
    torch.cuda.synchronize()
    launches = counts()
    print("digest_api " + json.dumps(api))
    print("transfer " + json.dumps(xfer))
    print("launches transfer path " + json.dumps(launches))
    for r in rows:
        check(launches[r["name"]] > 0, f"{r['name']} launched on the main path")

    for chunk_bytes in (CHUNK_BYTES, SERVICE_OVERSIZE_CHUNK):
        flip = flipped_landing(seed, device, chunk_bytes)
        print("flipped_landing " + json.dumps(flip))
    torch.cuda.empty_cache()
    stripes = stripes_path(seed, device, reset, counts)
    print_stripes(stripes, smi)
    engine = engine_path(seed, device, reset, counts)
    print_engine(engine, smi)

    mm_part = matmul_part(seed, device, card, smi, reset, counts)
    mmr, mmr32 = mm_part["bf16"], mm_part["f32b"]

    lat = digest_latency(device)
    print("digest_latency " + json.dumps(lat))
    ckpt = checkpoint_path(seed, device, reset, counts)
    print("checkpoint " + json.dumps(ckpt))
    check(ckpt["launches"]["checksum_words"] > 0,
          "the checkpoint digested its leaves on the card")
    svc = service_path(seed, device, reset, counts)
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
    relay = relay_path(seed, device, reset, counts)
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
    def train_phase(name, train_args, steps, ckpt_step, learns=True):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        out = train_path(seed, device, reset, counts, train_args, steps, ckpt_step, learns)
        out["peak_GB"] = torch.cuda.max_memory_allocated(device) / 1e9
        print(f"{name} " + json.dumps(out))
        layers = (f"{out['enc_layers']}+{out['layers']}" if "enc_layers" in out
                  else f"{out['layers']}")
        line = (f"{name}: {out['arch']} {layers} layers, {out['steady_step_ms']:.1f} "
                f"ms/step, {out['tokens_per_s']:.0f} tokens/s, {100 * out['model_flop_share']:.1f}% "
                f"of the bf16 dense peak ({out['flop_count']}), peak {out['peak_GB']:.1f} GB, "
                f"grad norms {out['grad_norms'][0]:.4g} .. {out['grad_norms'][-1]:.4g}")
        if "executed_flop_share" in out:
            line += (f", {100 * out['executed_flop_share']:.1f}% counting the experts' padded "
                     f"capacity (C = {out['capacity']})")
        if ckpt_step is not None:
            line += (f"; checkpoint {out['ckpt_bytes'] / 1e9:.2f} GB saved in {out['save_s']:.2f} s "
                     f"({out['save_GBps']:.2f} GB/s), restored in {out['restore_s']:.2f} s "
                     f"({out['restore_GBps']:.2f} GB/s); launches save {out['launches_save']}, "
                     f"restore {out['launches_restore']}")
            for what in ("save", "restore"):
                got, want = out[f"launches_{what}"], out["expected_launches"][what]
                check(got == {**got, **want}
                      and got["checksum_copy_words"] == got["matmul_digest"] == 0,
                      f"the {name} checkpoint {what} launched exactly {want}: {got}")
        else:
            check(sum(out["launches"].values()) == 0, f"{name} launched no digest")
        print(f"{line} [{smi}]")
        return out

    def serve_phase(name, serve_args, f32_cpu=True, bf16_decode_bound=True):
        torch.cuda.empty_cache()
        out = serve_path(seed, device, serve_args, f32_cpu=f32_cpu,
                         bf16_decode_bound=bf16_decode_bound)
        print(f"{name} " + json.dumps(out))
        line = (f"{name}: {out['arch']} {out['layers']} layers, {out['ms_per_decode_step']:.2f} ms "
                f"per decoded token (batch {out['batch']}), {out['tokens_per_s']:.0f} tokens/s")
        line += (f"; decode vs forward max |err| bf16 {out['decode_vs_forward_max_abs_err']:.4g}"
                 f" of {out['decode_vs_forward_scale']:.4g}, f32 "
                 f"{out['f32_decode_vs_forward_max_abs_err']:.4g} of "
                 f"{out['f32_decode_vs_forward_scale']:.4g}")
        if f32_cpu:
            line += (f"; f32 card vs CPU {out['f32_card_vs_cpu_max_abs_err']:.4g} of "
                     f"{out['f32_card_vs_cpu_scale']:.4g}")
        if "decode_vs_forward_flipped_share" in out:
            line += (f"; top-k flipped: decode vs forward bf16 "
                     f"{100 * out['decode_vs_forward_flipped_share']:.2f}%, f32 "
                     f"{100 * out['f32_decode_vs_forward_flipped_share']:.2f}%")
            if f32_cpu:
                line += f", f32 card vs CPU {100 * out['f32_card_vs_cpu_flipped_share']:.2f}%"
        print(f"{line} [{smi}]")
        return out

    trn = train_phase("train", TRAIN_ARGS, TRAIN_STEPS, TRAIN_CKPT_STEP)
    srv = serve_phase("serve", SERVE_ARGS)
    trn_moe = train_phase("train_moe", MOE_TRAIN_ARGS, TRAIN_STEPS, TRAIN_CKPT_STEP)
    srv_moe = serve_phase("serve_moe", MOE_SERVE_ARGS)
    srv_grok = serve_phase("serve_grok", GROK_SERVE_ARGS, f32_cpu=False, bf16_decode_bound=False)
    trn_ssm = train_phase("train_ssm", SSM_TRAIN_ARGS, TRAIN_STEPS, TRAIN_CKPT_STEP)
    srv_ssm = serve_phase("serve_ssm", SSM_SERVE_ARGS, bf16_decode_bound=False)
    trn_hyb = train_phase("train_hybrid", HYBRID_TRAIN_ARGS, HYBRID_TRAIN_STEPS, None)
    srv_hyb = serve_phase("serve_hybrid", HYBRID_SERVE_ARGS)
    trn_enc = train_phase("train_encdec", ENCDEC_TRAIN_ARGS, TRAIN_STEPS, TRAIN_CKPT_STEP,
                          learns=False)
    trn_enc_cut = train_phase("train_encdec_cut",
                              ENCDEC_TRAIN_ARGS + ["--layers", str(ENCDEC_CHECK_LAYERS)],
                              TRAIN_STEPS, None)
    torch.cuda.empty_cache()
    srv_enc = serve_encdec_path(seed, device)
    print("serve_encdec " + json.dumps(srv_enc))
    print(f"serve_encdec: {srv_enc['arch']} {srv_enc['enc_layers']}+{srv_enc['layers']} layers, "
          f"{srv_enc['ms_per_decode_step']:.2f} ms per decoded token (batch {srv_enc['batch']}), "
          f"prefill {srv_enc['prefill_ms']:.1f} ms; prefill vs forward "
          f"{srv_enc['prefill_max_abs_err']:.4g} of {srv_enc['prefill_scale']:.4g}; whole depth, "
          f"measured: decode vs forward bf16 {srv_enc['decode_vs_forward_max_abs_err']:.4g} of "
          f"{srv_enc['decode_vs_forward_scale']:.4g}, f32 "
          f"{srv_enc['f32_decode_vs_forward_max_abs_err']:.4g} of "
          f"{srv_enc['f32_decode_vs_forward_scale']:.4g}, f32 batch sensitivity "
          f"{srv_enc['f32_batch_sensitivity']:.3g}; {srv_enc['check_layers']}+"
          f"{srv_enc['check_layers']} layers: decode vs forward bf16 "
          f"{srv_enc['cut_decode_vs_forward_max_abs_err']:.4g} of "
          f"{srv_enc['cut_decode_vs_forward_scale']:.4g} (measured), f32 "
          f"{srv_enc['cut_f32_decode_vs_forward_max_abs_err']:.4g} of "
          f"{srv_enc['cut_f32_decode_vs_forward_scale']:.4g}, f32 card vs CPU "
          f"{srv_enc['cut_f32_card_vs_cpu_max_abs_err']:.4g} of "
          f"{srv_enc['cut_f32_card_vs_cpu_scale']:.4g}, f32 batch sensitivity "
          f"{srv_enc['cut_f32_batch_sensitivity']:.3g} [{smi}]")
    trn_vlm = train_phase("train_vlm", VLM_TRAIN_ARGS, TRAIN_STEPS, TRAIN_CKPT_STEP)
    srv_vlm = serve_phase("serve_vlm", VLM_SERVE_ARGS)
    torch.cuda.empty_cache()
    pre_vlm = vlm_prefill_path(seed, device)
    print("prefill_vlm " + json.dumps(pre_vlm))
    print(f"prefill_vlm: {pre_vlm['arch']} {pre_vlm['layers']} layers, {pre_vlm['vis_tokens']} + "
          f"{pre_vlm['text_tokens']} positions, batch {pre_vlm['batch']}: "
          f"{pre_vlm['prefill_ms']:.2f} ms; prefill vs forward {pre_vlm['prefill_max_abs_err']:.4g} "
          f"of {pre_vlm['prefill_scale']:.4g}; f32 card vs CPU "
          f"{pre_vlm['f32_card_vs_cpu_max_abs_err']:.4g} of {pre_vlm['f32_card_vs_cpu_scale']:.4g} "
          f"[{smi}]")
    del srv, srv_moe, srv_grok, srv_ssm, srv_hyb, srv_enc, srv_vlm, pre_vlm
    long_and_remat(seed, device, smi, ("serve_long", "remat"))
    dry = dryrun_path(device, reset, counts)
    print_dryrun(dry, smi, props)
    check(sum(dry["launches"].values()) == 0, "the dry run launched no digest")
    # each kernel's launches over every main-path run
    runs = [stripes["launches"], engine["launches"], mm_part["path"]["launches"], ckpt["launches"],
            svc["launches"],
            svc["idle_delta"]["launches"], serial["launches"], single["launches"],
            relay["plain"]["launches"],
            relay["tuned"]["launches"], *(r["launches"] for r in cli.values()),
            trn["launches"], trn_moe["launches"], trn_ssm["launches"], trn_hyb["launches"],
            trn_enc["launches"], trn_enc_cut["launches"], trn_vlm["launches"]]
    launches = {k: launches[k] + sum(r[k] for r in runs) for k in launches}
    print("launches all paths " + json.dumps(launches))

    # the float32-B path's matmul_digest launches are its own row's
    launches["matmul_digest_f32b"] = mm_part["path_f32b"]["launches"]["matmul_digest"]
    kernels = []
    for r in rows + [{"name": "matmul_digest", "exact": True, **mmr},
                     {"name": "matmul_digest_f32b", "exact": True, **mmr32}]:
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
                      "max_rel_err_f64", "max_share_of_tolerance", "split_ms",
                      "bound_fp32_ms", "bound_split_bytes_ms"):
            if extra in r:
                entry[extra] = r[extra]
        if r["name"].startswith("matmul_digest"):
            entry["tolerance"] = ("C: |C - C64| <= K*2^-24*(|A|@|B|) elementwise, for the "
                                  "kernel and the plain version; residues: exact")
        kernels.append(entry)
    return kernels


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--phases", default="all",
                        help=f"comma-separated of {', '.join(PHASES)} (default: all)")
    parser.add_argument("--rank-worker",
                        choices=("collectives", "train_dist", "family_dist", "tp_dist",
                                 "serve_dist", "serve_families"),
                        help=argparse.SUPPRESS)
    parser.add_argument("--config", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.rank_worker:
        return rank_worker(args.rank_worker, args.config)
    phases = set(PHASES) if args.phases == "all" else set(args.phases.split(","))
    if not phases or phases - set(PHASES) - set(COLL_PARTS) - set(CARD_PARTS):
        parser.error(f"--phases takes {', '.join(PHASES)}, {', '.join(CARD_PARTS)} (those "
                     f"parts of card alone), {', '.join(COLL_PARTS[1:])} (those parts of "
                     f"collectives alone) or all, not {args.phases!r}")

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

    reset, counts = launch_counters()

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

    kernels = None
    if "card" in phases:
        kernels = card_phases(args.seed, device, card, smi, props, reset, counts)
    elif phases & set(CARD_PARTS):
        if "stripes" in phases:
            print_stripes(stripes_path(args.seed, device, reset, counts), smi)
        if "engine" in phases:
            print_engine(engine_path(args.seed, device, reset, counts), smi)
        if "matmul" in phases:
            matmul_part(args.seed, device, card, smi, reset, counts)
        long_and_remat(args.seed, device, smi, phases)
        if "dryrun" in phases:
            dry = dryrun_path(device, reset, counts)
            print_dryrun(dry, smi, props)
            check(sum(dry["launches"].values()) == 0, "the dry run launched no digest")
    if phases & set(COLL_PARTS):
        parts = COLL_PARTS if "collectives" in phases else tuple(
            p for p in COLL_PARTS if p in phases)
        coll = collectives_path(args.seed, device, smi, parts)
        if coll is None:
            print(f"collectives: not run, needs {COLL_CARDS} cards, "
                  f"{torch.cuda.device_count()} visible")
        elif "collectives" in parts:
            print_collectives(coll, coll["card"])
        else:
            if "expert_axis" in parts:
                print_expert_axis(coll["expert_axis"], coll["card"])
            if "family_model_axis" in parts:
                print_family_model_axis(coll["family_model_axis"], coll["card"])
            if "zero_axis" in parts:
                print_zero_axis(coll["zero_axis"], coll["card"])
            if "serve_model_axis" in parts:
                print_serve_model_axis(coll["serve_model_axis"], coll["card"])
            if "serve_families" in parts:
                print_serve_families(coll["serve_families"], coll["card"])
            print("collectives " + json.dumps(coll))
    print(f"total: {time.perf_counter() - t_all:.1f} s on {smi}")
    if kernels is not None:
        print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
