#!/usr/bin/env python3
"""The float32-B matmul_digest of one checkout, timed against cuBLAS SGEMM on one CUDA card.

    python3 tools/matmul_f32b_ab.py [--src DIR] [--label NAME] [--reps N] [--out FILE]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
one script times two checkouts of the port, for example one whose float32-B
path is a CUDA-core FMA kernel and one that splits B into three bf16 terms
on the tensor cores. Run both in one call, in turns (A, B, B, A), and
compare only within that call: unpack the other checkout with ``git
archive`` under ``build/`` (git-ignored) and pass its ``src``.

At ``chip_smoke.py``'s matmul shape, mistral-nemo-12b's up-projection:
A (14336, 5120) bf16 (randn x 0.02), B (5120, 4096) float32 (randn), drawn
on the card from seed 5 as ``chip_smoke.matmul_inputs(0, ...)`` draws them.
Holds the checkout's ``matmul_digest(A, B)`` to its plain version (residues
equal) and to float64 (C within K * 2^-24 * (|A| @ |B|), the share of that
tolerance printed), then times, in turns (a b c c b a), ``--reps``
launches each of: the checkout's ``matmul_digest`` on the float32 B, cuBLAS
SGEMM (``torch.mm`` of A cast to float32 before timing, TF32 off) and the
checkout's ``matmul_digest`` on B rounded to bf16 (the bf16 path, as a
control). Prints, and writes to ``--out``, one JSON object with the card's
name and power limit. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

M, K, N = 14336, 5120, 4096


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(os.path.dirname(__file__), "..", "src"))
    ap.add_argument("--label", default="this")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))

    import torch

    from repro_torch.kernels import matmul_digest as mm
    from repro_torch.kernels import ref

    if not torch.cuda.is_available():
        sys.exit("matmul_f32b_ab: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.splitlines()[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    a = (torch.randn(M, K, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    b = torch.randn(K, N, generator=gen, device=dev)
    b16 = b.to(torch.bfloat16)

    c, dig = mm.matmul_digest(a, b)
    pc, pdig = ref.matmul_digest_ref(a, b)
    a64, b64 = a.double(), b.double()
    c64 = a64 @ b64
    tol = K * 2.0 ** -24 * (a64.abs() @ b64.abs())
    del a64, b64
    err = (c.double() - c64).abs()
    held = {"residues_equal_plain": bool(torch.equal(dig, pdig)),
            "within_tolerance": bool((err <= tol).all()),
            "max_share_of_tolerance": float((err / tol.clamp_min(1e-300)).max()),
            "max_abs_err_vs_plain": float((c - pc).abs().max())}
    del c, pc, c64, tol, err

    a32 = a.float()
    calls = {"f32b_ms": lambda: mm.matmul_digest(a, b),
             "sgemm_ms": lambda: torch.mm(a32, b),
             "bf16_ms": lambda: mm.matmul_digest(a, b16)}
    runs = {k: [] for k in calls}
    for order in (list(calls), list(reversed(calls))):
        for k in order:
            calls[k]()
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                calls[k]()
            end.record()
            end.synchronize()
            runs[k].append(start.elapsed_time(end) / args.reps)
    out = {"label": args.label, "src": args.src, "card": smi, "shape": [M, K, N],
           "reps": args.reps, **held, **{k: sum(v) / len(v) for k, v in runs.items()},
           "runs_ms": runs}
    line = json.dumps(out)
    print(f"matmul_f32b_ab {line}")
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
