#!/usr/bin/env python3
"""The service movers' digests: one checkout against another, on one CUDA card.

    python3 tools/mover_digest_ab.py [--src DIR] [--label NAME] [--reps N] [--out FILE]
                                     [--size-mb MB] [--device cpu]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
one script times two checkouts of the port, for example one whose serial
and single-pass movers digest on the host and one whose movers digest on
the card. Run both in one call, in turns (A, B, B, A), and compare only
within that call. Three workloads, each on a fresh, idle
``TransferService`` on local disk with ``device="cuda"`` (``--device cpu``
runs the kernels' plain versions: a rehearsal of the script, not a
measurement):

  * ``serial``: one 512 MiB file (``--size-mb``) at 8 MiB chunks, ``pipeline="serial"``,
    8 movers, 4 tasks at once (the inline task of ``chip_smoke.py``);
  * ``single_pass``: the same file, ``pipeline="single_pass"``;
  * ``real``: the workload and configuration of ``transferd --real``: two
    tenants, each six files of 300,000+i bytes and one of 8 MiB, 256 KiB
    chunks, 16 movers, 4 tasks at once, seed 0.

Each workload runs ``--reps`` times after one untimed warm-up (which also
builds the kernels where the checkout launches any). Prints, and writes to
``--out``, one JSON object: per workload and rep the task seconds
(activation to finish), the wall seconds (first submit to last wait), the
thread-seconds per span name, and the kernel launches; with the card's
name and power limit. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

MiB = 1024 * 1024


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(os.path.dirname(__file__), "..", "src"))
    ap.add_argument("--label", default="this")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--size-mb", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))

    import numpy as np
    import torch

    from repro_torch.kernels import checksum as ck
    from repro_torch.service import BatchConfig, ServiceConfig, TransferService

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("needs a CUDA card (or --device cpu)")
        device = torch.device("cuda", 0)
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip().splitlines()[0]
    else:
        card = "cpu"

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    root = tempfile.mkdtemp(prefix="mover-digest-ab-")
    try:
        data = os.path.join(root, "data")
        os.makedirs(data)
        rng = np.random.default_rng(1)
        big = os.path.join(data, "inline.bin")
        with open(big, "wb") as fh:
            fh.write(rng.bytes(args.size_mb * MiB))
        # transferd --real's files, made as run_real makes them
        rng = np.random.default_rng(0)
        real_items = {}
        for k in range(2):
            tenant = f"tenant{k}"
            items = []
            for i in range(6):
                p = os.path.join(data, f"{tenant}-small{i}.bin")
                with open(p, "wb") as fh:
                    fh.write(rng.integers(0, 256, 300_000 + i, dtype=np.uint8).tobytes())
                items.append((p, p + ".out"))
            p = os.path.join(data, f"{tenant}-big.bin")
            with open(p, "wb") as fh:
                fh.write(rng.integers(0, 256, 8 * MiB, dtype=np.uint8).tobytes())
            items.append((p, p + ".out"))
            real_items[tenant] = items

        def config(name):
            if name == "real":
                return ServiceConfig(mover_budget=16, max_concurrent_tasks=4,
                                     chunk_bytes=256 * 1024,
                                     batch=BatchConfig(direct_bytes=4 * MiB, batch_files=8),
                                     tune_min_chunk=32 * 1024, tune_max_chunk=4 * MiB)
            return ServiceConfig(pipeline=name, mover_budget=8, max_concurrent_tasks=4)

        def submit(svc, name):
            if name == "real":
                return [t for tenant, items in real_items.items()
                        for t in svc.submit(items, tenant=tenant, label="smoke")]
            return svc.submit([(big, big + ".out")], tenant="facility", label=name)

        def once(name, rep):
            for f in os.listdir(data):
                if f.endswith(".out"):
                    os.remove(os.path.join(data, f))
            state = os.path.join(root, f"svc-{name}-{rep}")
            svc = TransferService(state, config(name), device=device)
            try:
                sync()
                ck.reset_launch_counts()
                t0 = time.perf_counter()
                tids = submit(svc, name)
                sts = svc.wait_all(tids, timeout=600)
                sync()
                wall = time.perf_counter() - t0
                launches = ck.launch_counts()
                spans = {}
                for tid in tids:
                    for sp in svc.tracer.spans(tid):
                        spans[sp.name] = spans.get(sp.name, 0.0) + sp.t1 - sp.t0
            finally:
                svc.close()
                shutil.rmtree(state, ignore_errors=True)
            bad = [(st.task_id, st.state, st.error) for st in sts if st.state != "SUCCEEDED"]
            if bad:
                raise SystemExit(f"{name}: tasks failed: {bad}")
            return {"wall_s": wall,
                    "task_s": [st.finished_s - st.started_s for st in sts],
                    "chunks": sum(st.chunks_total for st in sts),
                    "span_thread_s": spans, "launches": launches}

        out = {"label": args.label, "card": card, "workloads": {}}
        for name in ("serial", "single_pass", "real"):
            once(name, "warmup")
            out["workloads"][name] = [once(name, r) for r in range(args.reps)]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
