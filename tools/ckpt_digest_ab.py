#!/usr/bin/env python3
"""Checkpoint save and restore of card-resident state: one checkout against another.

    python3 tools/ckpt_digest_ab.py [--src DIR] [--label NAME] [--reps N] [--out FILE]
                                    [--workloads block,train_state] [--device cpu]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
one script times two checkouts of the port, for example one whose
checkpoint movers and restore digest on the host and one that digests on
the card. Run both in one call, in turns (A, B, B, A), and compare only
within that call. Two states, made on the card from a seed, saved with
``CheckpointManager(root, device=...)`` into a fresh directory and
restored to the card:

  * ``block``: one mistral-nemo-12b decoder block in bf16 (545 MB, 9
    leaves; the ``checkpoint`` phase of ``chip_smoke.py``);
  * ``train_state``: gemma-2b at full width cut to 2 layers, as
    ``repro_torch.launch.train`` saves it: params in bf16, AdamW's m and v
    in f32 and the step (7.45 GB, 34 leaves; the ``train`` phase).

Each workload runs ``--reps`` times after one untimed warm-up (which also
builds the kernels). Every restored leaf must equal the saved one bit for
bit. Prints, and writes to ``--out``, one JSON object: per workload and
rep the save and restore seconds and the kernel launches of each, with
the card's name and power limit. ``--device cpu`` runs the kernels' plain
versions at a tiny size: a rehearsal of the script, not a measurement.
Imports nothing of JAX.
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


def shapes(workload: str, tiny: bool) -> dict:
    """Leaf key -> (shape, dtype name) of one workload's state."""
    if workload == "block":
        D, F, H, KVH, hd = (64, 256, 4, 2, 16) if tiny else (5120, 14336, 32, 8, 128)
        return {f"blocks/0/{k}": (s, "bfloat16") for k, s in {
            "ln1": (1, D), "ln2": (1, D), "wq": (1, D, H, hd), "wk": (1, D, KVH, hd),
            "wv": (1, D, KVH, hd), "wo": (1, H, hd, D), "wi": (1, D, F), "wg": (1, D, F),
            "wmo": (1, F, D)}.items()}
    D, F, H, KVH, hd, V, nb = ((64, 256, 4, 1, 16, 1000, 2) if tiny
                               else (2048, 16384, 8, 1, 256, 256000, 2))
    params = {"embed": (V, D), "final_norm": (D,), "blocks/0/ln1": (nb, D),
              "blocks/0/ln2": (nb, D), "blocks/0/wq": (nb, D, H, hd),
              "blocks/0/wk": (nb, D, KVH, hd), "blocks/0/wv": (nb, D, KVH, hd),
              "blocks/0/wo": (nb, H, hd, D), "blocks/0/wi": (nb, D, F),
              "blocks/0/wg": (nb, D, F), "blocks/0/wmo": (nb, F, D)}
    out = {f"params/{k}": (s, "bfloat16") for k, s in params.items()}
    for moment in ("m", "v"):
        out.update({f"opt/{moment}/{k}": (s, "float32") for k, s in params.items()})
    out["opt/step"] = ((), "int32")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(os.path.dirname(__file__), "..", "src"))
    ap.add_argument("--label", default="this")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--workloads", default="block,train_state")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))

    import torch

    from repro_torch.ckpt import CheckpointManager
    from repro_torch.kernels import checksum as ck

    device = torch.device(args.device)
    if device.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip().splitlines()[0]
        kind = torch.cuda.get_device_name(0)
    else:
        smi = kind = "cpu (rehearsal: not a measurement)"

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def state(workload: str) -> dict:
        gen = torch.Generator(device=device)
        gen.manual_seed(6)
        tree: dict = {}
        for key, (shape, dt) in shapes(workload, device.type == "cpu").items():
            if dt == "int32":
                leaf = torch.tensor(4, dtype=torch.int32, device=device)
            else:
                leaf = (torch.randn(shape, generator=gen, device=device) * 0.02).to(
                    getattr(torch, dt))
            node = tree
            *parents, name = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[name] = leaf
        return tree

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
        return out

    def once(workload: str, tree: dict) -> dict:
        root = tempfile.mkdtemp(prefix=f"ckpt-ab-{workload}-")
        try:
            mgr = CheckpointManager(root, device=device)
            sync()
            ck.reset_launch_counts()
            t0 = time.perf_counter()
            rep = mgr.save(1, tree)
            sync()
            save_s = time.perf_counter() - t0
            save_launches = ck.launch_counts()
            ck.reset_launch_counts()
            t0 = time.perf_counter()
            got, _ = mgr.restore()
            sync()
            restore_s = time.perf_counter() - t0
            restore_launches = ck.launch_counts()
            want, back = flat(tree), flat(got)
            assert sorted(want) == sorted(back), workload
            for key, t in want.items():
                r = back[key]
                assert r.device == t.device and r.dtype == t.dtype and torch.equal(
                    r.reshape(-1).view(torch.uint8), t.reshape(-1).view(torch.uint8)), key
            del got, back
        finally:
            shutil.rmtree(root, ignore_errors=True)
        return {"bytes": rep.total_bytes, "leaves": rep.n_leaves, "save_s": save_s,
                "save_GBps": rep.total_bytes / save_s / 1e9, "restore_s": restore_s,
                "restore_GBps": rep.total_bytes / restore_s / 1e9,
                "launches_save": save_launches, "launches_restore": restore_launches}

    out = {"label": args.label, "src": os.path.abspath(args.src), "card": smi, "kind": kind,
           "workloads": {}}
    for workload in args.workloads.split(","):
        tree = state(workload)
        once(workload, tree)                       # warm-up: builds, pins, page cache
        out["workloads"][workload] = [once(workload, tree) for _ in range(args.reps)]
        del tree
    line = json.dumps(out)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")


if __name__ == "__main__":
    main()
