#!/usr/bin/env python3
"""The readings that a training cell's limits are set from, on the card.

    python3 bench/control.py --workload <cell> --seeds 11,12,... [--control-seeds 3] [--out FILE]

For each seed, in one process: the program's readings (set-up's checked
steps, as a run takes them) against the float32 reference's, giving the
lower readings; and for the first ``--control-seeds`` seeds the control
(the reference with float8 products, ``reference.precision.FP8``, in the
program's place) and the planted half-batch fault (the reference taking
its loss and gradients over half of each batch's rows) against the same
float32 reference, giving the upper ones. Each row is judged as a run is
(``check.judge`` against the cell's limits in ``bench/workloads/<cell>.json``,
with no non-finite loss): the program's rows have to come out correct, the
control's and the fault's not. Prints one JSON line per seed and reading,
with its ``correct``, writes them to ``--out``, and ends standard error with
each row's verdict. Exits 1 where a row's verdict is not what it has to be.
Benchmark runs do not run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def by_leaf(got, ref) -> dict:
    """Each leaf's gradient and change gap, and the reference's norms."""
    from bench import check

    counted = check.counted_leaves(ref)
    return {"grad_gaps": check.leaf_gaps(got.grads, ref.grads, counted),
            "change_gaps": check.leaf_gaps(got.changes, ref.changes, counted),
            "ref_grads": ref.grads, "ref_changes": ref.changes}


def judged(cell, values: dict) -> dict:
    """The row's numbers, and whether a run that read them is correct."""
    from bench import check

    ok, _checks = check.judge(dict(values, nonfinite_losses=0), cell.limits)
    return {"correct": ok, **values}


def readings(cell, seeds: list, control_seeds: int, device, emit) -> None:
    import torch

    from bench import check, train
    from bench.reference.dims import Dims
    from bench.reference.precision import FP8

    dm = Dims.of(cell.config)
    prog = train.build_program(cell.config, cell.traffic, dm)
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        params, opt, got, _feed = train.program_readings(prog, dm, cell.traffic, seed, device)
        del params, opt
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ref = train.reference_readings(dm, cell.traffic, seed, device)
        emit({"seed": seed, "side": "program", **judged(cell, check.numbers(got, ref)),
              **by_leaf(got, ref),
              "losses": got.losses, "ref_losses": ref.losses, "s": time.perf_counter() - t0})
        if i < control_seeds:
            for side, kw in (("control_fp8", {"prec": FP8}), ("fault_half_batch", {"half_batch": True})):
                t0 = time.perf_counter()
                bad = train.reference_readings(dm, cell.traffic, seed, device, **kw)
                emit({"seed": seed, "side": side, **judged(cell, check.numbers(bad, ref)),
                      **by_leaf(bad, ref),
                      "losses": bad.losses, "s": time.perf_counter() - t0})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from bench import spec

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    cell = spec.load_cell(args.workload, ROOT)
    out = open(args.out, "a") if args.out else None
    verdicts = []

    def emit(rec: dict) -> None:
        line = json.dumps({"cell": cell.name, "card": torch.cuda.get_device_name(0), **rec})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        verdicts.append((rec["seed"], rec["side"], rec["correct"],
                         {k: rec[k] for k in cell.limits if k in rec}))

    try:
        readings(cell, [int(s) for s in args.seeds.split(",")], args.control_seeds,
                 torch.device("cuda", 0), emit)
    finally:
        if out:
            out.close()
    wrong = 0
    for seed, side, ok, nums in verdicts:
        due = side == "program"
        wrong += ok != due
        print(f"{cell.name} seed {seed} {side}: correct={ok} (due {due}) "
              + " ".join(f"{k}={v:.3g}/{cell.limits[k]:.3g}" for k, v in nums.items()),
              file=sys.stderr)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
