#!/usr/bin/env python3
"""mistral-nemo-12b's one-card memory at full width: how ``chip_smoke.py``
chooses its ZeRO part's cut depth.

    python3 tools/nemo_cut_peaks.py [--layers 4,5,6] [--seed 0]

On one card: step 1 of all 40 layers without AdamW's state
(``chip_smoke.one_card_step1``: the loss under ``no_grad``, then the
gradient pass with the allocator held to ``ZERO_PEAK_MAX``), then for each
depth of ``--layers`` two whole train steps of ``ZERO_NEMO_ARGS`` (16
sequences of 2048 in ``ONE_CARD_MICROBATCHES`` microbatches) with their
losses, grad norms, seconds and the card's allocated and reserved peaks. A
depth that runs out of the card prints the allocator's error. Prints the
card (``nvidia-smi``'s name and power limit) first. Needs one card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", default="4,5,6")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path[:0] = [HERE, os.path.join(HERE, "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.launch import train

    if not torch.cuda.is_available():
        print("nemo_cut_peaks: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(f"card: {cs.nvidia_smi('name,power.limit')} (torch {torch.__version__})", flush=True)
    t0 = time.perf_counter()
    one = cs.one_card_step1(cs.ZERO_NEMO_ARGS, args.seed, dev)
    print(f"40 layers, step 1 without AdamW's state ({time.perf_counter() - t0:.1f} s): "
          f"{json.dumps(one)}", flush=True)
    for n in (int(x) for x in args.layers.split(",")):
        cs.reset_peak(dev)
        try:
            res = train.main(cs.ZERO_NEMO_ARGS + [
                "--layers", str(n), "--seed", str(args.seed), "--device", "cuda", "--mesh", "1x1",
                "--steps", "2", "--microbatches", str(cs.ONE_CARD_MICROBATCHES)])
            print(f"{n} layers: peak {cs.peak_bytes(dev) / 1e9:.2f} GB allocated, "
                  f"{torch.cuda.max_memory_reserved(dev) / 1e9:.2f} reserved; losses "
                  f"{res['losses']}, grad norms {res['grad_norms']}, step s "
                  f"{res['step_seconds']}", flush=True)
            del res
        except torch.OutOfMemoryError as e:     # the card's limit is what this tool reports
            print(f"{n} layers: out of memory at {cs.peak_bytes(dev) / 1e9:.2f} GB allocated: "
                  f"{str(e).splitlines()[0]}", flush=True)
        cs.release(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
