#!/usr/bin/env python3
"""Operators a one-device decode step dispatches, one checkout against another.

    python3 tools/decode_ops.py [--src DIR] [--device cpu|cuda] [--arch NAME ...]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``) and,
for each arch's smoke config (batch 4, a cache of 64 positions, whisper's
cross K/V filled by ``prefill_cross`` of zero frames first), counts the
operators that ``decode_step`` dispatches in its second step, under
``torch.profiler`` (every ``aten`` call, views included). A one-card decode
step is bound by the host's launches, so two checkouts' counts tell whether
a change added work to it, where their times on the card move with the host
between calls. Prints one JSON object {arch: operators}. Imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ARCHS = ("gemma-2b", "qwen3-moe-30b-a3b", "grok-1-314b", "mamba2-370m", "recurrentgemma-2b",
         "whisper-large-v3", "internvl2-2b")


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(here, "src"))
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--arch", nargs="*", default=list(ARCHS))
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import build_model

    dev = torch.device(args.device)
    out = {}
    for arch in args.arch:
        model = build_model(arch, smoke=True)
        params = model.init_params(0, dev)
        B, T = 4, 64
        tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        cache = model.init_cache(B, T, device=dev)
        with torch.no_grad():
            if model.cfg.family == "encdec":
                cache = model.prefill_cross(params, cache, torch.zeros(
                    (B, model.cfg.enc_positions, model.cfg.d_model), device=dev))
            model.decode_step(params, cache, tok, torch.zeros((B,), dtype=torch.int32,
                                                              device=dev))
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                model.decode_step(params, cache, tok, torch.ones((B,), dtype=torch.int32,
                                                                 device=dev))
        out[arch] = sum(e.count for e in prof.key_averages())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
