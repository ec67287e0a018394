#!/usr/bin/env python3
"""Where a train step and a decode step of the port spend the card's time.

    python3 tools/train_profile.py [--arch gemma-2b] [--layers 2] [--seq-len 2048]
                                   [--global-batch 4] [--steps 2] [--out FILE]
                                   [--device cpu --smoke]

``--arch`` (gemma-2b by default; any arch the port's registry builds) at
full width (``repro_torch.launch``'s model, cut to ``--layers`` of its
layers, 0 for all of them, bf16, seeded weights), the train step of
``launch.steps.build_train_step`` (remat, chunked cross-entropy, AdamW) on
the data pipeline's batches (an encdec's and a vlm's with the launcher's
zero frame or patch embeddings), and the decode step of ``launch.serve``
at batch 4 over a 96-token cache (an encdec's after ``prefill_cross``).
After two untimed warm-up steps each, ``torch.profiler`` records
``--steps`` steps. Prints, and writes to
``--out``, one JSON object: the wall milliseconds a step (host clock around
steps that end in a synchronize), the device milliseconds a step summed
over kernels, the device's idle share of the wall time, and the kernels
with the most device time, grouped by name, each with its share; with the
card's name and power limit. ``--device cpu --smoke`` rehearses the script
on the smoke config: the times are the host's, not a measurement of the
card. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import ShapeCell, build_model
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.serve import prompts_for
    from repro_torch.launch.steps import build_serve_step, build_train_step
    from repro_torch.launch.train import modality_inputs, with_layers
    from repro_torch.optim import adamw

    device = torch.device(args.device)
    on_card = device.type == "cuda"
    if on_card:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip().splitlines()[0]
    else:
        smi = "cpu (rehearsal: not a measurement)"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    model = with_layers(build_model(args.arch, smoke=args.smoke), args.layers)
    params = model.init_params(0, device)
    ocfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=10)
    opt = adamw.init(params, ocfg)
    cell = ShapeCell("custom", args.seq_len, args.global_batch, "train")
    train_step = build_train_step(model, None, ocfg, cell=cell).fn
    data = TokenPipeline(DataConfig(vocab=model.cfg.vocab, seq_len=args.seq_len,
                                    global_batch=args.global_batch), device=device)
    serve_step = build_serve_step(model).fn
    B, prompt, gen = 4, 64, 32
    prompts = prompts_for(0, B, prompt, model.cfg.vocab, device)

    def run_train(n):
        nonlocal params, opt
        for _ in range(n):
            batch = next(data)
            batch.update(modality_inputs(model.cfg, args.global_batch, device))
            params, opt, stats = train_step(params, opt, batch)
            float(stats["loss"])

    def run_decode(n):
        cache = model.init_cache(B, prompt + gen, device=device)
        if model.cfg.family == "encdec":           # zero frames, as the train batches carry
            cache = model.prefill_cross(params, cache,
                                        modality_inputs(model.cfg, B, device)["audio_embed"])
        tok, pos = prompts[:, :1], torch.zeros(B, dtype=torch.int32, device=device)
        for t in range(n):
            tok, cache, pos = serve_step(params, cache, tok, pos)
            if t + 1 < prompt:
                tok = prompts[:, t + 1:t + 2]
        sync()

    def measure(fn, n):
        fn(2)                                   # warm-up
        sync()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn(n)
            sync()
            wall = (time.perf_counter() - t0) / n
        rows = []
        for ev in prof.key_averages():
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "self_cuda_time_total", 0)
            us = dev_us if on_card else ev.self_cpu_time_total
            if us > 0:
                rows.append((ev.key, us / n / 1e3, ev.count // n))
        # on the card, the kernels' device time; on the CPU every op's self time
        kernels = [r for r in rows if not on_card or not r[0].startswith("aten::")]
        busy = sum(ms for _, ms, _ in kernels)
        kernels.sort(key=lambda r: -r[1])
        return {"wall_ms": wall * 1e3, "device_ms": busy if on_card else None,
                "idle_share": (1 - busy / (wall * 1e3)) if on_card else None,
                "top": [{"name": k[:120], "ms": ms, "share_of_device": ms / busy if busy else None,
                         "calls": calls} for k, ms, calls in kernels[: args.top]]}

    dtype = str(model.cfg.dtype).replace("torch.", "")
    out = {"card": smi, "config": f"{args.arch}, {model.cfg.n_layers} layers, {dtype}, seq {args.seq_len}, "
                                  f"batch {args.global_batch}" + (" (smoke)" if args.smoke else ""),
           "train": measure(run_train, args.steps),
           "decode": measure(run_decode, prompt + gen - 1)}
    data.close()
    line = json.dumps(out)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")


if __name__ == "__main__":
    main()
