"""Batched greedy serving launcher (prefill via the decode loop + generation).

Twin of ``repro.launch.serve`` on one device (the card unless ``--device
cpu``), with ``--layers`` to cut depth as ``launch.train`` does:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b --smoke \\
      --device cpu --batch 4 --prompt-len 12 --gen 16
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import build_model
from repro_torch.launch.train import parse_mesh, with_layers


@torch.no_grad()
def generate(model, params, prompts: torch.Tensor, gen: int, max_len: int) -> torch.Tensor:
    """Greedy decode: feed prompt tokens, then sample ``gen`` new ones. An
    encdec serves through ``prefill_cross`` and the serve step instead."""
    if model.cfg.family == "encdec":
        raise NotImplementedError("use prefill_cross + decode for enc-dec")
    B, Lp = prompts.shape
    cache = model.init_cache(B, max_len, device=prompts.device)
    tok = prompts[:, :1]
    out = [tok]
    for t in range(Lp + gen - 1):
        pos = torch.full((B,), t, dtype=torch.int32, device=prompts.device)
        logits, cache = model.decode_step(params, cache, tok, pos)
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        tok = prompts[:, t + 1 : t + 2] if t + 1 < Lp else nxt
        out.append(tok)
    return torch.cat(out, dim=1)


def prompts_for(seed: int, batch: int, prompt_len: int, vocab: int, device) -> torch.Tensor:
    """The seeded prompt (int32), drawn on the host so every device gets the same."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (batch, prompt_len), generator=gen,
                         dtype=torch.int32).to(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--layers", type=int, default=None,
                    help="override the config's n_layers (depth only)")
    args = ap.parse_args(argv)

    mesh = parse_mesh(args.mesh, args.device)
    model = with_layers(build_model(args.arch, mesh, smoke=args.smoke), args.layers)
    params = model.init_params(args.seed, mesh.device)
    prompts = prompts_for(args.seed, args.batch, args.prompt_len, model.cfg.vocab, mesh.device)
    t0 = time.perf_counter()
    seqs = generate(model, params, prompts, args.gen, args.prompt_len + args.gen)
    out = seqs.cpu().numpy()                   # waits for the device
    dt = time.perf_counter() - t0
    n_new = args.batch * args.gen
    steps = args.prompt_len + args.gen - 1
    print(f"generated {n_new} tokens in {dt:.2f}s "
          f"({n_new/dt:.1f} tok/s incl. prefill; {dt / steps * 1e3:.2f} ms per decode step)")
    print("sample:", out[0].tolist())
    return np.asarray(out)


if __name__ == "__main__":
    main()
