"""Batched greedy serving launcher (prefill via the decode loop + generation).

Twin of ``repro.launch.serve`` (the card unless ``--device cpu``), with
``--layers`` to cut depth as ``launch.train`` does. Over a mesh of more
than one device it runs as one rank of a world, as ``launch.train.main``
does: every rank draws the one-device weights from the seed and keeps its
blocks of them (``param_specs``, the reference's default layout), the
cache is cut by ``cache_specs`` (the batch over pod x data; time, heads or
channels over ``model``) and each rank decodes its batch rows; rank 0
prints. At a batch that pod x data does not divide (``--batch 1``) every
rank decodes every row and the cache's time is cut over ``data`` and
``pod`` as well as ``model``: no rank holds the whole cache. An encdec
raises in ``generate`` here, as the reference's does.
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b --smoke \\
      --device cpu --batch 4 --prompt-len 12 --gen 16
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc_per_node 4 \\
      -m repro_torch.launch.serve --arch gemma-2b --smoke --device cpu --mesh 1x1x4
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc_per_node 4 \\
      -m repro_torch.launch.serve --arch gemma2-2b --smoke --device cpu --mesh 1x2x2 --batch 1
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.registry import build_model
from repro_torch.distributed.mesh import P, is_primary, shard
from repro_torch.launch.train import parse_mesh, shard_state, with_layers
from repro_torch.models.common import cache_batch_spec


@torch.no_grad()
def generate(model, params, prompts: torch.Tensor, gen: int, max_len: int) -> torch.Tensor:
    """Greedy decode: feed prompt tokens, then sample ``gen`` new ones. An
    encdec serves through ``prefill_cross`` and the serve step instead.
    Over a mesh of more than one rank, ``params`` are this rank's blocks,
    the cache is cut by ``cache_specs`` and the rank decodes its rows of
    ``prompts`` (all of them where pod x data does not divide the batch):
    it returns those rows."""
    if model.cfg.family == "encdec":
        raise NotImplementedError("use prefill_cross + decode for enc-dec")
    mesh = model.mesh
    B, Lp = prompts.shape
    cache = model.init_cache(B, max_len, device=prompts.device)
    kw = {}
    if mesh is not None and mesh.size > 1:
        specs = model.cache_specs(mesh, B, max_len)
        cache = shard_state(mesh, cache, specs)
        prompts = shard(mesh, prompts, P(cache_batch_spec(mesh, B), None))
        B, kw = prompts.shape[0], {"cache_specs": specs}
    tok = prompts[:, :1]
    out = [tok]
    for t in range(Lp + gen - 1):
        pos = torch.full((B,), t, dtype=torch.int32, device=prompts.device)
        logits, cache = model.decode_step(params, cache, tok, pos, **kw)
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
    if mesh.size > 1:
        params = shard_state(mesh, params, model.param_specs(mesh))
    prompts = prompts_for(args.seed, args.batch, args.prompt_len, model.cfg.vocab, mesh.device)
    t0 = time.perf_counter()
    seqs = generate(model, params, prompts, args.gen, args.prompt_len + args.gen)
    out = seqs.cpu().numpy()                   # waits for the device
    dt = time.perf_counter() - t0
    n_new = args.batch * args.gen
    steps = args.prompt_len + args.gen - 1
    log = print if is_primary() else (lambda *_a, **_k: None)
    log(f"generated {n_new} tokens in {dt:.2f}s "
        f"({n_new/dt:.1f} tok/s incl. prefill; {dt / steps * 1e3:.2f} ms per decode step)")
    log("sample:", out[0].tolist())
    return np.asarray(out)


if __name__ == "__main__":
    try:
        main()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
