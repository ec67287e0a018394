"""Training launcher: data pipeline -> train_step -> chunked checkpoints.

Twin of ``repro.launch.train``, on the card unless ``--device cpu``: on one
device, or as one rank of a world of ranks, one device each (the mesh's
axes laid over the world, ``distributed.mesh.make_mesh``). Fault tolerance
is the reference's:

  * checkpoints are chunked + integrity-checked + journaled
    (``repro_torch.ckpt``), every digest taken on the device: a crash
    mid-save leaves a resumable journal, a crash between saves restarts
    from the latest verified step;
  * the data pipeline is (seed, step)-keyed, so a restore at step N resumes
    the exact sample order;
  * the checkpoint tree is ``{"params", "opt": {"step", "m", "v"}}`` with
    the reference's leaf names, shapes and dtypes, so either package
    resumes the other's checkpoints;
  * **elastic restart**: checkpoints hold whole leaves, so a root saved by
    four ranks resumes on two, over data and over data x model (``--mesh
    2x2`` to ``1x2``, as the reference's test does; ``2x2x1`` and ``1x4x1``
    to ``1x2x1``; ``1x2x2`` to ``1x1x2``).
    A MoE's whole expert leaves are laid out for the model axis's size
    (``(layers, tp, E/tp, ...)``), so its root resumes on that size only:
    on another, the restore raises (a dim that does not split) or the
    first step does, as the reference's.

On a world of ranks every rank draws the whole params from the same seed
(the one-device weights) and keeps its blocks of them
(``distributed.mesh.shard`` under the model's ``param_specs``): over
``model`` for tensor parallelism and over ``data`` for ZeRO-3, so the
ranks of one pod hold the blocks of one model and AdamW's moments the same
blocks; the pods stay equal, since every step applies the same
synchronised gradients. Rank 0 writes the whole tree, the MANIFEST of a
one-device run: each cut leaf is gathered over pod 0's data x model ranks
just before it is written (``save_checkpoint(materialize=)``, one leaf at
a time) and digested on the device, while the other pods wait at a
barrier. Every rank reads the root onto its own device, checking every
chunk there, and keeps its blocks leaf by leaf
(``restore_checkpoint(keep=)``), so no rank holds the whole tree. Rank 0
prints; ``main`` returns the same dict on every rank.

Where the port differs: ``--device`` (default ``cuda``; a request for the
card without one raises) and ``--layers N``, which overrides the config's
``n_layers`` (an encdec's ``n_enc_layers`` too; depth only, never width) so
a full-width model fits a run. An encdec's batch carries zero frame
embeddings and a vlm's zero patch embeddings beside the tokens, as the
reference's. ``main`` also returns each step's seconds and grad norm, and
this rank's params (its blocks over ``data`` and ``model``).

Usage (CPU, reduced config; then four ranks, one card each, over pod x
data and over data x model):
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b --smoke \\
      --device cpu --steps 40 --ckpt-dir /tmp/ck --ckpt-every 10
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc_per_node 4 \\
      -m repro_torch.launch.train --arch gemma-2b --smoke --mesh 2x2x1 \\
      --sync-mode chunked --steps 40 --ckpt-dir /tmp/ck4 --ckpt-every 10
  PYTHONPATH=src python -m torch.distributed.run --standalone --nproc_per_node 4 \\
      -m repro_torch.launch.train --arch gemma-2b --smoke --mesh 1x1x4 --steps 40
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.ckpt import CheckpointManager
from repro_torch.ckpt.checkpoint import _flatten
from repro_torch.configs.registry import ShapeCell, build_model
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.distributed.mesh import (
    DATA, MODEL, POD, axis_size, cut_axes, gather, is_primary, make_mesh, shard)
from repro_torch.launch.steps import _rebuild, _with_layers, build_train_step
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_map


def parse_mesh(spec: str, device="cuda"):
    dims = [int(x) for x in spec.split("x")]
    if len(dims) == 2:
        names = ("data", "model")
    elif len(dims) == 3:
        names = ("pod", "data", "model")
    else:
        raise ValueError(spec)
    return make_mesh(tuple(dims), names, device=device)


rebuild = _rebuild     # the launchers' name for the reference's ``_rebuild``


def with_layers(model, n_layers: int | None):
    """The same arch at ``n_layers`` layers (width unchanged,
    ``steps._with_layers``); no override keeps ``model``."""
    if not n_layers:
        return model
    return _with_layers(model, n_layers)


def modality_inputs(cfg, batch: int, device) -> dict:
    """The stubbed frontends' inputs a batch carries beside its tokens, zeros
    as the reference's launcher adds them: an encdec's frame embeddings
    ``audio_embed`` (batch, enc_positions, D), a vlm's patch embeddings
    ``vis_embed`` (batch, n_vis_tokens, D)."""
    rows = {"encdec": ("audio_embed", cfg.enc_positions),
            "vlm": ("vis_embed", cfg.n_vis_tokens)}.get(cfg.family)
    if rows is None:
        return {}
    key, n = rows
    return {key: torch.zeros((batch, n, cfg.d_model), dtype=cfg.dtype, device=device)}


def checkpoint_specs(model, mesh):
    """PartitionSpecs of the checkpoint tree ``{"params", "opt": {"step",
    "m", "v"}}``; None where no leaf is cut (no ``data`` or ``model`` axis
    over 1)."""
    if axis_size(mesh, DATA) == 1 and axis_size(mesh, MODEL) == 1:
        return None
    specs = model.param_specs(mesh)
    o = adamw.state_specs(specs)
    return {"params": specs, "opt": {"step": o.step, "m": o.m, "v": o.v}}


def shard_state(mesh, tree, specs):
    """This rank's blocks of a whole tree: a copy of each leaf that is cut,
    so the whole leaf can be freed."""
    if specs is None:
        return tree
    return tree_map(lambda t, s: shard(mesh, t, s).clone() if cut_axes(mesh, s) else t,
                    tree, specs)


def _flat_specs(specs, prefix: str = "") -> dict:
    """The specs keyed as ``ckpt.checkpoint._flatten`` keys the leaves."""
    out = {}
    for k, v in specs.items():
        if isinstance(v, dict):
            out.update(_flat_specs(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def save_whole(mgr: CheckpointManager, step: int, tree, mesh, specs):
    """Rank 0 saves the whole tree (the report; None elsewhere), the
    MANIFEST of a one-device run. Each cut leaf is gathered over pod 0's
    data x model ranks, in the checkpoint's leaf order, as rank 0 writes
    it (one whole leaf at a time); every rank of pod 0 takes part, and
    every other rank waits at the caller's barrier."""
    if specs is None:
        return mgr.save(step, tree) if is_primary() else None
    flat = _flat_specs(specs)

    def whole(key, t):
        return gather(mesh, t, flat[key])

    if is_primary():
        return mgr.save(step, tree, materialize=whole)
    if mesh.rank(POD) == 0:
        for key, t in _flatten(tree).items():
            whole(key, t)
    return None


def restore_into(mgr: CheckpointManager, mesh=None, specs=None):
    """Restore the latest checkpoint onto the manager's device (the
    mesh's), keeping this rank's blocks leaf by leaf as each leaf is
    verified: a rank holds its blocks and at most one whole leaf, never
    the whole tree."""
    keep = None
    if specs is not None:
        flat = _flat_specs(specs)

        def keep(key, t):
            s = flat[key]
            return shard(mesh, t, s).clone() if cut_axes(mesh, s) else t

    tree, step = mgr.restore(keep=keep)
    o = tree["opt"]
    return tree["params"], adamw.OptState(step=o["step"], m=o["m"], v=o["v"]), step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--sync-mode", default="auto", choices=["auto", "chunked"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--layers", type=int, default=None,
                    help="override the config's n_layers (depth only)")
    args = ap.parse_args(argv)

    mesh = parse_mesh(args.mesh, args.device)
    dev = mesh.device
    model = with_layers(build_model(args.arch, mesh, smoke=args.smoke), args.layers)
    cfg = model.cfg
    cell = ShapeCell("custom", args.seq_len, args.global_batch, "train")
    ocfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=10)
    step_fn = build_train_step(model, mesh, ocfg, cell=cell,
                               microbatches=args.microbatches,
                               sync_mode=args.sync_mode).fn

    log = print if is_primary() else (lambda *_a, **_k: None)
    mgr = CheckpointManager(args.ckpt_dir, device=dev) if args.ckpt_dir else None
    specs = checkpoint_specs(model, mesh)
    start = 0
    if mgr is not None and mgr.latest_step() is not None:
        t0 = time.perf_counter()
        params, opt, start = restore_into(mgr, mesh, specs)
        log(f"[restore] resumed from step {start} ({mgr.root}) "
            f"in {time.perf_counter() - t0:.2f}s", flush=True)
    else:
        params = model.init_params(args.seed, dev)
        if specs is not None:
            params = shard_state(mesh, params, specs["params"])
        opt = adamw.init(params, ocfg)

    data = TokenPipeline(
        DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                   global_batch=args.global_batch, seed=args.seed),
        mesh, start_step=start)

    losses, step_seconds, grad_norms = [], [], []
    t0 = time.perf_counter()
    try:
        for step in range(start, args.steps):
            t_step = time.perf_counter()
            batch = next(data)
            batch.update(modality_inputs(cfg, batch["tokens"].shape[0], dev))
            params, opt, stats = step_fn(params, opt, batch)
            loss = float(stats["loss"])        # waits for the step
            step_seconds.append(time.perf_counter() - t_step)
            losses.append(loss)
            grad_norms.append(float(stats["grad_norm"]))
            if args.log_every and (step + 1) % args.log_every == 0:
                dt = (time.perf_counter() - t0) / max(1, len(losses))
                log(f"step {step+1:5d}  loss {loss:8.4f}  "
                    f"gnorm {float(stats['grad_norm']):8.3f}  {dt*1e3:6.0f} ms/step",
                    flush=True)
            if mgr is not None and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
                rep = save_whole(mgr, step + 1, {"params": params, "opt": {
                    "step": opt.step, "m": opt.m, "v": opt.v}}, mesh, specs)
                if rep is not None:
                    log(f"[ckpt] step {step+1}: {rep.total_bytes/1e6:.1f} MB "
                        f"in {rep.seconds:.2f}s (resumed_chunks={rep.resumed_chunks})",
                        flush=True)
                if mesh.size > 1:
                    dist.barrier()
    finally:
        data.close()
    return {"losses": losses, "final_loss": losses[-1] if losses else None,
            "step_seconds": step_seconds, "grad_norms": grad_norms, "params": params}


if __name__ == "__main__":
    try:
        out = main()
        if is_primary():
            print(f"final loss: {out['final_loss']:.4f}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
