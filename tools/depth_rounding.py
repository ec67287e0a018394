#!/usr/bin/env python3
"""How f32 rounding grows with depth at a smoke config's seeded init, on
the CPU: the bound ``tests/test_torch_zero.py`` needs at each depth.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/depth_rounding.py \\
        [--arch mistral-nemo-12b] [--layers 2,3] [--head-dim N]

For each depth, on the seeded reference weights of the ZeRO test
(``test_torch_models.seeded_params``, seed 0) and its batches (31
positions, 8 sequences, data seed 3, lr 1e-2 with one warmup step):

  * step 1's gradients on one device, the port (``launch.steps``'
    ``_value_and_grad``) against the reference (``jax.grad``);
  * the reference against itself on two meshes of four host devices,
    (1, 4, 1) and (1, 2, 2): step 1's gradients, and three train steps'
    losses (``launch.steps.build_train_step``, "auto").

Each line gives the largest difference of a leaf over the norm of that
leaf, and the losses' largest relative difference. Imports both packages,
as the tests do; the four host devices are set before JAX is imported.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(HERE, "src"), os.path.join(HERE, "tests")]

SEQ, BATCH, DATA_SEED, LR, STEPS = 31, 8, 3, 1e-2, 3


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def worst(a: dict, b: dict) -> float:
    import numpy as np

    return max(float(np.linalg.norm(np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64))
                     / np.linalg.norm(np.asarray(b[k], np.float64))) for k in b)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mistral-nemo-12b")
    ap.add_argument("--layers", default="2,3")
    ap.add_argument("--head-dim", type=int, default=None)
    args = ap.parse_args()

    import jax
    import numpy as np
    import torch
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs.registry import ShapeCell, build_model
    from repro.data.pipeline import DataConfig, _batch_at
    from repro.distributed.mesh import make_mesh
    from repro.launch.steps import _rebuild, build_train_step
    from repro.optim import adamw
    from repro_torch.configs import registry as treg
    from repro_torch.convert import params_from_reference
    from repro_torch.launch import train
    from repro_torch.launch.steps import _value_and_grad
    from test_torch_models import seeded_params

    for n in (int(x) for x in args.layers.split(",")):
        fields = {"n_layers": n} | ({"head_dim": args.head_dim} if args.head_dim else {})

        def ref_model(mesh=None):
            m = build_model(args.arch, mesh, smoke=True)
            return _rebuild(m, mesh, dataclasses.replace(m.cfg, **fields), "train_4k")

        jm = ref_model()
        params = seeded_params(jm, 0)
        batches = [_batch_at(DataConfig(vocab=jm.cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                                        seed=DATA_SEED), i) for i in range(STEPS)]
        ref_one = flat(jax.grad(jm.loss)(jax.tree.map(jax.numpy.asarray, params),
                                         {"tokens": jax.numpy.asarray(batches[0])}))
        tm = treg.build_model(args.arch, smoke=True)
        tm = train.rebuild(tm, dataclasses.replace(tm.cfg, **fields))
        port_one = {k: v.numpy() for k, v in flat(_value_and_grad(
            tm, params_from_reference(params, "cpu"),
            {"tokens": torch.from_numpy(np.asarray(batches[0]))})[1]).items()}
        grads, losses = {}, {}
        for shape in ((1, 4, 1), (1, 2, 2)):
            mesh = make_mesh(shape, ("pod", "data", "model"), devices=jax.devices()[:4])
            model = ref_model(mesh)
            ocfg = adamw.AdamWConfig(lr=LR, warmup_steps=1)
            b = build_train_step(model, mesh, ocfg, cell=ShapeCell("t", SEQ, BATCH, "train"))
            with mesh:
                p = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                                 params, model.param_specs(mesh))
                rows = [jax.device_put(t, NamedSharding(mesh, P(("pod", "data"), None)))
                        for t in batches]
                grads[shape] = flat(jax.jit(jax.grad(model.loss))(p, {"tokens": rows[0]}))
                step = jax.jit(b.fn, in_shardings=b.in_shardings, out_shardings=b.out_shardings)
                opt, out = adamw.init(p, ocfg), []
                for t in rows:
                    p, opt, stats = step(p, opt, {"tokens": t})
                    out.append(float(stats["loss"]))
                losses[shape] = out
        a, c = losses[(1, 4, 1)], losses[(1, 2, 2)]
        print(f"{args.arch} {fields}: step 1's gradients, port against reference on one device "
              f"{worst(port_one, ref_one):.3g}; reference (1, 4, 1) against (1, 2, 2) "
              f"{worst(grads[(1, 4, 1)], grads[(1, 2, 2)]):.3g}; losses {a} and {c}, "
              f"{max(abs(x - y) / abs(y) for x, y in zip(a, c)):.3g} apart", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
