"""The numbers a training cell is judged by, as the reference computes them.

A run's first ``STEPS`` steps from the seed's weights on the seed's
batches: each step's loss, each leaf's norm of the first step's clipped
gradient (what AdamW's moments receive), and each leaf's norm of the
weights' change over the steps. ``half_batch`` plants a fault: every step
takes its loss and gradients over the first half of the batch's rows only.
"""
from __future__ import annotations

import dataclasses

import torch

from bench.reference import step as ref_step
from bench.reference import tokens, weights
from bench.reference.dims import Dims

STEPS = 3               # the checked steps: set-up runs them, the reference follows


@dataclasses.dataclass
class Readings:
    losses: list            # each checked step's loss
    grads: dict             # leaf path -> norm of the first step's clipped gradient
    changes: dict           # leaf path -> norm of the weights' change over the steps


def change_norms(params: dict, dm: Dims, seed: int) -> dict:
    """Each leaf's norm of ``params`` minus the seed's initial weights, the
    initial leaf drawn again one at a time."""
    out = {}
    for path, p in params.items():
        p0 = weights.draw_leaf(dm, seed, path, p.device)
        out[path] = float(torch.linalg.vector_norm(p.float() - p0.float()))
        del p0
    return out


def reference(dm: Dims, traffic: dict, seed: int, device, prec, *,
              half_batch: bool = False) -> Readings:
    opt = ref_step.AdamW.of(traffic["optimizer"])
    B, S = traffic["global_batch"], traffic["seq_len"]
    state = ref_step.State.start(weights.draw(dm, seed, device))
    losses, grads = [], None
    for k in range(1, STEPS + 1):
        batch = tokens.batch(seed, k, B, S, dm.vocab, device)
        if half_batch:
            batch = batch[: B // 2]
        loss, norms = ref_step.train_step(state, batch, dm, opt, prec)
        losses.append(loss)
        grads = grads or norms
    changes = change_norms(state.params, dm, seed)
    return Readings(losses, grads, changes)
