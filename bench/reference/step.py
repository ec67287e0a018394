"""The reference train step: forward, autograd backward, global-norm clip
and AdamW, in float32, the weights stored between steps in the
configuration's type.

AdamW as the published algorithm (Loshchilov and Hutter), with the bias
corrections, the decay decoupled and scaled by the learning rate, a linear
warm-up of the learning rate over ``warmup_steps``, and the gradients
scaled by min(1, grad_clip / (global norm + 1e-9)) before the moments.
The moments are float32. The new weights are rounded to the storage type,
as the configuration stores them.

Rows of a batch are run in blocks of ``ROWS_PER_BLOCK`` so that the
activations fit: a dense model's rows are independent; a MoE's routing
ranks all of a step's tokens together, so its step is one block. The head and the loss run over chunks
of positions of the final hidden states (their gradient is gathered, then
sent back through the blocks in one backward).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from bench.reference import model
from bench.reference.dims import Dims

HEAD_CHUNK = 1024      # positions per chunk of the head and the loss
ROWS_PER_BLOCK = 2     # a dense model's rows a block (a 2048-position row of d 5120 fits)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float
    warmup_steps: int
    b1: float
    b2: float
    eps: float
    weight_decay: float
    grad_clip: float

    @classmethod
    def of(cls, opt: dict) -> "AdamW":
        return cls(**{f.name: opt[f.name] for f in dataclasses.fields(cls)})


@dataclasses.dataclass
class State:
    """Weights (storage type) and float32 moments, keyed by leaf path."""
    params: dict
    m: dict
    v: dict
    step: int = 0

    @classmethod
    def start(cls, params: dict) -> "State":
        zeros = {k: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                 for k, t in params.items()}
        return cls(params, zeros, {k: z.clone() for k, z in zeros.items()})


def loss_and_grads(params: dict, tokens, dm: Dims, prec, rows_per_block: int = ROWS_PER_BLOCK,
                   route: list | None = None):
    """Mean next-token loss of ``tokens`` (B, S+1) and the float32 gradient
    of every leaf."""
    p32 = {k: t.detach().to(torch.float32, copy=True).requires_grad_(True)
           for k, t in params.items()}
    B = tokens.shape[0]
    n = B * (tokens.shape[1] - 1)
    if dm.family == "moe":
        rows_per_block = B
    total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for r in range(0, B, rows_per_block):
        blk = tokens[r:r + rows_per_block]
        h = model.hidden(p32, blk[:, :-1], dm, prec, route)
        flat = h.reshape(-1, dm.d)
        cut = flat.detach().requires_grad_(True)
        labels = blk[:, 1:].reshape(-1)
        for c in range(0, cut.shape[0], HEAD_CHUNK):
            part = model.nll_sum(cut[c:c + HEAD_CHUNK], model.out_weight(p32, dm),
                                 labels[c:c + HEAD_CHUNK], prec) / n
            part.backward()
            total += part.detach()
        flat.backward(cut.grad)
    grads = {k: (t.grad if t.grad is not None else torch.zeros_like(t)) for k, t in p32.items()}
    return total, grads


def leaf_norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(t.float())) for k, t in tree.items()}


@torch.no_grad()
def adamw(state: State, grads: dict, opt: AdamW) -> dict:
    """One AdamW update of ``state`` in place; returns the clipped gradients'
    leaf norms."""
    gnorm = math.sqrt(sum(float(torch.sum(g.double() ** 2)) for g in grads.values()))
    scale = min(1.0, opt.grad_clip / (gnorm + 1e-9))
    state.step += 1
    t = state.step
    lr = opt.lr * min(1.0, t / max(opt.warmup_steps, 1))
    c1, c2 = 1.0 - opt.b1 ** t, 1.0 - opt.b2 ** t
    norms = {}
    for k, g in grads.items():
        g = g * scale
        norms[k] = float(torch.linalg.vector_norm(g))
        m = state.m[k].mul_(opt.b1).add_(g, alpha=1.0 - opt.b1)
        v = state.v[k].mul_(opt.b2).addcmul_(g, g, value=1.0 - opt.b2)
        p = state.params[k]
        p32 = p.float()
        p32 -= lr * ((m / c1) / (torch.sqrt(v / c2) + opt.eps) + opt.weight_decay * p32)
        state.params[k] = p32.to(p.dtype)
    return norms


def train_step(state: State, tokens, dm: Dims, opt: AdamW, prec):
    """One step in place; returns (loss, the clipped gradients' leaf norms)."""
    loss, grads = loss_and_grads(state.params, tokens, dm, prec)
    norms = adamw(state, grads, opt)
    return float(loss), norms
