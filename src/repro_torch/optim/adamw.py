"""AdamW with global-norm clipping and configurable state dtype.

Twin of ``repro.optim.adamw``: plain functions on trees of tensors, not
``torch.optim``, so that m and v mirror the params tree leaf for leaf and
the checkpoint's ``opt/m/...`` and ``opt/v/...`` leaves are the
reference's. Leaves of the params, grads and state trees are matched by
their key path, not by their order. Updates are computed in f32 whatever
the storage dtype; the state is cast back to ``state_dtype`` and the params
to their own dtype.

Over a ``model`` axis each rank holds blocks of the sharded leaves: the
global norm of the clip sums their squares over ``model`` (``sharded``, a
tree of flags, and ``group``) and counts each whole leaf once, so every
model rank clips by the same scale.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, NamedTuple

import torch
import torch.distributed as dist

from repro_torch.distributed.mesh import P


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: torch.dtype = torch.float32
    warmup_steps: int = 100


class OptState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts, the leaves of ``rest`` looked
    up by the same keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def init(params: Any, cfg: AdamWConfig) -> OptState:
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)  # noqa: E731
    device = next(tree_leaves(params)).device
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=tree_map(zeros, params),
        v=tree_map(zeros, params),
    )


def state_specs(param_specs: Any) -> OptState:
    """Optimizer-state PartitionSpecs mirror the param specs (ZeRO-sharded)."""
    return OptState(step=P(), m=param_specs, v=param_specs)


def global_norm(grads: Any, sharded: Any = None, group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in f32. Where
    ``sharded`` flags a leaf as this rank's block of a leaf split over
    ``group``, the blocks' sums are summed over the group; every other leaf
    counts once."""
    def sq(g):
        return torch.sum(torch.square(g.float()))

    if sharded is None:
        return torch.sqrt(sum(sq(g) for g in tree_leaves(grads)))
    pairs = []
    tree_map(lambda g, split: pairs.append((g, split)), grads, sharded)
    part = torch.zeros((), dtype=torch.float32, device=pairs[0][0].device)
    for g, split in pairs:
        if split:
            part = part + sq(g)
    dist.all_reduce(part, group=group)
    for g, split in pairs:
        if not split:
            part = part + sq(g)
    return torch.sqrt(part)


def _schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


@torch.no_grad()
def apply(params: Any, grads: Any, state: OptState, cfg: AdamWConfig, *,
          sharded: Any = None, group=None):
    """Returns (new_params, new_state, stats); ``sharded`` and ``group`` as
    in ``global_norm``."""
    gnorm = global_norm(grads, sharded, group)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = _schedule(step, cfg)
    stepf = step.float()
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)

    def upd(p, g, m, v):
        g = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(g)
        mh = m32 / b1c
        vh = v32 / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        newp = p.float() - lr * delta
        return newp.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    out = tree_map(upd, params, grads, state.m, state.v)
    pick = lambda i: tree_map(lambda o: o[i], out)  # noqa: E731
    return pick(0), OptState(step, pick(1), pick(2)), {"grad_norm": gnorm, "lr": lr}
