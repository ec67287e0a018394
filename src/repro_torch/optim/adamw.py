"""AdamW with global-norm clipping and configurable state dtype.

Twin of ``repro.optim.adamw``: plain functions on trees of tensors, not
``torch.optim``, so that m and v mirror the params tree leaf for leaf and
the checkpoint's ``opt/m/...`` and ``opt/v/...`` leaves are the
reference's. Leaves of the params, grads and state trees are matched by
their key path, not by their order. Updates are computed in f32 whatever
the storage dtype; the state is cast back to ``state_dtype`` and the params
to their own dtype.

Over a ``data`` or a ``model`` axis each rank holds blocks of the cut
leaves, and m and v take the same blocks (``state_specs``, ZeRO-3): the
global norm of the clip sums the blocks' squares over the groups of the
axes that cut them (``sharded``, a tree of axis tuples, and ``groups``)
and counts each whole leaf once, so every rank clips by the same scale.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, NamedTuple

import torch
import torch.distributed as dist


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
    from repro_torch.distributed.mesh import P    # distributed imports this module

    return OptState(step=P(), m=param_specs, v=param_specs)


def global_norm(grads: Any, sharded: Any = None, groups: dict | None = None) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in f32. ``sharded``
    gives, a leaf, the mesh axes it is cut over (``()``: whole), and
    ``groups`` each axis's process group: a block's sum is summed over the
    groups of its axes (``data``, ``model`` or both), and every whole leaf
    counts once."""
    def sq(g):
        return torch.sum(torch.square(g.float()))

    if sharded is None:
        return torch.sqrt(sum(sq(g) for g in tree_leaves(grads)))
    pairs = []
    tree_map(lambda g, axes: pairs.append((g, tuple(axes))), grads, sharded)
    zero = torch.zeros((), dtype=torch.float32, device=pairs[0][0].device)
    parts: dict[tuple, torch.Tensor] = {}
    for g, axes in pairs:
        parts[axes] = parts.get(axes, zero) + sq(g)
    total = parts.pop((), zero)
    for axes in sorted(parts):              # the same order on every rank
        part = parts[axes]
        for a in axes:
            dist.all_reduce(part, group=groups[a])
        total = total + part
    return torch.sqrt(total)


def _schedule(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


# A leaf of more elements than this is updated in slices of its leading
# dim (the layer dim of a stacked leaf) of at most this many elements: the
# f32 temporaries of the update then stay a slice's, not the leaf's
# (mistral-nemo-12b's ``wi`` block is 2.9 GB a temporary in f32). The
# arithmetic is elementwise, so the result is the same bit for bit.
UPDATE_SLICE_ELEMENTS = 1 << 26


@torch.no_grad()
def apply(params: Any, grads: Any, state: OptState, cfg: AdamWConfig, *,
          sharded: Any = None, groups: dict | None = None):
    """Returns (new_params, new_state, stats); ``sharded`` and ``groups``
    as in ``global_norm``."""
    gnorm = global_norm(grads, sharded, groups)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = _schedule(step, cfg)
    stepf = step.float()
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)

    def upd_slice(p, g, m, v):
        g = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(g)
        mh = m32 / b1c
        vh = v32 / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        newp = p.float() - lr * delta
        return newp.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    def upd(p, g, m, v):
        if p.dim() < 2 or p.numel() <= UPDATE_SLICE_ELEMENTS:
            return upd_slice(p, g, m, v)
        rows = max(1, UPDATE_SLICE_ELEMENTS // (p.numel() // p.shape[0]))
        outs = (torch.empty_like(p), torch.empty_like(m), torch.empty_like(v))
        for i in range(0, p.shape[0], rows):
            sl = slice(i, i + rows)
            for o, r in zip(outs, upd_slice(p[sl], g[sl], m[sl], v[sl])):
                o[sl] = r
        return outs

    out = tree_map(upd, params, grads, state.m, state.v)
    pick = lambda i: tree_map(lambda o: o[i], out)  # noqa: E731
    return pick(0), OptState(step, pick(1), pick(2)), {"grad_norm": gnorm, "lr": lr}
