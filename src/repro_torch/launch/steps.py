"""Step builders: train / prefill / decode.

Twin of ``repro.launch.steps`` on a world of one device. The train step is
forward, backward (``torch.autograd.grad`` over the params tree) and AdamW;
microbatches accumulate the gradients in f32 (the reference's grad
accumulation over a scan), which bounds activation memory.

``sync_mode``: "auto" is one step on one device. "chunked" crosses pods
through the chunked collectives; on one pod it is the same path, exactly as
the reference decides (``n_pods > 1``). A mesh of more than one pod raises
until ``repro_torch.distributed`` is ported (ROADMAP Queue 1). The dry
run's ``build_cell`` waits with it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.registry import SHAPES, ShapeCell
from repro_torch.distributed.mesh import POD, axis_size
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves, tree_map


@dataclasses.dataclass
class StepBundle:
    """One step function and what it runs."""

    fn: Callable
    model: Any
    kind: str


def _value_and_grad(model, params, batch):
    """(loss, grads) of ``model.loss`` with grads shaped as ``params``."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = model.loss(leaves, batch)
        flat = list(tree_leaves(leaves))
        grads = torch.autograd.grad(loss, flat)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _p: next(it), leaves)


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------
def build_train_step(
    model,
    mesh=None,
    ocfg: adamw.AdamWConfig | None = None,
    *,
    cell: ShapeCell | None = None,
    microbatches: int = 1,
    sync_mode: str = "auto",
) -> StepBundle:
    ocfg = ocfg or adamw.AdamWConfig(
        state_dtype=torch.bfloat16 if model.cfg.param_count() > 1e11 else torch.float32
    )
    cell = cell or SHAPES["train_4k"]
    if sync_mode not in ("auto", "chunked", "chunked_bf16"):
        raise ValueError(f"sync_mode {sync_mode!r}")
    n_pods = axis_size(mesh, POD) if mesh is not None else 1
    if sync_mode != "auto" and n_pods > 1:
        raise NotImplementedError(
            f"sync_mode {sync_mode!r} over {n_pods} pods needs the chunked "
            "collectives (ROADMAP Queue 1, distributed/)")
    if cell.global_batch % microbatches:
        raise ValueError(f"global batch {cell.global_batch} does not split into "
                         f"{microbatches} microbatches")

    def grads_of(params, batch):
        if microbatches == 1:
            return _value_and_grad(model, params, batch)
        acc_l = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
        acc_g = None
        for mb in range(microbatches):
            part = {k: v.chunk(microbatches, dim=0)[mb] for k, v in batch.items()}
            l, g = _value_and_grad(model, params, part)
            acc_l = acc_l + l
            g32 = tree_map(lambda x: x.float(), g)
            acc_g = g32 if acc_g is None else tree_map(torch.add, acc_g, g32)
        inv = 1.0 / microbatches
        return acc_l * inv, tree_map(lambda g: (g * inv).to(model.cfg.dtype), acc_g)

    def step(params, opt, batch):
        loss, grads = grads_of(params, batch)
        params, opt, stats = adamw.apply(params, grads, opt, ocfg)
        return params, opt, {"loss": loss, **stats}

    return StepBundle(step, model, "train")


# ---------------------------------------------------------------------------
# prefill (forward producing logits — the compute profile of ingest)
# ---------------------------------------------------------------------------
def build_prefill_step(model, mesh=None) -> StepBundle:
    """Last-position logits of a batch: an encdec's decoder over its encoded
    ``audio_embed``, a vlm's tokens after their ``vis_embed`` prefix."""
    family = model.cfg.family
    if family == "encdec":
        def hidden(params, batch):
            enc = model.encode(params, batch["audio_embed"])
            return model.dec_hidden(params, batch["tokens"], enc)
    elif family == "vlm":
        def hidden(params, batch):
            return model.hidden_mm(params, batch["tokens"], batch["vis_embed"])
    else:
        def hidden(params, batch):
            return model.hidden(params, batch["tokens"])

    @torch.no_grad()
    def prefill(params, batch):
        h = hidden(params, batch)
        return torch.einsum("bsd,dv->bsv", h[:, -1:], model._out_w(params))

    return StepBundle(prefill, model, "prefill")


# ---------------------------------------------------------------------------
# decode (one serve step: next-token + cache update)
# ---------------------------------------------------------------------------
def build_serve_step(model, mesh=None) -> StepBundle:
    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        logits, cache = model.decode_step(params, cache, tokens, pos)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return nxt[:, None], cache, pos + 1

    return StepBundle(serve_step, model, "decode")
