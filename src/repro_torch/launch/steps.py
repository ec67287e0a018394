"""Step builders: train / prefill / decode.

Twin of ``repro.launch.steps``. The train step is forward, backward
(``torch.autograd.grad`` over the params tree) and AdamW; microbatches
accumulate the gradients in f32 (the reference's grad accumulation over a
scan), which bounds activation memory.

On a mesh of more than one rank every rank runs the step on its own rows
of the batch (``data.pipeline.TokenPipeline``: the batch splits over pod x
data, and the ranks of one ``model`` group share their rows), and
``sync_mode`` picks how the gradients and the loss are meaned over the
batch axes: "auto" is one monolithic ``dist.all_reduce`` a leaf over the
pod x data group (``Mesh.batch_group``), the baseline GSPMD emits in the
reference; "chunked" means over ``data`` with that all-reduce (GSPMD's part
in the reference), then over ``pod`` with ``distributed.fsdp.cross_pod_mean``'s
chunked rings, each on this model rank's blocks; "chunked_bf16" casts the
gradients to bf16 for the cross-pod rings and back. On one pod the chunked
modes take the auto path, exactly as the reference decides
(``n_pods > 1``). Over a ``model`` axis the params are this rank's blocks
(``param_specs``), the model's forward brackets its products with the
model group's collectives, and AdamW's clip norm sums the sharded leaves'
squares over that group. Over a ``data`` axis (ZeRO-3) every weight, its
m and v are cut by ``d_model`` too: the forward gathers each layer's
weights over the data group and the backward reduce-scatters their
gradients, so such a leaf's block arrives summed over ``data`` and only
its ``pod`` part of the mean remains ("auto": one ``dist.all_reduce``
over the pod group; "chunked": ``cross_pod_mean``), then the division.
Prefill and decode run over a ``model`` axis for every family: prefill is
the training forward with its last position unembedded vocab-parallel
(``ShardingMixin._unembed``), and the serve step decodes over this rank's
blocks of the params (the train specs, or the dense family's and the vlm's
weight-stationary serve specs) and of the cache (``cache_specs``: batch
over pod x data; time, heads or channels over ``model``; at a batch that
pod x data does not divide, the time over ``data`` and ``pod`` too);
``StepBundle.specs`` names both, so a caller cuts whole trees with
``launch.train.shard_state``.

``StepBundle.in_shapes`` holds the step's arguments as meta tensors (shape
and dtype, no storage): the dry run (``launch.dryrun``) walks a step on
fake tensors made from them. The port carries no shardings: each rank's
tensors are its own blocks, so over a mesh of more than one rank
``in_shapes`` holds this rank's blocks, leaf by leaf the reference's
``in_shardings[i].shard_shape(in_shapes[i].shape)``: the params (and AdamW
state) under the step's param specs, a decode cache under its
``cache_specs``, the batch's rows over pod x data (a decode step's tokens
and positions only where pod x data divides the batch, else whole).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.registry import SHAPES, ShapeCell, build_model
from repro_torch.distributed.fsdp import cross_pod_mean
from repro_torch.distributed.mesh import DATA, MODEL, POD, axis_size, cut_axes, shard
from repro_torch.models.common import cache_batch_spec
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves, tree_map


@dataclasses.dataclass
class StepBundle:
    """One step function, what it runs, and its arguments' shapes."""

    fn: Callable
    model: Any
    kind: str
    in_shapes: Any = None     # meta tensors matching fn's positional args
    specs: Any = None         # decode: (param specs, cache specs) over the mesh


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _param_shapes(model) -> Any:
    """``model.init_params``'s tree as meta tensors: the init runs once on
    fake tensors (its generators need a real device type), allocating
    nothing."""
    with FakeTensorMode():
        params = model.init_params(0, "cpu")
    return tree_map(_meta, params)


def _blocks(mesh, tree, specs):
    """This rank's blocks of a tree of meta tensors under ``specs`` (the
    tree itself on a mesh of one device, or without one)."""
    if mesh is None or mesh.size == 1:
        return tree
    return tree_map(lambda t, s: shard(mesh, t, s), tree, specs)


def _rows(mesh) -> int:
    """The blocks a batch's rows are cut into: pod x data (1 without a mesh)."""
    return 1 if mesh is None else axis_size(mesh, POD) * axis_size(mesh, DATA)


def _batch_shapes(model, cell: ShapeCell, mesh=None) -> dict:
    """This rank's rows of the train/prefill batch of ``cell`` as meta
    tensors (the rows cut over pod x data, the reference's
    ``_batch_specs``): tokens (B, S+1) for train, (B, S) otherwise; a vlm's
    ``vis_embed`` takes ``n_vis_tokens`` of the positions, an encdec adds
    ``audio_embed``."""
    cfg = model.cfg
    B, S = cell.global_batch // _rows(mesh), cell.seq_len
    meta = dict(device="meta")
    shapes: dict[str, torch.Tensor] = {}
    tok_len = S + 1 if cell.kind == "train" else S
    if cfg.family == "vlm":
        tok_len = max(2, tok_len - cfg.n_vis_tokens)
        shapes["vis_embed"] = torch.empty((B, cfg.n_vis_tokens, cfg.d_model), dtype=cfg.dtype, **meta)
    if cfg.family == "encdec":
        shapes["audio_embed"] = torch.empty((B, cfg.enc_positions, cfg.d_model), dtype=cfg.dtype, **meta)
    shapes["tokens"] = torch.empty((B, tok_len), dtype=torch.int32, **meta)
    return shapes


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
    n_chunks: int = 4,
) -> StepBundle:
    ocfg = ocfg or adamw.AdamWConfig(
        state_dtype=torch.bfloat16 if model.cfg.param_count() > 1e11 else torch.float32
    )
    cell = cell or SHAPES["train_4k"]
    if sync_mode not in ("auto", "chunked", "chunked_bf16"):
        raise ValueError(f"sync_mode {sync_mode!r}")
    n_pods = axis_size(mesh, POD) if mesh is not None else 1
    ranks = n_pods * (axis_size(mesh, DATA) if mesh is not None else 1)   # batch shards
    chunked = sync_mode in ("chunked", "chunked_bf16") and n_pods > 1
    compress = sync_mode == "chunked_bf16"
    if cell.global_batch % (ranks * microbatches):
        raise ValueError(f"global batch {cell.global_batch} does not split over {ranks} "
                         f"ranks into {microbatches} microbatches")
    dp = axis_size(mesh, DATA) if mesh is not None else 1
    sharded, groups, zero = None, None, None
    if mesh is not None and (dp > 1 or axis_size(mesh, MODEL) > 1):
        specs = model.param_specs(mesh)
        sharded = tree_map(lambda s: cut_axes(mesh, s), specs)
        groups = {a: mesh.group(a) for a in (DATA, MODEL) if axis_size(mesh, a) > 1}
        zero = zero_leaves(model, mesh)

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

    def synced(loss, grads):
        if ranks == 1:
            return loss, grads
        if not chunked:
            return batch_mean(loss, grads, mesh, zero)
        if dp > 1:
            loss = world_mean(loss, mesh.group(DATA), dp)
            # a ZeRO block arrives summed over data (the reduce-scatter)
            grads = tree_map(lambda g, z: g / dp if z else world_mean(g, mesh.group(DATA), dp),
                             grads, zero)
        if compress:
            # beyond-paper: 'gradient compression' for the cross-pod hop —
            # cast to bf16 for the wire, back to each leaf's dtype after
            dt0 = tree_map(lambda g: g.dtype, grads)
            grads = tree_map(lambda g: g.to(torch.bfloat16), grads)
            grads = cross_pod_mean(grads, mesh.group(POD), n_chunks=n_chunks)
            grads = tree_map(lambda g, d: g.to(d), grads, dt0)
        else:
            grads = cross_pod_mean(grads, mesh.group(POD), n_chunks=n_chunks)
        return world_mean(loss, mesh.group(POD), n_pods), grads

    def step(params, opt, batch):
        loss, grads = synced(*grads_of(params, batch))
        params, opt, stats = adamw.apply(params, grads, opt, ocfg, sharded=sharded,
                                         groups=groups)
        return params, opt, {"loss": loss, **stats}

    p_shapes = _param_shapes(model)
    if sharded is not None:          # this rank's blocks over data and model
        p_shapes = _blocks(mesh, p_shapes, model.param_specs(mesh))
    shapes = (p_shapes, adamw.init(p_shapes, ocfg), _batch_shapes(model, cell, mesh))
    return StepBundle(step, model, "train", shapes)


def batch_mean(loss, grads, mesh, zero=None):
    """The "auto" mean over pod x data of this rank's loss and gradients:
    one ``dist.all_reduce`` a leaf over ``mesh.batch_group``, except a ZeRO
    leaf's (``zero``, a tree of flags; None: none): its block arrives
    summed over ``data`` by the forward's gather's reduce-scatter, so only
    its sum over ``pod`` remains (one all-reduce over the pod group where
    there are pods), then the division by pods x data."""
    n_pods, ranks = axis_size(mesh, POD), axis_size(mesh, POD) * axis_size(mesh, DATA)
    group = mesh.batch_group

    def pod_mean(g):
        return world_mean(g, mesh.group(POD), ranks) if n_pods > 1 else g / ranks

    if zero is None:
        return world_mean(loss, group, ranks), world_mean(grads, group, ranks)
    return world_mean(loss, group, ranks), tree_map(
        lambda g, z: pod_mean(g) if z else world_mean(g, group, ranks), grads, zero)


def zero_leaves(model, mesh):
    """A tree of flags: the leaves that ZeRO cuts over ``data`` (None where
    the mesh has no ``data`` axis over 1)."""
    if mesh is None or axis_size(mesh, DATA) == 1:
        return None
    return tree_map(lambda s: DATA in cut_axes(mesh, s), model.param_specs(mesh))


def world_mean(tree, group, n: int):
    """Mean of every leaf of ``tree`` over the ``n`` ranks of ``group``
    (None: the world), by one monolithic ``dist.all_reduce`` a leaf in the leaf's
    dtype, in place on the leaf (on a contiguous copy of a leaf that is not
    contiguous, such as a gradient that autograd left transposed: NCCL
    takes contiguous tensors only)."""
    def leaf(t):
        t = t.contiguous()
        dist.all_reduce(t, group=group)
        return t.div_(n)

    return tree_map(leaf, tree)


# ---------------------------------------------------------------------------
# prefill (forward producing logits — the compute profile of ingest)
# ---------------------------------------------------------------------------
def build_prefill_step(model, mesh=None, *, cell: ShapeCell | None = None) -> StepBundle:
    """Last-position logits of a batch: an encdec's decoder over its encoded
    ``audio_embed``, a vlm's tokens after their ``vis_embed`` prefix. Over a
    ``model`` axis the params are this rank's blocks under the train specs
    (as the reference's), and the logits are gathered whole.
    ``in_shapes`` is ``cell``'s (None without a cell)."""
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
        params = model._zero_top(params)
        return model._unembed(params, hidden(params, batch)[:, -1:])

    shapes = None
    if cell is not None:
        p_shapes = _param_shapes(model)
        if mesh is not None and mesh.size > 1:
            p_shapes = _blocks(mesh, p_shapes, model.param_specs(mesh))
        shapes = (p_shapes, _batch_shapes(model, cell, mesh))
    return StepBundle(prefill, model, "prefill", shapes)


# ---------------------------------------------------------------------------
# decode (one serve step: next-token + cache update)
# ---------------------------------------------------------------------------
def build_serve_step(model, mesh=None, *, cell: ShapeCell | None = None,
                     weight_stationary: bool = False) -> StepBundle:
    """One decode step over a cache of ``cell.seq_len`` positions for
    ``cell.global_batch`` sequences (``in_shapes``; None without a cell).
    ``weight_stationary`` picks the reference's serve-time param specs
    (a family whose ``param_specs`` takes no ``serve`` keeps its train
    specs, as the reference's ``build_serve_step`` falls back to them).
    Over a mesh of more than one rank, ``specs`` is (param specs, cache
    specs): the step takes this rank's blocks of each, the tokens and
    positions of its batch rows (a cache without a cell is whole on every
    rank)."""
    pspecs = cspecs = None
    if mesh is not None and mesh.size > 1:
        try:
            pspecs = model.param_specs(mesh, serve=weight_stationary)
        except TypeError:
            pspecs = model.param_specs(mesh)
        if cell is not None:
            cspecs = model.cache_specs(mesh, cell.global_batch, cell.seq_len)
    kw = {} if cspecs is None else {"cache_specs": cspecs}

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        logits, cache = model.decode_step(params, cache, tokens, pos, **kw)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return nxt[:, None], cache, pos + 1

    shapes = None
    if cell is not None:
        B, T = cell.global_batch, cell.seq_len
        b = B if mesh is None or cache_batch_spec(mesh, B) is None else B // _rows(mesh)
        shapes = (_blocks(mesh, _param_shapes(model), pspecs),
                  _blocks(mesh, model.init_cache(B, T, device="meta"), cspecs),
                  torch.empty((b, 1), dtype=torch.int32, device="meta"),
                  torch.empty((b,), dtype=torch.int32, device="meta"))
    return StepBundle(serve_step, model, "decode", shapes, (pspecs, cspecs))


# ---------------------------------------------------------------------------
# cell entry point
# ---------------------------------------------------------------------------
# Grad-accumulation defaults that fit each arch's train_4k step in 16 GB/chip
# (the reference's, from its dry run's memory analysis).
DEFAULT_MICROBATCHES = {
    "yi-34b": 4, "grok-1-314b": 8, "mistral-nemo-12b": 2, "whisper-large-v3": 2,
    "mamba2-370m": 2, "recurrentgemma-2b": 4,
}


def build_cell(arch: str, shape: str, mesh=None, *, sync_mode: str = "auto",
               microbatches: int = 0, layers_override: int | None = None,
               cfg_overrides: dict | None = None,
               weight_stationary: bool = False) -> StepBundle:
    cell = SHAPES[shape]
    model = build_model(arch, mesh, shape=shape)
    if cfg_overrides:
        model = _rebuild(model, dataclasses.replace(model.cfg, **cfg_overrides))
    if layers_override is not None:
        model = _with_layers(model, layers_override)
    if cell.kind == "train":
        if microbatches == 0:
            microbatches = DEFAULT_MICROBATCHES.get(arch, 1)
        return build_train_step(model, mesh, cell=cell, sync_mode=sync_mode,
                                microbatches=microbatches)
    if cell.kind == "prefill":
        return build_prefill_step(model, mesh, cell=cell)
    return build_serve_step(model, mesh, cell=cell,
                            weight_stationary=weight_stationary)


def _rebuild(model, cfg):
    """``model``'s class on ``cfg`` and on its mesh, with the model's own
    arguments: an encdec's ``max_target``, a MoE's capacity factor ``cf``."""
    kw = {}
    if cfg.family == "encdec":
        kw["max_target"] = model.max_target
    if cfg.family == "moe":
        kw["cf"] = model.cf
    return type(model)(cfg, model.mesh, **kw)


def _with_layers(model, n_layers: int):
    """Same arch with a reduced layer count (the dry run's probes, the
    launchers' ``--layers``): an encdec gets ``n_layers`` in both stacks.
    The hybrid derives its blocks and its recurrent tail from ``n_layers``
    (3 layers: one block, no tail)."""
    cfg = dataclasses.replace(model.cfg, n_layers=n_layers)
    if cfg.family == "encdec":
        cfg = dataclasses.replace(cfg, n_enc_layers=n_layers)
    return _rebuild(model, cfg)
