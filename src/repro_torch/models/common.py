"""Shared model components: configs, norms, RoPE, GQA attention, MLPs.

Twin of ``repro.models.common`` in plain torch ops. Params are nested dicts
of tensors, as in the reference, with the layers stacked on a leading axis;
a model walks that axis in a Python loop (the reference's ``lax.scan``) and
recomputes each block in its backward pass under ``remat="full"``
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``), all but
its weight projections under ``remat="dots"`` (``remat_policy``).

Attention is written out in einsums, as the reference writes it in
``jnp``: ``F.scaled_dot_product_attention`` takes no logit soft-cap, and no
Pallas kernel computes it, so no hand-written kernel is due. Long queries
take the blocked online-softmax path over KV chunks, short ones (decode,
smoke shapes) the dense path; both mask invalid cache slots (position -1).

Sharding: ``shardable`` and ``batch_axes`` are the reference's, and a
family's ``param_specs`` returns the reference's PartitionSpecs. Where the
reference leaves the collectives to GSPMD, the port writes them out on the
``model`` group (``ShardingMixin``): each rank runs the forward on its own
blocks of the weights (``distributed.mesh.shard``), with Megatron's pair of
operators around each column- and row-parallel pair, a vocab-parallel
embedding lookup and a vocab-parallel cross-entropy that never gathers the
(B, S, V) logits; the MoE's expert parallelism adds an all-to-all over the
group (``all_to_all``) and a stack of the ranks' token slices
(``_stack_out``), the hybrid's recurrent layer a gather whose backward is
a reduce-scatter (``_gather_in``) and the ssm's gated norm a statistic
summed over the group (``_sum_stat``). Over the ``data`` axis (ZeRO-3)
every weight's ``d_model`` dim is cut, gathered over the data group just
before its layer uses it (``_GatherFromData``, whose backward
reduce-scatters). The residual stays whole on every
model rank, where the reference may shard it by sequence (``constrain``,
``_seq``, ``_res`` are layout hints of GSPMD and have no counterpart).
A decode cache is laid out by the reference's ``kv_cache_spec`` (batch
over pod x data, time over the other axes: over ``model``, and at a batch
that pod x data does not divide over ``data`` and ``pod`` too); a decode
layer of any family writes the new slot on the rank that holds it, attends
each rank's time block and combines the ranks' partial softmaxes over the
axes that cut the time (``ShardingMixin._cached_attention``:
``partial_attention``, ``_combine`` on ``Mesh.group_over`` of them).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import zlib
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts, noop_context_fn)

from repro_torch.distributed.mesh import (
    DATA, MODEL, POD, P, all_gather_into, axis_size, block_index, data_dims, entry_cut,
    reduce_scatter_into)

Params = Any


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None     # default d_model // n_heads
    act: str = "silu"               # silu (SwiGLU) | gelu (GeGLU)
    rope_theta: float = 10000.0
    # attention pattern, repeated to cover n_layers: "g"=global, "l"=local
    attn_pattern: str = "g"
    window: int = 4096              # local-attention window
    attn_softcap: float | None = None
    final_softcap: float | None = None
    post_norms: bool = False        # gemma2-style post-attn/post-mlp norms
    tie_embeddings: bool = True
    embed_scale: bool = False       # gemma: scale embeddings by sqrt(d)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # hybrid (recurrentgemma)
    lru_width: int | None = None
    conv1d_size: int = 4
    # enc-dec (whisper)
    n_enc_layers: int = 0
    enc_positions: int = 1500
    # vlm
    n_vis_tokens: int = 0
    # numerics / memory
    dtype: torch.dtype = torch.bfloat16
    remat: str = "full"             # full | dots | none
    ssm_bf16: bool = False          # SSD intra-chunk matmuls in bf16
    # applicability notes (long_500k etc.)
    subquadratic: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def layer_kinds(self) -> tuple[str, ...]:
        pat = self.attn_pattern
        reps = -(-self.n_layers // len(pat))
        return tuple((pat * reps)[: self.n_layers])

    def param_count(self) -> int:
        """Total parameters (embedding included once when tied)."""
        d, f, v, hd = self.d_model, self.d_ff, self.vocab, self.hd
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        if self.family == "ssm":
            d_in = d * self.ssm_expand
            nh = d_in // self.ssm_head_dim
            per = (d * (2 * d_in + 2 * self.ssm_state + nh)   # in_proj (z,x,B,C,dt)
                   + (d_in + 2 * self.ssm_state) * self.ssm_conv
                   + nh * 2                                    # A_log, D
                   + d_in * d + 2 * d)                         # out_proj + norms
            body = self.n_layers * per
        elif self.family == "moe":
            mlp = self.n_experts * 3 * d * f + d * self.n_experts
            body = self.n_layers * (attn + mlp + 2 * d)
        elif self.family == "hybrid":
            kinds = self.layer_kinds()
            n_rec = sum(1 for k in kinds if k == "r")
            n_att = self.n_layers - n_rec
            w = self.lru_width or d
            rec = d * w * 2 + w * self.conv1d_size + w * 4 + w * d  # in/out + conv + gates
            mlp = 3 * d * f
            body = n_rec * (rec + mlp + 2 * d) + n_att * (attn + mlp + 2 * d)
        elif self.family == "encdec":
            mlp = 2 * d * f  # whisper uses plain GELU MLP (no gating)
            enc = self.n_enc_layers * (attn + mlp + 2 * d)
            dec = self.n_layers * (2 * attn + mlp + 3 * d)
            body = enc + dec + self.enc_positions * d
        else:
            mlp = 3 * d * f
            body = self.n_layers * (attn + mlp + 2 * d)
        embed = v * d * (1 if self.tie_embeddings else 2)
        return body + embed + d

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense = self.param_count() - self.n_layers * self.n_experts * 3 * d * f
        return dense + self.n_layers * self.top_k * 3 * d * f


# ---------------------------------------------------------------------------
# the model axis: Megatron's operators on the model group
# ---------------------------------------------------------------------------
class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group (the
    input of a column-parallel product, or a whole weight that each rank
    uses for its own heads only)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the group forward (the partial output of a row-parallel
    product); identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """The group's blocks concatenated along the last dim; the backward
    keeps this rank's block."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[-1] // dist.get_world_size(ctx.group)
        return g.narrow(-1, dist.get_rank(ctx.group) * n, n).contiguous(), None


class _GatherSumModel(_GatherFromModel):
    """``_GatherFromModel``'s gather, where each rank feeds the whole result
    into its own output columns: the backward sums the gradient over the
    group and keeps this rank's block (a reduce-scatter)."""

    @staticmethod
    def backward(ctx, g):
        tp = dist.get_world_size(ctx.group)
        n = g.shape[-1] // tp
        blocks = g.reshape(*g.shape[:-1], tp, n).movedim(-2, 0).contiguous()
        out = g.new_empty((1, *blocks.shape[1:]))
        # reduce_scatter_tensor's new name where torch has it
        rs = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
        rs(out, blocks, group=ctx.group)
        return out[0], None


class _AllToAllModel(torch.autograd.Function):
    """Block j of dim 0 goes to rank j, and block j of the result came from
    rank j (``jax.lax.all_to_all(split_axis=0, concat_axis=0)``, equal
    splits); the backward is the same all-to-all of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        y = torch.empty_like(g)
        dist.all_to_all_single(y, g, group=ctx.group)
        return y, None


class _StackFromModel(torch.autograd.Function):
    """The group's tensors stacked along a new leading dim, in rank order
    (``jax.lax.all_gather(x, axis, axis=0)``); the backward keeps this
    rank's block, since the gradient downstream is the same on every rank
    of the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.new_empty((dist.get_world_size(group), *x.shape))
        dist.all_gather(list(out.unbind(0)), x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g[dist.get_rank(ctx.group)].contiguous(), None


class _GatherFromData(torch.autograd.Function):
    """ZeRO-3's gather: the group's blocks of ``x`` concatenated along
    ``dim`` (an all-gather of a contiguous copy, the blocks stacked on dim 0
    and moved back); the backward sums the gradient over the group and
    keeps this rank's block (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        blocks = x.movedim(dim, 0).contiguous()
        out = blocks.new_empty((dist.get_world_size(group) * blocks.shape[0], *blocks.shape[1:]))
        all_gather_into(out, blocks, group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        whole = g.movedim(ctx.dim, 0).contiguous()
        out = whole.new_empty((whole.shape[0] // dist.get_world_size(ctx.group),
                               *whole.shape[1:]))
        reduce_scatter_into(out, whole, ctx.group)
        return out.movedim(0, ctx.dim), None, None


def all_to_all(x, group):
    """``_AllToAllModel`` over ``group``: dim 0's block j sent to rank j,
    the blocks received in rank order (the MoE's dispatch and return
    trip)."""
    return _AllToAllModel.apply(x, group)


class _TopWhole(dict):
    """A params tree whose top-level leaves ``ShardingMixin._zero_top``
    has gathered whole over ``data``."""


class ShardingMixin:
    """Tensor parallelism over the mesh's ``model`` axis, and ZeRO-3 over
    its ``data`` axis. A dim that the axis divides is split
    (``shardable``); a model rank then holds block ``rank`` of it, and
    these helpers bracket each product with the operator that keeps every
    replicated value and every replicated leaf's gradient equal on every
    model rank, bit for bit. A weight's ``d_model`` dim is cut over
    ``data`` and gathered just before its layer uses it (``_zero_layer``,
    ``_zero_top``), its gradient reduce-scattered back. On a mesh without a
    ``model`` (``data``) axis over 1 each helper of that axis is the
    identity."""

    mesh: Any = None

    def _tp(self) -> int:
        return 1 if self.mesh is None else axis_size(self.mesh, MODEL)

    def _mrank(self) -> int:
        return 0 if self.mesh is None else self.mesh.rank(MODEL)

    def _split(self, size: int) -> bool:
        """Whether a dim of ``size`` is split over the model ranks."""
        return self._tp() > 1 and shardable(size, MODEL, self.mesh) is not None

    def _copy_in(self, x, split: bool = True):
        """Into a column-parallel product (or onto a whole weight that feeds
        this rank's heads only): the backward sums over ``model``."""
        if not split or self._tp() == 1:
            return x
        return _CopyToModel.apply(x, self.mesh.group(MODEL))

    def _reduce_out(self, x, split: bool = True):
        """Out of a row-parallel product: the partial sums summed over
        ``model``."""
        if not split or self._tp() == 1:
            return x
        return _ReduceFromModel.apply(x, self.mesh.group(MODEL))

    def _gather_out(self, x, split: bool = True):
        """The last dim's blocks of every model rank, concatenated."""
        if not split or self._tp() == 1:
            return x
        return _GatherFromModel.apply(x, self.mesh.group(MODEL))

    def _gather_in(self, x, split: bool = True):
        """The last dim's blocks of every model rank, concatenated, as the
        input of this rank's own output columns: the backward sums the
        gradient over ``model`` and keeps this rank's block."""
        if not split or self._tp() == 1:
            return x
        return _GatherSumModel.apply(x, self.mesh.group(MODEL))

    def _sum_stat(self, s, split: bool = True):
        """A statistic of this rank's block summed over ``model`` (a norm's
        sum of squares over a split dim); every rank uses the sum for its
        own block, so the backward sums the gradient over ``model`` too."""
        return self._copy_in(self._reduce_out(s, split), split)

    def _stack_out(self, x):
        """Every model rank's ``x`` stacked on a new leading dim (over a
        ``model`` axis over 1)."""
        return _StackFromModel.apply(x, self.mesh.group(MODEL))

    # -- ZeRO-3 over ``data`` ----------------------------------------------------
    def _dp(self) -> int:
        return 1 if self.mesh is None else axis_size(self.mesh, DATA)

    def _zero(self, t, pspec):
        """``t`` (this rank's block under ``pspec``) whole along each dim
        that names ``data``; its gradient is reduce-scattered back over the
        data group. The identity where the mesh has no ``data`` axis over 1."""
        if self._dp() == 1:
            return t
        for d in data_dims(pspec):
            t = _GatherFromData.apply(t, d, self.mesh.group(DATA))
        return t

    def _zero_layer(self, leaves, specs):
        """One layer's leaves (slices of the stacked leaves, in ``specs``'
        order), each whole along its ``data`` dim: called inside the
        function that ``maybe_remat`` wraps, so under ``remat="full"`` the
        gather runs again in the backward pass and no whole layer weight is
        held across layers. ``specs`` are the stacked leaves' (the layer
        dim is dropped here)."""
        if self._dp() == 1:
            return tuple(leaves)
        return tuple(self._zero(t, s[1:]) for t, s in zip(leaves, specs))

    def _zero_top(self, params):
        """``params`` with its top-level leaves (``embed``, ``unembed``)
        whole along ``data``: gathered once a forward, before the lookup and
        the unembedding that share them. A tree this returned passes
        through unchanged, so entry points that call one another gather
        once."""
        if self._dp() == 1 or isinstance(params, _TopWhole):
            return params
        specs = self.param_specs(self.mesh)
        return _TopWhole({k: v if isinstance(v, dict) else self._zero(v, specs[k])
                          for k, v in params.items()})

    def _vocab(self):
        """(group, first row) of this rank's vocab block, None where the
        vocab is whole."""
        if not self._split(self.cfg.vocab):
            return None
        return self.mesh.group(MODEL), self._mrank() * (self.cfg.vocab // self._tp())

    def _lookup(self, table, tokens):
        """Embedding lookup; over a vocab block, the ids outside it are
        masked, looked up locally, and the rows summed over ``model``."""
        vocab = self._vocab()
        if vocab is None:
            return F.embedding(tokens.long(), table)
        ids = tokens.long() - vocab[1]
        inside = (ids >= 0) & (ids < table.shape[0])
        x = F.embedding(torch.where(inside, ids, 0), table)
        return self._reduce_out(torch.where(inside[..., None], x, 0))

    def _unembed(self, params, h):
        """Whole logits (B, S, V) of hidden states ``h`` through the
        family's ``_out_w``: over a vocab split, each rank's block,
        gathered."""
        vocab = self._vocab() is not None
        h = self._copy_in(h, vocab)
        return self._gather_out(torch.einsum("bsd,dv->bsv", h, self._out_w(params)), vocab)

    def _xent(self, params, h, labels, final_cap=None):
        """``chunked_xent`` of ``h`` against ``labels``, vocab-parallel over
        a vocab split."""
        vocab = self._vocab()
        return chunked_xent(self._copy_in(h, vocab is not None), self._out_w(params),
                            labels, final_cap=final_cap, vocab=vocab)

    def _gather_model(self, parts, dim: int) -> list:
        """Each of ``parts`` whole along ``dim``: the model ranks' blocks
        concatenated in rank order, every part in one ``dist.all_gather``
        of their flat concatenation (decode; no backward)."""
        tp = self._tp()
        flat = torch.cat([t.reshape(-1) for t in parts])
        out = flat.new_empty((tp, flat.numel()))
        dist.all_gather(list(out.unbind(0)), flat, group=self.mesh.group(MODEL))
        whole, at = [], 0
        for t in parts:
            blocks = out[:, at:at + t.numel()].reshape(tp, *t.shape)
            at += t.numel()
            d = dim % t.dim()
            whole.append(blocks.movedim(0, d).reshape(*t.shape[:d], tp * t.shape[d],
                                                     *t.shape[d + 1:]))
        return whole

    def _combine(self, m, l, o, dtype, group):
        """The softmax over every block of the keys from each rank's
        ``partial_attention`` (m, l, o), over ``group`` (the ranks that
        cut the time): the largest logit all-reduced (max), each rank's
        sums rescaled to it (a rank with no valid key scales by exp(-inf) =
        0) and summed in one all-reduce of l and o together, then
        normalised. (B, S, H, hd) in ``dtype``."""
        top = m.clone()
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
        scale = torch.exp(m - top)
        lo = torch.cat([(l * scale)[..., None], o * scale[..., None]], dim=-1).contiguous()
        dist.all_reduce(lo, group=group)
        out = lo[..., 1:] / lo[..., :1]
        B, KVH, G, S, hd = o.shape
        return out.permute(0, 3, 1, 2, 4).reshape(B, S, KVH * G, hd).to(dtype)

    # -- decode over a time-cut cache ---------------------------------------------
    @staticmethod
    def _cache_write(cache_k, cache_v, cache_p, k_new, v_new, pos, slot, own=None):
        """Write one token's K/V at per-batch ``slot``, in place; with
        ``own`` (B,) bool, only the rows it marks (the others write back
        what the slot held, so no row is picked on the host).
        shapes: cache (B, T, KVH, hd), k_new/v_new (B, 1, KVH, hd), pos (B,)."""
        rows = torch.arange(cache_k.shape[0], device=cache_k.device)
        slot = slot.long()
        new = (k_new[:, 0].to(cache_k.dtype), v_new[:, 0].to(cache_v.dtype),
               pos.to(cache_p.dtype))
        for c, n in zip((cache_k, cache_v, cache_p), new):
            if own is not None:
                n = torch.where(own.view(-1, *[1] * (n.dim() - 1)), n, c[rows, slot])
            c[rows, slot] = n
        return cache_k, cache_v, cache_p

    def _time_cut(self, spec) -> tuple[str, ...]:
        """The mesh axes over 1 that cut the time dim (dim 2) of a decode
        cache laid out by ``spec`` (None: whole on every rank), in the
        spec's order: ``kv_cache_spec``'s model, data, pod, row-major, the
        way ``shard`` cuts it. Empty where the time is whole."""
        return () if spec is None else entry_cut(self.mesh, spec[2])

    def _whole_heads(self, parts, whole) -> list:
        """Each of ``parts`` (B, S, heads, hd) whole: those whose last two
        dims are not ``whole``'s entry gathered over ``model`` in one
        all-gather, along the dim the layout cuts (heads under the train
        specs, head_dim under the dense family's serve specs)."""
        cut = [t for t, w in zip(parts, whole) if tuple(t.shape[-2:]) != w]
        if not cut:
            return list(parts)
        # a cut of the kv heads cuts the heads too (they are its multiple), so
        # the first part's heads tell the dim
        dim = -2 if parts[0].shape[-2] != whole[0][0] else -1
        it = iter(self._gather_model(cut, dim))
        return [next(it) if tuple(t.shape[-2:]) != w else t for t, w in zip(parts, whole)]

    def _cached_attention(self, q, ck, cv, cp, pos, time_cut: tuple, *, new=None,
                          causal: bool = True, window=None, logit_cap=None):
        """Decode attention of the whole ``q`` (B, 1, H, hd) over this
        rank's block of a cache (``ck``, ``cv`` (B, T, KVH, hd), positions
        ``cp`` (B, T), -1 where empty). ``new`` = (k, v) of the token at
        ``pos``, whole, is first written at slot ``pos % T`` of the whole
        cache: over a time cut over the n blocks of ``time_cut``
        (``_time_cut``) slot ``pos % (n T)`` lives in block ``slot // T``
        at ``slot % T``, and only the rank that holds that block
        (``block_index``) writes it. Over a time cut each rank attends its
        block (``partial_attention``) and the partial softmaxes are
        combined over the cutting axes' group (``_combine``); else the
        whole cache is attended. (B, 1, H, hd) in ``q``'s dtype."""
        q_pos = pos[:, None]
        if new is not None:
            T = ck.shape[1]
            if time_cut:
                mine, n = block_index(self.mesh, time_cut)
                slot = pos % (T * n)
                self._cache_write(ck, cv, cp, *new, pos, slot % T, own=slot // T == mine)
            else:
                self._cache_write(ck, cv, cp, *new, pos, pos % T)
        if not time_cut:
            return attention(q, ck, cv, causal=causal, q_positions=q_pos, kv_positions=cp,
                             window=window, logit_cap=logit_cap)
        m, l, o = partial_attention(q, ck, cv, causal=causal, q_positions=q_pos,
                                    kv_positions=cp, window=window, logit_cap=logit_cap)
        return self._combine(m, l, o, q.dtype, self.mesh.group_over(time_cut))

    def _own_rows(self, o, wo):
        """(``o`` (B, S, H, hd) narrowed to this rank's rows of ``wo`` (H,
        hd, D) or its block of them, whether ``wo`` is cut): the input of
        the row-parallel output projection."""
        cut = [d for d in (0, 1) if wo.shape[d] != o.shape[2 + d]]
        for d in cut:
            o = o.narrow(2 + d, self._mrank() * wo.shape[d], wo.shape[d])
        return o, bool(cut)

    def _heads_out(self, o, wo):
        """The row-parallel output projection of the whole ``o`` (B, S, H,
        hd): this rank's heads of it into its rows of ``wo``, summed over
        ``model`` where ``wo`` is cut."""
        o, cut = self._own_rows(o, wo)
        return self._reduce_out(torch.einsum("bsnh,nhd->bsd", o, wo), cut)

    def _local_kv(self, k, v):
        """The kv heads that this rank's query heads meet: all of ``k``
        where the kv heads are split with the heads (or nothing is split),
        else those of the whole set that its heads group with."""
        cfg = self.cfg
        if not self._split(cfg.n_heads) or self._split(cfg.n_kv_heads):
            return k, v
        h_loc = cfg.n_heads // self._tp()
        return kv_for_heads(k, v, self._mrank() * h_loc, h_loc, cfg.n_heads // cfg.n_kv_heads)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
_TRUNC_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))   # Phi(-2)
_TRUNC_HI = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))    # Phi(2)


def trunc_normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], times ``scale``, by inverting
    the CDF of uniform draws of ``gen`` on its device (f32, then cast to
    ``dtype``)."""
    u = torch.rand(tuple(shape), generator=gen, device=gen.device, dtype=torch.float32)
    x = torch.erfinv((_TRUNC_LO + (_TRUNC_HI - _TRUNC_LO) * u) * 2.0 - 1.0)
    x = x.mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    return x.mul_(scale).to(dtype)


class Initializer:
    """Deterministic per-leaf init from a path-derived seed of an explicit
    ``torch.Generator`` on ``device`` (drawn where the weights live: a
    full-width model draws in milliseconds on the card, in seconds on a
    host). The card's generator is not the CPU's, so one seed gives each
    its own weights; neither can equal ``jax.random``, and parity with the
    reference goes through ``convert.params_from_reference``."""

    def __init__(self, seed: int, dtype, device):
        self.seed = int(seed)
        self.dtype = dtype
        self.device = torch.device(device)

    def __call__(self, path: str, shape: Sequence[int], scale: float | None = None):
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.seed * 1_000_003 + zlib.crc32(path.encode())) % (1 << 62))
        if scale is None:
            scale = 1.0 / math.sqrt(shape[-2] if len(shape) >= 2 else shape[-1])
        return trunc_normal(gen, shape, scale, self.dtype)

    def zeros(self, shape):
        return torch.zeros(tuple(shape), dtype=self.dtype, device=self.device)

    def ones(self, shape):
        return torch.ones(tuple(shape), dtype=self.dtype, device=self.device)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
             unit_offset: bool = True) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    w = (1.0 + scale.float()) if unit_offset else scale.float()
    return (x * w).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    half = hd // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), exps)
    ang = positions[..., :, None].float() * freq  # (..., seq, half)
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def softcap(logits: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return logits
    return torch.tanh(logits / cap) * cap


ATTN_BLOCK_KV = 512   # KV chunk for the online-softmax (flash-style) path
ATTN_DENSE_MAX = 1024  # use the dense path when S_q <= this (decode, smoke)


def _attn_mask(q_pos, kv_pos, causal, window):
    """(B, Sq, Skv) bool mask from absolute positions (-1 kv = invalid slot)."""
    mask = kv_pos[:, None, :] >= 0
    if causal:
        mask = mask & (q_pos[:, :, None] >= kv_pos[:, None, :])
    if window is not None:
        mask = mask & (q_pos[:, :, None] - kv_pos[:, None, :] < window)
    return mask


def attention(
    q: torch.Tensor,          # (B, S, H, hd)
    k: torch.Tensor,          # (B, T, KVH, hd)
    v: torch.Tensor,          # (B, T, KVH, hd)
    *,
    causal: bool,
    q_positions: torch.Tensor,     # (B, S) absolute positions of queries
    kv_positions: torch.Tensor,    # (B, T) absolute positions of keys (-1 = invalid)
    window: int | None = None,     # local attention window (None = global)
    logit_cap: float | None = None,
    block_kv: int = ATTN_BLOCK_KV,
) -> torch.Tensor:
    """GQA attention with sliding-window and soft-cap support, in f32.

    Long sequences use an online-softmax loop over KV chunks: peak logits
    memory drops from O(S*T) to O(S*block_kv). Short-q (decode) and smoke
    shapes take the dense path.
    """
    B, S, H, hd = q.shape
    KVH = k.shape[2]
    assert H % KVH == 0
    G = H // KVH
    qf = q.float().reshape(B, S, KVH, G, hd)
    T = k.shape[1]

    if S <= ATTN_DENSE_MAX or T <= block_kv:
        kf, vf = k.float(), v.float()
        logits = torch.einsum("bskgh,btkh->bkgst", qf, kf) / math.sqrt(hd)
        logits = softcap(logits, logit_cap)
        mask = _attn_mask(q_positions, kv_positions, causal, window)
        logits = torch.where(mask[:, None, None, :, :], logits, -1e30)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bkgst,btkh->bskgh", probs, vf)
        return out.reshape(B, S, H, hd).to(q.dtype)

    # ---- blocked online-softmax path
    pad = (-T) % block_kv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = F.pad(kv_positions, (0, pad), value=-1)
    m = torch.full((B, KVH, G, S), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KVH, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KVH, G, S, hd), dtype=torch.float32, device=q.device)
    for start in range(0, k.shape[1], block_kv):
        kc = k[:, start : start + block_kv].float()
        vc = v[:, start : start + block_kv].float()
        pc = kv_positions[:, start : start + block_kv]
        logits = torch.einsum("bskgh,btkh->bkgst", qf, kc) / math.sqrt(hd)
        logits = softcap(logits, logit_cap)
        mask = _attn_mask(q_positions, pc, causal, window)
        logits = torch.where(mask[:, None, None, :, :], logits, -1e30)
        m_new = torch.maximum(m, torch.amax(logits, dim=-1))
        p = torch.exp(logits - m_new[..., None])
        scale = torch.exp(m - m_new)
        l = l * scale + torch.sum(p, dim=-1)
        acc = acc * scale[..., None] + torch.einsum("bkgst,btkh->bkgsh", p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd)
    return out.to(q.dtype)


def partial_attention(
    q: torch.Tensor,          # (B, S, H, hd)
    k: torch.Tensor,          # (B, T, KVH, hd): one block of the keys
    v: torch.Tensor,          # (B, T, KVH, hd)
    *,
    causal: bool,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    window: int | None = None,
    logit_cap: float | None = None,
):
    """``attention``'s dense path over one block of the keys, not yet
    normalised: (m, l, o), in f32, with m (B, KVH, G, S) the block's
    largest valid logit (-inf where it holds no valid key), l the sum of
    exp(logit - m) and o (B, KVH, G, S, hd) the sum of exp(logit - m) v.
    Masked logits are -inf, so a block with no valid key gives l = 0 and
    o = 0 exactly and adds nothing where blocks are combined
    (``ShardingMixin._combine``); ``attention`` itself, which normalises
    inside, would give such a block a uniform mix of its masked keys."""
    B, S, H, hd = q.shape
    KVH = k.shape[2]
    qf = q.float().reshape(B, S, KVH, H // KVH, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qf, k.float()) / math.sqrt(hd)
    logits = softcap(logits, logit_cap)
    mask = _attn_mask(q_positions, kv_positions, causal, window)
    logits = torch.where(mask[:, None, None, :, :], logits, -math.inf)
    m = torch.amax(logits, dim=-1)
    p = torch.exp(logits - torch.where(torch.isinf(m), 0.0, m)[..., None])
    return m, torch.sum(p, dim=-1), torch.einsum("bkgst,btkh->bkgsh", p, v.float())


def kv_for_heads(k: torch.Tensor, v: torch.Tensor, h0: int, n: int, group: int):
    """The K/V heads (dim 2) that query heads ``h0 .. h0+n-1`` meet, where
    query head h meets kv head ``h // group`` (``attention``'s grouping):
    a contiguous slice when each of them serves the same number of those
    heads, else one kv head a query head."""
    idx = [(h0 + j) // group for j in range(n)]
    lo, hi = idx[0], idx[-1] + 1
    if n % (hi - lo) == 0 and idx == [lo + j // (n // (hi - lo)) for j in range(n)]:
        return k[:, :, lo:hi], v[:, :, lo:hi]
    sel = torch.tensor(idx, device=k.device)
    return k.index_select(2, sel), v.index_select(2, sel)


def act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(name)


def gated_mlp(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor, wo: torch.Tensor,
              act: str) -> torch.Tensor:
    h = act_fn(act)(x @ wg) * (x @ wi)
    return h @ wo


def _nll(logits: torch.Tensor, labels: torch.Tensor, vocab=None) -> torch.Tensor:
    """-log softmax(logits)[label] at each position, from f32 ``logits``.
    ``vocab`` = (group, first id) when ``logits`` is one vocab block: the
    max and the sum of exponentials are reduced over the group, and the
    label's logit comes from the rank that holds it."""
    if vocab is None:
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    group, first = vocab
    m = logits.detach().amax(-1, keepdim=True).contiguous()
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    sumexp = _ReduceFromModel.apply(torch.exp(logits - m).sum(-1), group)
    ids = labels.long() - first
    inside = (ids >= 0) & (ids < logits.shape[-1])
    tgt = torch.gather(logits, -1, torch.where(inside, ids, 0)[..., None])[..., 0]
    tgt = _ReduceFromModel.apply(torch.where(inside, tgt, 0.0), group)
    return torch.log(sumexp) + m[..., 0] - tgt


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  mask: torch.Tensor | None = None,
                  final_cap: float | None = None, vocab=None) -> torch.Tensor:
    """Mean next-token cross-entropy; ``vocab`` as in ``_nll`` for a block
    of the vocab."""
    nll = _nll(softcap(logits.float(), final_cap), labels, vocab)
    if mask is None:
        return torch.mean(nll)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def chunked_xent(
    h: torch.Tensor,            # (B, S, D) final hidden states
    w: torch.Tensor,            # (D, V) unembedding
    labels: torch.Tensor,       # (B, S)
    *,
    final_cap: float | None = None,
    mask: torch.Tensor | None = None,
    seq_chunk: int = 512,
    vocab=None,
) -> torch.Tensor:
    """Cross-entropy without materializing (B, S, V) f32 logits.

    The unembed matmul + log-softmax run per seq-chunk and are recomputed in
    the backward pass: peak logits memory falls from O(S*V) to
    O(seq_chunk*V) — at gemma's 256k vocab and 8192 tokens a step, 8.4 GB of
    f32 logits against one chunk's. ``w`` may be one vocab block (``vocab``
    as in ``_nll``); no rank then holds more than its block's logits.
    """
    B, S, D = h.shape
    if S <= seq_chunk:
        logits = torch.einsum("bsd,dv->bsv", h, w)
        return cross_entropy(logits, labels, mask=mask, final_cap=final_cap, vocab=vocab)
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=h.device)
    pad = (-S) % seq_chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    mask = mask.float()

    def body(hh, ll, mm):
        logits = softcap(torch.einsum("bsd,dv->bsv", hh, w).float(), final_cap)
        return torch.sum(_nll(logits, ll, vocab) * mm)

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for s in range(0, h.shape[1], seq_chunk):
        sl = slice(s, s + seq_chunk)
        part = (checkpoint(body, h[:, sl], labels[:, sl], mask[:, sl], use_reentrant=False)
                if torch.is_grad_enabled() else body(h[:, sl], labels[:, sl], mask[:, sl]))
        total = total + part
    return total / torch.clamp(torch.sum(mask), min=1.0)


# ---------------------------------------------------------------------------
# sharding helpers (the reference's)
# ---------------------------------------------------------------------------
def shardable(size: int, axis: str, mesh) -> str | None:
    """Use `axis` only when the dim divides evenly on this mesh."""
    if axis in mesh.axis_names and size % mesh.shape[axis] == 0:
        return axis
    return None


def kv_cache_spec(mesh, batch: int, time: int, extra: tuple = ()):
    """Sharding for a (layers, B, T, ...) decode cache, the reference's:
    the batch over (pod, data) where their product divides it, the time
    dim over every other axis that divides what is left of it, in the
    order model, data, pod (long-context decode, B = 1, ends up cut over
    every axis)."""
    b = cache_batch_spec(mesh, batch)
    b_axes = b if isinstance(b, tuple) else ((b,) if b else ())
    t_axes = []
    rem = time
    for a in (MODEL, DATA, POD):
        if a in mesh.axis_names and a not in b_axes and rem % mesh.shape[a] == 0:
            t_axes.append(a)
            rem //= mesh.shape[a]
    t = tuple(t_axes) if len(t_axes) > 1 else (t_axes[0] if t_axes else None)
    return P(None, b, t, *extra)


def cache_batch_spec(mesh, batch: int):
    """The batch dim's entry of a decode cache's spec, the reference's:
    ``batch_axes`` where their product divides ``batch``, else None (every
    rank holds every row)."""
    b = batch_axes(mesh)
    axes = b if isinstance(b, tuple) else ((b,) if b else ())
    return b if batch % max(1, math.prod(mesh.shape[a] for a in axes)) == 0 else None


def batch_axes(mesh, exclude_pod: bool = False):
    """Mesh axes carrying the batch dim; pod excluded inside manual-pod regions."""
    cand = (DATA,) if exclude_pod else (POD, DATA)
    axes = tuple(a for a in cand if a in mesh.axis_names)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def layer_slices(stacked: Sequence[torch.Tensor]) -> list[tuple[torch.Tensor, ...]]:
    """Each layer's leaves, from leaves stacked on a leading layer axis: one
    ``unbind`` per leaf. Indexing the stack per layer (``t[i]``) would give
    each layer's gradient its own zero-filled copy of the whole stack in the
    backward pass (``select_backward``), summed layer by layer: traffic that
    grows with the square of the depth. ``unbind``'s backward stacks the
    layers' gradients once; the sums are the same."""
    return list(zip(*(t.unbind(0) for t in stacked)))


class _NoBatchDots(TorchFunctionMode):
    """While entered, counts in ``state["inside"]`` the calls in flight of
    a product with no batch dims: an einsum none of whose dims appears in
    both operands and in the output, or an ``@`` with an operand of at most
    two dims (the weight projections). The dims' kind decides, as in the
    reference's ``dot_general``; aten's ``mm`` / ``bmm`` cannot tell it,
    since an einsum reaches them decomposed (a projection as a ``bmm`` of
    batch 1, an attention product at B = 1 over one kv head too)."""

    def __init__(self, state: dict):
        super().__init__()
        self.state = state

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not _no_batch_dims(func, args):
            return func(*args, **kwargs)
        self.state["inside"] += 1
        try:
            return func(*args, **kwargs)
        finally:
            self.state["inside"] -= 1


def _no_batch_dims(func, args) -> bool:
    """Whether ``func(*args)`` is a product with no batch dims."""
    if func is torch.einsum:
        ins, out = args[0].split("->")
        lhs, rhs = ins.split(",")
        return not set(lhs) & set(rhs) & set(out)
    # ``a @ b`` reaches a mode as one of these, by torch version
    return (func in (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__)
            and min(args[0].dim(), args[1].dim()) <= 2)


def _dots_policy(state: dict, ctx, op, *args, **kwargs):
    """The product inside a call that ``_NoBatchDots`` counts is saved,
    every other op recomputed."""
    if state["inside"] and op in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


@contextlib.contextmanager
def _entered(*managers):
    with contextlib.ExitStack() as stack:
        for m in managers:
            stack.enter_context(m)
        yield


def _dots_context():
    """``checkpoint``'s ``context_fn`` for "dots": the forward and the
    recompute each run under ``_NoBatchDots`` and the selective-checkpoint
    mode of ``_dots_policy``."""
    state = {"inside": 0}
    fwd, rec = create_selective_checkpoint_contexts(functools.partial(_dots_policy, state))
    return _entered(_NoBatchDots(state), fwd), _entered(_NoBatchDots(state), rec)


def remat_policy(name: str):
    """The reference's: None for "none" (no checkpoint); for "dots"
    ``checkpoint``'s ``context_fn`` that saves the outputs of the products
    with no batch dims (jax's ``dots_with_no_batch_dims_saveable``: the
    weight projections) and recomputes the rest, a ZeRO gather included;
    else one that saves nothing (``nothing_saveable``)."""
    if name == "none":
        return None
    if name == "dots":
        return _dots_context
    return noop_context_fn


def maybe_remat(fn, cfg: ModelConfig):
    """``fn`` recomputed in the backward pass by ``torch.utils.checkpoint``
    under ``remat_policy(cfg.remat)``; ``"none"``: ``fn``, its activations
    kept."""
    policy = remat_policy(cfg.remat)
    if policy is None:
        return fn

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, context_fn=policy)

    return wrapped
