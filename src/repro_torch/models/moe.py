"""Mixture-of-Experts LM: token-choice top-k routing with static capacity
and expert parallelism over the ``model`` axis.

Twin of ``repro.models.moe``. Each model column (rank of the model group):

  1. takes a 1/tp slice of its rows' tokens (rows j ≡ column mod tp);
  2. routes each token to its top-k experts in f32 (softmax, top-k,
     renormalised), ranks each assignment in its expert's bucket, and drops
     the assignments past the capacity C (per sending column and expert);
  3. scatters the kept ones into a (tp, E_loc, C, D) send buffer, block j
     for column j, which holds experts j·E_loc .. (j+1)·E_loc - 1;
  4. all-to-all over ``model``: each column receives its experts' rows from
     every column and runs its E_loc experts' gated FFNs as one batched
     matmul over tp·C rows each;
  5. all-to-all back, then sums each token's k rows weighted by the
     router's probabilities; the columns' token slices are gathered back
     into their order, so the residual is whole on every column again.

Placement is the reference's: with E >= tp a column holds E/tp whole
experts; with E < tp (grok-1's 8 experts on 16 columns) SPLIT = tp/E
columns share an expert, each an F/SPLIT slice of it, every token goes to
all SPLIT slices and their partial outputs are summed in the combine.
Weights keep the reference's pre-sliced layout ``(n_blocks, tp, E_loc, D,
F/SPLIT)``, cut over ``model`` on dim 1 (``param_specs``), so the param
tree, ``convert`` and a checkpoint MANIFEST equal the reference's at the
same tp. With tp = 1 there is no all-to-all and no slice. A tp that E
neither divides nor is divided by fails ``expert_layout``'s assert, as the
reference's does.

Each column uses only its slice of the normed residual and routes it with
the whole router: both gradients pass through ``_copy_in`` and are summed
over ``model``. The reference's sequence-sharded fast path has no
counterpart: the port's residual stays whole on every column (as in the
dense family), so the slice / gather bracket always runs. ``route_log``
receives each column's own slice.

torch has no scatter with a drop mode (the reference's ``.at[].add(...,
mode="drop")``): the buffer gets a spare slot C that every dropped
assignment writes to and that is cut off before the all-to-all, so a
dropped assignment never lands in slot C-1. Kept assignments own their
slot, so the scatter is a plain assignment. The rank is the reference's
(the assignments to the same expert before this one, in token-major
order), taken by a stable sort by expert where the reference scans a
(T*k, E) one-hot: at 65,536 assignments and 128 experts that scan took
24 ms a call on an H100 80GB HBM3 at 700 W, a fifth of the train step. The
combine sums a (T, k, D) tensor over k for each F-slice where the reference
scatter-adds over ``repeat(arange(T), k)`` slice by slice: the same sum, in
another order, with no atomics.

Over the pod and data axes each rank routes its own rows, with the
capacity C taken over its own tokens, as the reference's per-shard
``block`` does inside its ``shard_map``. Over a ``data`` axis (ZeRO-3)
the router and each rank's expert blocks are cut by ``D`` too and reach
``_mlp`` gathered whole in ``D`` (``DenseLM._backbone`` gathers a layer's
leaves before its attention), still cut over ``model``.

Decode and prefill over a ``model`` axis are ``DenseLM``'s, with the params
in these train specs (the reference serves the MoE with them too): decode
gathers a layer's ZeRO blocks as the forward does, and each step's few
rows go through ``_mlp`` as the forward's do. A column whose slice holds
only the rows that pad B·S to a multiple of tp routes those zero rows
among themselves (each sender has its own capacity), and their outputs are
cut off after the gather.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.distributed.mesh import DATA, MODEL, P
from repro_torch.models import common as cm
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import DenseLM


def expert_layout(cfg: ModelConfig, tp: int) -> tuple[int, int, int]:
    """(E_loc, SPLIT, C_factor-less layout) for a model axis of size tp."""
    E = cfg.n_experts
    if E >= tp:
        assert E % tp == 0, (E, tp)
        return E // tp, 1, tp
    assert tp % E == 0, (E, tp)
    return 1, tp // E, E


def capacity(t_sub: int, cfg: ModelConfig, tp: int, cf: float = 2.0) -> int:
    """Per-(dest-column, local-expert) receive capacity from one sender."""
    e_loc, split, _ = expert_layout(cfg, tp)
    per_bucket = t_sub * cfg.top_k * split / (tp * e_loc)
    return max(4, int(math.ceil(per_bucket * cf)))


def bucket_slots(flat_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each assignment's 0-based rank among the assignments to its expert,
    in their order in ``flat_e``: the reference's ``sum(cumsum(one_hot) *
    one_hot) - 1``, by a stable sort by expert. The bucket sizes come from a
    ``scatter_add_`` into ``n_experts`` zeros, whose shape does not depend on
    the data (``bincount``'s does), so the step walks on fake tensors."""
    order = torch.argsort(flat_e, stable=True)
    counts = torch.zeros(n_experts, dtype=flat_e.dtype, device=flat_e.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts                 # each bucket's first
    slot = torch.empty_like(flat_e)
    slot[order] = torch.arange(flat_e.numel(), device=flat_e.device) - starts[flat_e[order]]
    return slot


def _moe_local(x_my, wr, wg, wi, wo, *, cfg: ModelConfig, tp: int, cf: float,
               group=None, route_log: list | None = None):
    """MoE over this column's token slice. x_my: (T_sub, D); wg/wi: (E_loc,
    D, Fs), wo: (E_loc, Fs, D), this column's experts (all E at tp = 1).
    Over tp > 1 columns the dispatch and the return trip are all-to-alls
    over ``group`` (the model group). Returns (T_sub, D). ``route_log``,
    when given, receives the router's probabilities (T_sub, E) in f32."""
    if tp > 1 and group is None:
        raise ValueError(f"expert parallelism over {tp} columns needs their group")
    T, D = x_my.shape
    E, k = cfg.n_experts, cfg.top_k
    e_loc, split, _ = expert_layout(cfg, tp)
    if wg.shape[0] != e_loc:
        raise ValueError(f"weights of {wg.shape[0]} experts a column, where {tp} columns "
                         f"hold {e_loc} (a tree laid out for another model axis)")
    C = capacity(T, cfg, tp, cf)

    # ---- routing (f32 for stability)
    probs = torch.softmax(x_my.float() @ wr.float(), dim=-1)               # (T, E)
    if route_log is not None:
        route_log.append(probs.detach())
    top_p, top_e = torch.topk(probs, k, dim=-1)                           # (T, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # ---- rank in bucket (g·E_loc + el = the expert), token-major; past C, dropped
    flat_e = top_e.reshape(-1)                                            # (T*k,)
    g, el = flat_e // e_loc, flat_e % e_loc                               # column group, local
    slot = bucket_slots(flat_e, E)
    keep = slot < C
    slot_c = torch.where(keep, slot, C)                                   # C marks a drop
    dests = [g * split + h for h in range(split)]                         # each F-slice's column

    # ---- dispatch: (tp, E_loc, C + 1, D), the spare slot C cut off; the
    # SPLIT slices of an expert each get a copy of its rows
    vals = x_my[:, None, :].expand(T, k, D).reshape(T * k, D).to(cfg.dtype)
    send = torch.zeros((tp, e_loc, C + 1, D), dtype=cfg.dtype, device=x_my.device)
    if split > 1:
        vals = vals.repeat(split, 1)
    send = send.index_put((torch.cat(dests), el.repeat(split), slot_c.repeat(split)),
                          vals)[:, :, :C]
    recv = cm.all_to_all(send, group) if tp > 1 else send

    # ---- the E_loc experts' gated FFNs, tp·C rows each
    xe = recv.transpose(0, 1).reshape(e_loc, tp * C, D)
    hg = cm.act_fn(cfg.act)(torch.einsum("etd,edf->etf", xe, wg))
    hi = torch.einsum("etd,edf->etf", xe, wi)
    out = torch.einsum("etf,efd->etd", hg * hi, wo)                       # (E_loc, tp*C, D)
    out = out.reshape(e_loc, tp, C, D).transpose(0, 1)                    # (tp, E_loc, C, D)
    back = cm.all_to_all(out, group) if tp > 1 else out

    # ---- combine: each (token, choice) row of each F-slice, weighted, summed
    flat_back = back.reshape(tp * e_loc * C, D)
    y = None
    for dest in dests:
        lin = (dest * e_loc + el) * C + torch.clamp(slot_c, max=C - 1)
        picked = torch.where(keep[:, None], flat_back.index_select(0, lin).float(), 0.0)
        part = (picked.reshape(T, k, D) * top_p[..., None]).sum(1)
        y = part if y is None else y + part
    return y.to(cfg.dtype)


class MoELM(DenseLM):
    """DenseLM attention + MoE FFN."""

    def __init__(self, cfg: ModelConfig, mesh=None, *, cf: float = 2.0):
        super().__init__(cfg, mesh)
        self.tp = self._tp()
        self.cf = cf
        self.route_log: list | None = None   # a list to record each MoE layer's routing

    # -- params --------------------------------------------------------------
    def init_params(self, seed: int = 0, device="cuda") -> Any:
        params = super().init_params(seed, device)
        cfg = self.cfg
        ini = cm.Initializer(seed + 1, cfg.dtype, device)
        nb, D, Fd, E = self.n_blocks, cfg.d_model, cfg.d_ff, cfg.n_experts
        e_loc, split, _ = expert_layout(cfg, self.tp)
        fs = Fd // split
        for i in range(len(self.pattern)):
            lp = params["blocks"][str(i)]
            for key in ("wi", "wg", "wmo"):
                del lp[key]
            lp["router"] = ini(f"b{i}.router", (nb, D, E), scale=1.0 / math.sqrt(D))
            lp["we_g"] = ini(f"b{i}.we_g", (nb, self.tp, e_loc, D, fs))
            lp["we_i"] = ini(f"b{i}.we_i", (nb, self.tp, e_loc, D, fs))
            lp["we_o"] = ini(f"b{i}.we_o", (nb, self.tp, e_loc, fs, D),
                             scale=1.0 / math.sqrt(Fd))
        return params

    def param_specs(self, mesh, *, serve: bool = False) -> Any:
        """The reference's: the experts' column dim over ``model``, the
        router whole. ``serve`` changes nothing: the reference's
        ``param_specs`` takes no ``serve``, so its ``build_serve_step``
        falls back to these train specs."""
        specs = super().param_specs(mesh)
        d_dat = cm.shardable(self.cfg.d_model, DATA, mesh)
        for i in range(len(self.pattern)):
            lp = specs["blocks"][str(i)]
            for key in ("wi", "wg", "wmo"):
                del lp[key]
            lp["router"] = P(None, d_dat, None)
            lp["we_g"] = P(None, MODEL, None, d_dat, None)
            lp["we_i"] = P(None, MODEL, None, d_dat, None)
            lp["we_o"] = P(None, MODEL, None, None, d_dat)
        return specs

    # -- the MoE FFN replaces the dense MLP ----------------------------------
    def _mlp(self, x, lp):
        """Over tp > 1 columns, column r takes rows j ≡ r (mod tp) of the
        flat (B·S, D) tokens (padded to a multiple of tp), runs
        ``_moe_local`` on them, and the columns' rows are gathered back into
        their order. Each column uses only its rows of the normed residual
        and routes them with the whole router, so both gradients are summed
        over ``model``."""
        B, S, D = x.shape
        tp, t = self.tp, B * S
        flat = self._copy_in(cm.rms_norm(x, lp["ln2"])).reshape(t, D)
        wr, wg, wi, wo = (lp[k] for k in ("router", "we_g", "we_i", "we_o"))
        if tp == 1:
            y = _moe_local(flat, wr, wg[0], wi[0], wo[0], cfg=self.cfg, tp=1, cf=self.cf,
                           route_log=self.route_log)
            return x + y.reshape(B, S, D)
        pad = (-t) % tp                                  # rows that tp does not divide
        if pad:
            flat = F.pad(flat, (0, 0, 0, pad))
        x_my = flat.reshape(-1, tp, D)[:, self._mrank()]
        y_my = _moe_local(x_my, self._copy_in(wr), wg[0], wi[0], wo[0], cfg=self.cfg, tp=tp,
                          cf=self.cf, group=self.mesh.group(MODEL), route_log=self.route_log)
        y = self._stack_out(y_my).transpose(0, 1).reshape(-1, D)[:t]   # stack: (tp, T_sub, D)
        return x + y.reshape(B, S, D)
