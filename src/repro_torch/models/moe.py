"""Mixture-of-Experts LM: token-choice top-k routing with static capacity.

Twin of ``repro.models.moe`` on a model axis of one (tp = 1). The
reference dispatches and combines with GShard/Switch-style all-to-alls over
its model axis; with one column there is no all-to-all, and what is left is
the local half of the same algorithm:

  1. route each token to its top-k experts in f32 (softmax, top-k,
     renormalised), rank each assignment in its expert's bucket, and drop
     the assignments past the capacity C;
  2. scatter the kept assignments into an (E, C, D) send buffer;
  3. run the E experts' gated FFNs as one batched matmul over C rows each;
  4. gather each (token, choice) row back and sum the k rows weighted by
     the router's probabilities.

torch has no scatter with a drop mode (the reference's ``.at[].add(...,
mode="drop")``): the buffer gets a spare slot C that every dropped
assignment writes to and that is cut off before the experts run, so a
dropped assignment never lands in slot C-1. Kept assignments own their
slot, so the scatter is a plain assignment. The rank is the reference's
(the assignments to the same expert before this one, in token-major
order), taken by a stable sort by expert where the reference scans a
(T*k, E) one-hot: at 65,536 assignments and 128 experts that scan took
24 ms a call on an H100 80GB HBM3 at 700 W, a fifth of the train step. The combine sums a (T, k, D)
tensor over k where the reference scatter-adds over ``repeat(arange(T),
k)``: the same sum, in another order, with no atomics.

Weights keep the reference's pre-sliced layout ``(n_blocks, tp, E_loc, D,
F/SPLIT)``, so the param tree, ``convert`` and a checkpoint MANIFEST equal
the reference's. Over the pod and data axes each rank routes its own rows,
with the capacity C taken over its own tokens, as the reference's
per-shard ``block`` does inside its ``shard_map``. A ``model`` axis over 1
raises until expert parallelism is ported (ROADMAP Queue 1 item 3).
"""
from __future__ import annotations

import math
from typing import Any

import torch

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
               route_log: list | None = None):
    """MoE over this column's tokens. x_my: (T, D); wg/wi: (E, D, F), wo: (E, F, D).

    Returns (T, D). ``route_log``, when given, receives the router's
    probabilities (T, E) in f32."""
    if tp != 1:
        raise NotImplementedError(
            f"expert parallelism over {tp} columns needs the all-to-alls of "
            "repro_torch.distributed (ROADMAP Queue 1, distributed/)")
    T, D = x_my.shape
    E, k = cfg.n_experts, cfg.top_k
    C = capacity(T, cfg, tp, cf)

    # ---- routing (f32 for stability)
    probs = torch.softmax(x_my.float() @ wr.float(), dim=-1)               # (T, E)
    if route_log is not None:
        route_log.append(probs.detach())
    top_p, top_e = torch.topk(probs, k, dim=-1)                           # (T, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # ---- rank in bucket, token-major; past the capacity, dropped
    flat_e = top_e.reshape(-1)                                            # (T*k,)
    slot = bucket_slots(flat_e, E)
    keep = slot < C
    slot_c = torch.where(keep, slot, C)                                   # C marks a drop

    # ---- dispatch: (E, C + 1, D) with the spare slot C cut off
    vals = x_my[:, None, :].expand(T, k, D).reshape(T * k, D).to(cfg.dtype)
    send = torch.zeros((E, C + 1, D), dtype=cfg.dtype, device=x_my.device)
    xe = send.index_put((flat_e, slot_c), vals)[:, :C]

    # ---- the experts' gated FFNs, C rows each
    hg = cm.act_fn(cfg.act)(torch.einsum("etd,edf->etf", xe, wg))
    hi = torch.einsum("etd,edf->etf", xe, wi)
    out = torch.einsum("etf,efd->etd", hg * hi, wo)                       # (E, C, D)

    # ---- combine: each (token, choice) row, weighted, summed over k
    lin = flat_e * C + torch.clamp(slot_c, max=C - 1)
    picked = out.reshape(E * C, D).index_select(0, lin).float()
    picked = torch.where(keep[:, None], picked, 0.0)
    y = (picked.reshape(T, k, D) * top_p[..., None]).sum(1)
    return y.to(cfg.dtype)


class MoELM(DenseLM):
    """DenseLM attention + MoE FFN."""

    def __init__(self, cfg: ModelConfig, mesh=None, *, cf: float = 2.0):
        super().__init__(cfg, mesh)
        cm.refuse_model_axis(mesh, "a MoE (expert parallelism)", "item 3")
        self.tp = 1
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

    # -- the MoE FFN replaces the dense MLP ----------------------------------
    def _mlp(self, x, lp):
        B, S, D = x.shape
        h = cm.rms_norm(x, lp["ln2"])
        y = _moe_local(h.reshape(B * S, D), lp["router"], lp["we_g"][0], lp["we_i"][0],
                       lp["we_o"][0], cfg=self.cfg, tp=self.tp, cf=self.cf,
                       route_log=self.route_log)
        return x + y.reshape(B, S, D)
