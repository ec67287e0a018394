"""Forward and loss of the dense and MoE decoder families, in plain torch.

Published layer equations (Mistral-Nemo, Qwen3-MoE; Qwen3's q/k norm is not
modelled, as the program leaves it out): pre-norm blocks, RMSNorm, RoPE on
the two halves of each head, causal GQA attention with scale 1/sqrt(hd),
a SwiGLU MLP (silu(h Wg) * (h Wi)) Wo, or for the MoE a router softmax over
the experts, its top-k renormalised, each token's k expert SwiGLUs weighted
by them. Mean next-token cross-entropy over every position.

Where the cell's program departs from the published model, the reference
follows the program, and each departure is said here: the MoE has a
static capacity per expert, C = max(4, ceil(T k / E * capacity_factor)) over
the T tokens of a step, and an assignment whose rank in its expert's bucket
(the assignments to that expert before it, token-major, choices in the
top-k's order) is C or more is dropped: it adds nothing, and the other
choices of its token keep their weights. RMSNorm weights are offsets from 1.

Every product goes through ``prec.einsum`` (``precision``); everything
else is float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.dims import Dims


def rms_norm(x, offset, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + offset)


def rope(x, theta: float):
    """x: (S, heads, hd), positions 0..S-1."""
    S, hd = x.shape[0], x.shape[-1]
    half = hd // 2
    inv = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device),
                    -torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, prec):
    """Causal GQA over one sequence: q (S, H, hd), k and v (S, KVH, hd);
    query head h reads kv head h // (H / KVH)."""
    S, H, hd = q.shape
    g = H // k.shape[1]
    k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    s = prec.einsum("shd,thd->hst", q, k) / math.sqrt(hd)
    causal = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    return prec.einsum("hst,thd->shd", p, v)


def swiglu(h, wg, wi, wo, prec):
    return prec.einsum("tf,fd->td", F.silu(prec.einsum("td,df->tf", h, wg))
                       * prec.einsum("td,df->tf", h, wi), wo)


def capacity(tokens: int, dm: Dims) -> int:
    return max(4, math.ceil(tokens * dm.top_k / dm.experts * dm.capacity_factor))


def moe(h, router, wg, wi, wo, dm: Dims, prec):
    """h: (T, D); wg, wi: (E, D, F), wo: (E, F, D). Returns (T, D) and the
    number of dropped assignments."""
    T = h.shape[0]
    E, k = dm.experts, dm.top_k
    probs = torch.softmax(prec.einsum("td,de->te", h, router), dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    flat_e = top_e.reshape(-1)                            # token-major assignments
    onehot = F.one_hot(flat_e, E)
    rank = (onehot.cumsum(0) * onehot).sum(-1) - 1
    keep = rank < capacity(T, dm)
    token = torch.arange(T, device=h.device).repeat_interleave(k)
    weight = top_p.reshape(-1)
    y = torch.zeros_like(h)
    for e in range(E):
        sel = torch.nonzero(keep & (flat_e == e)).squeeze(1)
        if sel.numel() == 0:
            continue
        t = token[sel]
        out = swiglu(h[t], wg[e], wi[e], wo[e], prec) * weight[sel, None]
        y = y.index_add(0, t, out)
    return y, int((~keep).sum())


def hidden(p: dict, tokens, dm: Dims, prec, route: list | None = None):
    """Final-normed hidden states (B, S, D) of ``tokens`` (B, S). ``p``:
    float32 leaves keyed by path. A MoE routes all B * S tokens at once;
    ``route``, where given, receives each MoE layer's dropped count."""
    B, S = tokens.shape
    D = dm.d
    x = p["embed"][tokens.long()]
    stacked = {k.split("/")[-1]: t.unbind(0) for k, t in p.items() if k.startswith("blocks/0/")}
    for layer in range(dm.layers):
        w = {k: t[layer] for k, t in stacked.items()}
        h = rms_norm(x, w["ln1"], dm.eps)
        rows = []
        for b in range(B):
            q = rope(prec.einsum("sd,dnh->snh", h[b], w["wq"]), dm.theta)
            k = rope(prec.einsum("sd,dnh->snh", h[b], w["wk"]), dm.theta)
            v = prec.einsum("sd,dnh->snh", h[b], w["wv"])
            rows.append(prec.einsum("snh,nhd->sd", attention(q, k, v, prec), w["wo"]))
        x = x + torch.stack(rows)
        h = rms_norm(x, w["ln2"], dm.eps).reshape(B * S, D)
        if dm.family == "moe":
            y, dropped = moe(h, w["router"], w["we_g"][0], w["we_i"][0], w["we_o"][0], dm, prec)
            if route is not None:
                route.append(dropped)
        else:
            y = swiglu(h, w["wg"], w["wi"], w["wmo"], prec)
        x = x + y.reshape(B, S, D)
    return rms_norm(x, p["final_norm"], dm.eps)


def out_weight(p: dict, dm: Dims):
    return p["embed"].T if dm.tie else p["unembed"]


def nll_sum(h, w, labels, prec):
    """Sum over rows of h (N, D) of -log softmax(h w)[label]."""
    logits = prec.einsum("nd,dv->nv", h, w)
    return (torch.logsumexp(logits, dim=-1)
            - logits.gather(-1, labels.long()[:, None])[:, 0]).sum()
