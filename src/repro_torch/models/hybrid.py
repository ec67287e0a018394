"""RecurrentGemma (Griffin): RG-LRU recurrent blocks + local MQA, 2:1 pattern.

Twin of ``repro.models.hybrid``. Layer layout (26 layers): repeating
(recurrent, recurrent, local-attention) blocks — 8 full blocks — plus a
2-layer recurrent tail. The main stack walks the 8 blocks; the tail is a
second stack with its own stacked params.

RG-LRU recurrence:
    r_t = sigmoid(x_t W_a + b_a)          (recurrence gate)
    i_t = sigmoid(x_t W_x + b_x)          (input gate)
    log a_t = -c * softplus(Lambda) * r_t (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Training runs the recurrence as a log-depth scan over the sequence
(Hillis-Steele: log2(l) rounds of the associative combine, where the
reference calls ``lax.associative_scan``). Decode carries (recurrent state,
conv window, local-attn KV ring) and updates the cache in place.

Over a ``model`` axis (tensor parallelism) ``param_specs`` is the
reference's. A recurrent layer runs on this rank's ``lru_width`` channels:
``wx`` / ``wy`` column-parallel, the conv, ``ba``, ``bxg`` and ``lam`` per
channel, the conv's output gathered over ``model`` into ``wa`` / ``wxg``
(only their output dim is cut; the gather's backward is a reduce-scatter),
the RG-LRU elementwise and ``wo`` row-parallel. The MLPs are column / row
pairs over ``d_ff``; the attention splits by heads where ``model`` divides
them (the one kv head whole) and runs whole on every rank where it does
not; the tied embedding is vocab-parallel. Decode over a ``model`` axis
runs the same layers on this rank's blocks of a cache laid out by the
reference's ``cache_specs``: the recurrent states and conv windows by
channels, the local-attention ring by time (over ``model``, and at a batch
that pod x data does not divide over ``data`` and ``pod`` too, so the
slot's owner moves across the whole group as the ring wraps), attended by
each rank over its slots and combined by log-sum-exp
(``ShardingMixin._cached_attention``);
where the heads stay whole, the whole q meets each rank's slots and ``wo``
needs no sum.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.distributed.mesh import DATA, MODEL, P
from repro_torch.models import common as cm
from repro_torch.models.common import ModelConfig
from repro_torch.models.ssm import _causal_conv

_C = 8.0  # RG-LRU gate sharpness constant


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over dim 1 with h_{-1} = 0, in log2(l)
    rounds: round d combines each position with the one d before it,
    (a_l, b_l) then (a_r, b_r) -> (a_l * a_r, a_r * b_l + b_r)."""
    d = 1
    while d < a.shape[1]:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rg_lru(x, gates_a, gates_x, lam, h0=None):
    """x: (b,l,w). gates: pre-activations (b,l,w). lam: (w,). Returns (y, h_last)."""
    r = torch.sigmoid(gates_a.float())
    i = torch.sigmoid(gates_x.float())
    log_a = -_C * F.softplus(lam.float())[None, None, :] * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * i * x.float()
    if h0 is not None:
        # fold the carried state into the first step: h_1 = a_1 h0 + b_1
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]], dim=1)
    h = linear_scan(a, b)
    return h.to(x.dtype), h[:, -1]


def rg_lru_step(h, x_t, ga_t, gx_t, lam):
    """One decode step. h: (b,w); x_t/gates: (b,w)."""
    r = torch.sigmoid(ga_t.float())
    i = torch.sigmoid(gx_t.float())
    a = torch.exp(-_C * F.softplus(lam.float())[None, :] * r)
    h = a * h.float() + torch.sqrt(torch.clamp(1 - a * a, min=1e-12)) * i * x_t.float()
    return h, h


class RecurrentGemmaLM(cm.ShardingMixin, torch.nn.Module):
    PATTERN = ("r", "r", "a")

    def __init__(self, cfg: ModelConfig, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        self.w = cfg.lru_width or cfg.d_model
        kinds = []
        while len(kinds) < cfg.n_layers:
            kinds.extend(self.PATTERN)
        self.kinds = tuple(kinds[: cfg.n_layers])
        self.n_blocks = cfg.n_layers // len(self.PATTERN)
        self.n_tail = cfg.n_layers - self.n_blocks * len(self.PATTERN)
        assert all(k == "r" for k in self.kinds[self.n_blocks * 3:]), self.kinds

    # -- params ----------------------------------------------------------------
    def _rec_params(self, ini, n, tag):
        cfg, D, w = self.cfg, self.cfg.d_model, self.w
        return {
            "ln": ini.zeros((n, D)),
            "wx": ini(f"{tag}.wx", (n, D, w)),
            "wy": ini(f"{tag}.wy", (n, D, w)),
            "conv_w": ini(f"{tag}.conv", (n, w, cfg.conv1d_size), scale=0.5),
            "wa": ini(f"{tag}.wa", (n, w, w), scale=1.0 / math.sqrt(w)),
            "ba": ini.zeros((n, w)),
            "wxg": ini(f"{tag}.wxg", (n, w, w), scale=1.0 / math.sqrt(w)),
            "bxg": ini.zeros((n, w)),
            "lam": ini.ones((n, w)),
            "wo": ini(f"{tag}.wo", (n, w, D), scale=1.0 / math.sqrt(w)),
            "ln2": ini.zeros((n, D)),
            "mi": ini(f"{tag}.mi", (n, D, cfg.d_ff)),
            "mg": ini(f"{tag}.mg", (n, D, cfg.d_ff)),
            "mo": ini(f"{tag}.mo", (n, cfg.d_ff, D), scale=1.0 / math.sqrt(cfg.d_ff)),
        }

    def _attn_params(self, ini, n, tag):
        cfg, D = self.cfg, self.cfg.d_model
        H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        return {
            "ln": ini.zeros((n, D)),
            "wq": ini(f"{tag}.wq", (n, D, H, hd)),
            "wk": ini(f"{tag}.wk", (n, D, KVH, hd)),
            "wv": ini(f"{tag}.wv", (n, D, KVH, hd)),
            "wo": ini(f"{tag}.wo", (n, H, hd, D), scale=1.0 / math.sqrt(H * hd)),
            "ln2": ini.zeros((n, D)),
            "mi": ini(f"{tag}.mi", (n, D, cfg.d_ff)),
            "mg": ini(f"{tag}.mg", (n, D, cfg.d_ff)),
            "mo": ini(f"{tag}.mo", (n, cfg.d_ff, D), scale=1.0 / math.sqrt(cfg.d_ff)),
        }

    def init_params(self, seed: int = 0, device="cuda") -> Any:
        cfg = self.cfg
        ini = cm.Initializer(seed, cfg.dtype, device)
        params = {
            "embed": ini("embed", (cfg.vocab, cfg.d_model), scale=1.0),
            "final_norm": ini.zeros((cfg.d_model,)),
            "rec0": self._rec_params(ini, self.n_blocks, "rec0"),
            "rec1": self._rec_params(ini, self.n_blocks, "rec1"),
            "attn": self._attn_params(ini, self.n_blocks, "attn"),
        }
        if self.n_tail:
            params["tail"] = self._rec_params(ini, self.n_tail, "tail")
        return params

    def _rec_specs(self, mesh):
        cfg = self.cfg
        d_dat = cm.shardable(cfg.d_model, DATA, mesh)
        w_m = cm.shardable(self.w, MODEL, mesh)
        f_m = cm.shardable(cfg.d_ff, MODEL, mesh)
        return {
            "ln": P(None, None), "ln2": P(None, None),
            "wx": P(None, d_dat, w_m), "wy": P(None, d_dat, w_m),
            "conv_w": P(None, w_m, None),
            "wa": P(None, None, w_m), "ba": P(None, w_m),
            "wxg": P(None, None, w_m), "bxg": P(None, w_m),
            "lam": P(None, w_m),
            "wo": P(None, w_m, d_dat),
            "mi": P(None, d_dat, f_m), "mg": P(None, d_dat, f_m),
            "mo": P(None, f_m, d_dat),
        }

    def param_specs(self, mesh) -> Any:
        """The reference's train-time PartitionSpecs, entry for entry."""
        cfg = self.cfg
        d_dat = cm.shardable(cfg.d_model, DATA, mesh)
        m_head = cm.shardable(cfg.n_heads, MODEL, mesh)
        m_kv = cm.shardable(cfg.n_kv_heads, MODEL, mesh)
        f_m = cm.shardable(cfg.d_ff, MODEL, mesh)
        attn = {
            "ln": P(None, None), "ln2": P(None, None),
            "wq": P(None, d_dat, m_head, None),
            "wk": P(None, d_dat, m_kv, None),
            "wv": P(None, d_dat, m_kv, None),
            "wo": P(None, m_head, None, d_dat),
            "mi": P(None, d_dat, f_m), "mg": P(None, d_dat, f_m),
            "mo": P(None, f_m, d_dat),
        }
        specs = {
            "embed": P(cm.shardable(cfg.vocab, MODEL, mesh), d_dat),
            "final_norm": P(None),
            "rec0": self._rec_specs(mesh),
            "rec1": self._rec_specs(mesh),
            "attn": attn,
        }
        if self.n_tail:
            specs["tail"] = self._rec_specs(mesh)
        return specs

    # -- sub-layer applications ---------------------------------------------
    def _mlp(self, x, lp):
        """GeGLU, column-parallel ``mi`` / ``mg`` and row-parallel ``mo``
        over a split ``d_ff``."""
        ffn = self._split(self.cfg.d_ff)
        h = self._copy_in(cm.rms_norm(x, lp["ln2"]), ffn)
        g = cm.act_fn("gelu")(torch.einsum("bld,df->blf", h, lp["mg"]))
        u = torch.einsum("bld,df->blf", h, lp["mi"])
        return x + self._reduce_out(torch.einsum("blf,fd->bld", g * u, lp["mo"]), ffn)

    def _rec_in(self, x, lp, conv_cache=None):
        """The recurrent layer up to the RG-LRU: (x branch, gelu branch,
        recurrence and input gate pre-activations, new conv window), each
        of this rank's ``lru_width`` channels over a split: ``wx`` / ``wy``
        column-parallel, the conv per channel, and the conv's output
        gathered over ``model`` into ``wa`` / ``wxg``, whose output dim
        only is cut."""
        part = self._split(self.w)
        h = self._copy_in(cm.rms_norm(x, lp["ln"]), part)
        xb = torch.einsum("bld,dw->blw", h, lp["wx"])
        yb = cm.act_fn("gelu")(torch.einsum("bld,dw->blw", h, lp["wy"]))
        xb, new_conv = _causal_conv(xb, lp["conv_w"], cache=conv_cache)
        xg = self._gather_in(xb, part)
        ga = torch.einsum("blw,wu->blu", xg, lp["wa"]) + lp["ba"]
        gx = torch.einsum("blw,wu->blu", xg, lp["wxg"]) + lp["bxg"]
        return xb, yb, ga, gx, new_conv

    def _rec_layer(self, x, lp, conv_cache=None, h0=None):
        """Returns (x_out, new_conv_cache, h_last); ``wo`` row-parallel over
        a split ``lru_width``."""
        xb, yb, ga, gx, new_conv = self._rec_in(x, lp, conv_cache)
        hseq, h_last = rg_lru(xb, ga, gx, lp["lam"], h0=h0)
        out = torch.einsum("blw,wd->bld", hseq.to(x.dtype) * yb, lp["wo"])
        out = self._reduce_out(out, self._split(self.w))
        return self._mlp(x + out, lp), new_conv, h_last

    def _qkv(self, x, lp, q_pos):
        """Rotated q, k, v of this rank's heads where ``model`` splits the
        heads (a whole ``wk`` / ``wv`` feeds them only: its gradient is
        summed over ``model``); all heads on every rank where it does
        not."""
        cfg = self.cfg
        heads = self._split(cfg.n_heads)
        whole_kv = heads and not self._split(cfg.n_kv_heads)
        h = self._copy_in(cm.rms_norm(x, lp["ln"]), heads)
        q = torch.einsum("bsd,dnh->bsnh", h, lp["wq"])
        k = torch.einsum("bsd,dkh->bskh", h, self._copy_in(lp["wk"], whole_kv))
        v = torch.einsum("bsd,dkh->bskh", h, self._copy_in(lp["wv"], whole_kv))
        return cm.rope(q, q_pos, cfg.rope_theta), cm.rope(k, q_pos, cfg.rope_theta), v

    def _attn_layer(self, x, lp, q_pos):
        q, k, v = self._qkv(x, lp, q_pos)
        k, v = self._local_kv(k, v)
        o = cm.attention(q, k, v, causal=True, q_positions=q_pos,
                         kv_positions=q_pos, window=self.cfg.window)
        o = torch.einsum("bsnh,nhd->bsd", o, lp["wo"])
        return self._mlp(x + self._reduce_out(o, self._split(self.cfg.n_heads)), lp)

    def _embed(self, params, tokens):
        x = self._lookup(params["embed"], tokens).to(self.cfg.dtype)
        return x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype, device=x.device)

    # -- train ------------------------------------------------------------------
    def hidden(self, params, tokens):
        cfg = self.cfg
        B, S = tokens.shape
        params = self._zero_top(params)
        x = self._embed(params, tokens)
        pos = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
        names = ("rec0", "rec1", "attn")
        keys = {n: list(params[n]) for n in names}
        specs = self.param_specs(self.mesh) if self._dp() > 1 else None
        lspecs = None if specs is None else [specs[n][k] for n in names for k in keys[n]]

        def body(x, *leaves):
            it = iter(self._zero_layer(leaves, lspecs))
            blk = {n: {k: next(it) for k in keys[n]} for n in names}
            x, _, _ = self._rec_layer(x, blk["rec0"])
            x, _, _ = self._rec_layer(x, blk["rec1"])
            return self._attn_layer(x, blk["attn"], pos)

        step = cm.maybe_remat(body, cfg)
        for leaves in cm.layer_slices([params[n][k] for n in names for k in keys[n]]):
            x = step(x, *leaves)
        if self.n_tail:
            tkeys = list(params["tail"])
            tspecs = None if specs is None else [specs["tail"][k] for k in tkeys]

            def tail_body(x, *leaves):
                return self._rec_layer(x, dict(zip(tkeys, self._zero_layer(leaves, tspecs))))[0]

            tail_step = cm.maybe_remat(tail_body, cfg)
            for leaves in cm.layer_slices([params["tail"][k] for k in tkeys]):
                x = tail_step(x, *leaves)
        return cm.rms_norm(x, params["final_norm"])

    def _out_w(self, params):
        return params["embed"].T.to(self.cfg.dtype)

    def logits(self, params, tokens):
        params = self._zero_top(params)
        return self._unembed(params, self.hidden(params, tokens))

    forward = logits

    def loss(self, params, batch):
        tokens = batch["tokens"]
        params = self._zero_top(params)
        h = self.hidden(params, tokens[:, :-1])
        return self._xent(params, h, tokens[:, 1:], final_cap=self.cfg.final_softcap)

    # -- decode -------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device="cuda") -> Any:
        cfg = self.cfg
        nb, w, k = self.n_blocks, self.w, cfg.conv1d_size
        T = min(cfg.window, max_len)

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        cache = {
            "h0": zeros((nb, batch, w), torch.float32),
            "c0": zeros((nb, batch, k - 1, w), cfg.dtype),
            "h1": zeros((nb, batch, w), torch.float32),
            "c1": zeros((nb, batch, k - 1, w), cfg.dtype),
            "ak": zeros((nb, batch, T, cfg.n_kv_heads, cfg.hd), cfg.dtype),
            "av": zeros((nb, batch, T, cfg.n_kv_heads, cfg.hd), cfg.dtype),
            "ap": torch.full((nb, batch, T), -1, dtype=torch.int32, device=device),
        }
        if self.n_tail:
            cache["ht"] = zeros((self.n_tail, batch, w), torch.float32)
            cache["ct"] = zeros((self.n_tail, batch, k - 1, w), cfg.dtype)
        return cache

    def cache_specs(self, mesh, batch: int, max_len: int) -> Any:
        """The reference's: the batch over pod x data where their product
        divides it; the recurrent states and conv windows by ``lru_width``
        over ``model``, the local attention's ring by ``kv_cache_spec`` on
        its ``min(window, max_len)`` slots."""
        b = cm.cache_batch_spec(mesh, batch)
        w_m = cm.shardable(self.w, MODEL, mesh)
        T = min(self.cfg.window, max_len)
        kv = cm.kv_cache_spec(mesh, batch, T, extra=(None, None))
        specs = {"h0": P(None, b, w_m), "c0": P(None, b, None, w_m),
                 "h1": P(None, b, w_m), "c1": P(None, b, None, w_m),
                 "ak": kv, "av": kv, "ap": cm.kv_cache_spec(mesh, batch, T)}
        if self.n_tail:
            specs["ht"] = P(None, b, w_m)
            specs["ct"] = P(None, b, None, w_m)
        return specs

    def _rec_step(self, x, lp, h_cache, c_cache):
        """x: (B,1,D). Updates this layer's state ``h_cache`` (B, w) and conv
        window ``c_cache`` in place (this rank's channels of each over a
        split ``lru_width``, as ``_rec_in`` computes them); returns x_out,
        ``wo`` row-parallel."""
        xb, yb, ga, gx, new_conv = self._rec_in(x, lp, c_cache)
        h_new, hs = rg_lru_step(h_cache, xb[:, 0], ga[:, 0], gx[:, 0], lp["lam"])
        h_cache.copy_(h_new)
        c_cache.copy_(new_conv)
        out = torch.einsum("blw,wd->bld", hs[:, None].to(x.dtype) * yb, lp["wo"])
        return self._mlp(x + self._reduce_out(out, self._split(self.w)), lp)

    def _decode_attn(self, x, lp, ck, cv, cp, pos, time_cut: tuple):
        """The local-attention layer of a decode step: q, k and v of this
        rank's heads gathered whole over ``model`` (all heads on every rank
        where the axis does not divide them), rotated, and the ring's slot
        written and attended by ``ShardingMixin._cached_attention`` (over a
        ring cut by time each rank attends its slots); then ``wo`` on this
        rank's heads, summed over ``model``, and the MLP."""
        cfg = self.cfg
        q_pos = pos[:, None]
        h = cm.rms_norm(x, lp["ln"])
        q = torch.einsum("bsd,dnh->bsnh", h, lp["wq"])
        k = torch.einsum("bsd,dkh->bskh", h, lp["wk"])
        v = torch.einsum("bsd,dkh->bskh", h, lp["wv"])
        kv = (cfg.n_kv_heads, cfg.hd)
        q, k, v = self._whole_heads((q, k, v), ((cfg.n_heads, cfg.hd), kv, kv))
        q, k = cm.rope(q, q_pos, cfg.rope_theta), cm.rope(k, q_pos, cfg.rope_theta)
        o = self._cached_attention(q, ck, cv, cp, pos, time_cut, new=(k, v), window=cfg.window)
        return self._mlp(x + self._heads_out(o, lp["wo"]), lp)

    def decode_step(self, params, cache, tokens, pos, cache_specs=None):
        """tokens: (B, 1) int, pos: (B,). Returns (logits (B,1,V), cache) —
        the cache updated in place.

        Over a mesh, ``params`` are this rank's blocks under the train
        specs (ZeRO blocks gathered a layer at a time, as the forward
        gathers them) and ``cache`` its blocks under ``cache_specs`` (None:
        whole on every rank): the recurrent layers run on this rank's
        channels, the local attention over its slots of the ring."""
        cfg = self.cfg
        time_cut = self._time_cut(None if cache_specs is None else cache_specs["ap"])
        names = ("rec0", "rec1", "attn") + (("tail",) if self.n_tail else ())
        keys = {n: list(params[n]) for n in names}
        zero = self._dp() > 1 and params["rec0"]["wx"].shape[1] != cfg.d_model
        specs = None
        if zero:
            params = self._zero_top(params)
            specs = self.param_specs(self.mesh)

        def layers(group):
            lspecs = None if specs is None else [specs[n][k] for n in group for k in keys[n]]
            for leaves in cm.layer_slices([params[n][k] for n in group for k in keys[n]]):
                it = iter(self._zero_layer(leaves, lspecs) if zero else leaves)
                yield {n: {k: next(it) for k in keys[n]} for n in group}

        x = self._embed(params, tokens)
        for b, blk in enumerate(layers(("rec0", "rec1", "attn"))):
            x = self._rec_step(x, blk["rec0"], cache["h0"][b], cache["c0"][b])
            x = self._rec_step(x, blk["rec1"], cache["h1"][b], cache["c1"][b])
            x = self._decode_attn(x, blk["attn"], cache["ak"][b], cache["av"][b],
                                  cache["ap"][b], pos, time_cut)
        if self.n_tail:
            for j, blk in enumerate(layers(("tail",))):
                x = self._rec_step(x, blk["tail"], cache["ht"][j], cache["ct"][j])
        x = cm.rms_norm(x, params["final_norm"])
        return cm.softcap(self._unembed(params, x), cfg.final_softcap), cache
