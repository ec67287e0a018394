"""Dense decoder-only transformer LM (gemma, gemma2, yi, mistral-nemo, ...).

Twin of ``repro.models.transformer``. Layers are grouped into blocks of
``len(attn_pattern)`` (gemma2's "lg" -> 13 blocks of local+global) whose
params are stacked on a leading block axis, the reference's parameter tree
leaf for leaf: ``embed``, ``final_norm``,
``blocks/<i>/{ln1, ln2, wq, wk, wv, wo, wi, wg, wmo[, post_ln1, post_ln2]}``
and ``unembed`` when untied — so a checkpoint MANIFEST of this model names
the same leaves, shapes and dtypes as the reference's. The model holds no
parameters of its own: like the reference it takes the params tree as an
argument, so the optimizer state and the checkpoint mirror that tree.

Decode keeps per-kind KV caches: local layers get a ring buffer of
``window`` slots, global layers a full-length cache; each slot also records
its absolute position, so masking (validity, causality, window) is uniform
for both. ``decode_step`` writes the new slot into the cache in place and
returns it.

Over a ``model`` axis (tensor parallelism) the train forward runs on this
rank's blocks of the weights (``param_specs``, then
``distributed.mesh.shard``): ``wq`` by heads and ``wk``/``wv`` by kv heads
(whole where the axis does not divide them, as gemma-2b's one kv head),
``wo`` row-parallel, ``wi``/``wg`` column- and ``wmo`` row-parallel, and
``embed``/``unembed`` by vocab, each bracketed by ``ShardingMixin``'s
operators. The residual stays whole on every model rank. Over a ``data``
axis (ZeRO-3) every weight's ``d_model`` dim is cut too: a block's leaves
are gathered inside its remat region, ``embed`` / ``unembed`` once a
forward (``_zero_top``), and their gradients reduce-scattered.

Decode over a ``model`` axis takes the params in either of the
reference's layouts: the train specs (``param_specs``: heads, ffn, vocab,
and ``d_model`` over ``data``, gathered a layer at a time as the forward
gathers it) or the weight-stationary serve specs
(``param_specs(serve=True)``: head_dim, ffn and vocab, nothing over
``data``, so no weight moves). The cache is laid out by ``cache_specs``
(the reference's ``kv_cache_spec``): the batch over pod x data, the time
dim over ``model``; at a batch that pod x data does not divide (B = 1,
long context) the batch stays whole on every rank and the time dim is cut
over ``data`` and ``pod`` too, model-major. A layer computes this rank's
block of the new token's q, k and v and gathers them whole over ``model``
in one all-gather, then rotates them (RoPE pairs element i of head_dim
with element i + hd/2, which the serve layout puts on different ranks);
the rank that owns slot ``pos % T`` writes it; each rank attends its own
time block (``common.partial_attention``) and the partial softmaxes are
combined by log-sum-exp over the axes that cut the time
(``ShardingMixin._combine``); each rank then feeds its block of the
output to its rows of ``wo`` and the partial sums are all-reduced over
``model``. Over ``data`` at B = 1 every rank computes the same row, so
under the serve specs only the combine crosses ``data``; train-spec
blocks are still gathered over it (ZeRO-3).
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.distributed.mesh import DATA, MODEL, P
from repro_torch.models import common as cm
from repro_torch.models.common import ModelConfig


class DenseLM(cm.ShardingMixin, torch.nn.Module):
    def __init__(self, cfg: ModelConfig, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        pat = cfg.attn_pattern
        assert cfg.n_layers % len(pat) == 0, (cfg.name, cfg.n_layers, pat)
        self.n_blocks = cfg.n_layers // len(pat)
        self.pattern = pat

    # -- params ------------------------------------------------------------
    def init_params(self, seed: int = 0, device="cuda") -> Any:
        cfg = self.cfg
        ini = cm.Initializer(seed, cfg.dtype, device)
        nb, D, H, KVH, hd, F = (self.n_blocks, cfg.d_model, cfg.n_heads,
                                cfg.n_kv_heads, cfg.hd, cfg.d_ff)
        blocks: dict[str, Any] = {}
        for i in range(len(self.pattern)):
            lp = {
                "ln1": ini.zeros((nb, D)),
                "ln2": ini.zeros((nb, D)),
                "wq": ini(f"b{i}.wq", (nb, D, H, hd)),
                "wk": ini(f"b{i}.wk", (nb, D, KVH, hd)),
                "wv": ini(f"b{i}.wv", (nb, D, KVH, hd)),
                "wo": ini(f"b{i}.wo", (nb, H, hd, D), scale=1 / math.sqrt(H * hd)),
                "wi": ini(f"b{i}.wi", (nb, D, F)),
                "wg": ini(f"b{i}.wg", (nb, D, F)),
                "wmo": ini(f"b{i}.wmo", (nb, F, D), scale=1 / math.sqrt(F)),
            }
            if cfg.post_norms:
                lp["post_ln1"] = ini.zeros((nb, D))
                lp["post_ln2"] = ini.zeros((nb, D))
            blocks[str(i)] = lp
        params = {
            "embed": ini("embed", (cfg.vocab, D), scale=1.0),
            "final_norm": ini.zeros((D,)),
            "blocks": blocks,
        }
        if not cfg.tie_embeddings:
            params["unembed"] = ini("unembed", (D, cfg.vocab))
        return params

    def param_specs(self, mesh, *, serve: bool = False) -> Any:
        """The reference's train-time PartitionSpecs, entry for entry: the
        ``model`` entries cut a leaf for tensor parallelism and the ``data``
        ones (every weight's ``d_model`` dim) for ZeRO-3
        (``distributed.mesh.shard``). ``serve``: the weight-stationary
        decode specs (``_serve_param_specs``)."""
        if serve:
            return self._serve_param_specs(mesh)
        cfg = self.cfg
        sh = lambda n, ax: cm.shardable(n, ax, mesh)  # noqa: E731
        m_head = sh(cfg.n_heads, MODEL)
        m_kv = sh(cfg.n_kv_heads, MODEL)
        m_ff = sh(cfg.d_ff, MODEL)
        m_voc = sh(cfg.vocab, MODEL)
        d_dat = sh(cfg.d_model, DATA)
        lp = {
            "ln1": P(None, None),
            "ln2": P(None, None),
            "wq": P(None, d_dat, m_head, None),
            "wk": P(None, d_dat, m_kv, None),
            "wv": P(None, d_dat, m_kv, None),
            "wo": P(None, m_head, None, d_dat),
            "wi": P(None, d_dat, m_ff),
            "wg": P(None, d_dat, m_ff),
            "wmo": P(None, m_ff, d_dat),
        }
        if cfg.post_norms:
            lp["post_ln1"] = P(None, None)
            lp["post_ln2"] = P(None, None)
        specs = {
            "embed": P(m_voc, d_dat),
            "final_norm": P(None),
            "blocks": {str(i): dict(lp) for i in range(len(self.pattern))},
        }
        if not cfg.tie_embeddings:
            specs["unembed"] = P(d_dat, m_voc)
        return specs

    def _serve_param_specs(self, mesh) -> Any:
        """The reference's weight-stationary decode specs, entry for entry:
        every weight cut over ``model`` along a dim that is not contracted
        (head_dim of ``wq``/``wk``/``wv`` and of ``wo``'s rows, ffn, vocab),
        nothing over ``data``, so decode gathers no weight; its collectives
        are activation-sized."""
        cfg = self.cfg
        hd_m = cm.shardable(cfg.hd, MODEL, mesh)
        m_ff = cm.shardable(cfg.d_ff, MODEL, mesh)
        m_voc = cm.shardable(cfg.vocab, MODEL, mesh)
        lp = {
            "ln1": P(None, None), "ln2": P(None, None),
            "wq": P(None, None, None, hd_m),
            "wk": P(None, None, None, hd_m),
            "wv": P(None, None, None, hd_m),
            "wo": P(None, None, hd_m, None),
            "wi": P(None, None, m_ff),
            "wg": P(None, None, m_ff),
            "wmo": P(None, m_ff, None),
        }
        if cfg.post_norms:
            lp["post_ln1"] = P(None, None)
            lp["post_ln2"] = P(None, None)
        specs = {
            "embed": P(m_voc, None),
            "final_norm": P(None),
            "blocks": {str(i): dict(lp) for i in range(len(self.pattern))},
        }
        if not cfg.tie_embeddings:
            specs["unembed"] = P(None, m_voc)
        return specs

    # -- shared layer application -------------------------------------------
    def _qkv(self, x, lp, q_pos):
        """Rotated q, k, v of this rank's heads: ``wq`` by heads, and
        ``wk``/``wv`` by kv heads where the model axis divides them; a
        whole ``wk``/``wv`` feeds only this rank's heads, so its gradient
        is summed over ``model``."""
        cfg = self.cfg
        heads = self._split(cfg.n_heads)
        whole_kv = heads and not self._split(cfg.n_kv_heads)
        h = self._copy_in(cm.rms_norm(x, lp["ln1"]), heads)
        q = torch.einsum("bsd,dnh->bsnh", h, lp["wq"])
        k_new = torch.einsum("bsd,dkh->bskh", h, self._copy_in(lp["wk"], whole_kv))
        v_new = torch.einsum("bsd,dkh->bskh", h, self._copy_in(lp["wv"], whole_kv))
        q = cm.rope(q, q_pos, cfg.rope_theta)
        k_new = cm.rope(k_new, q_pos, cfg.rope_theta)
        return q, k_new, v_new

    def _attn_out(self, o, lp, split: bool):
        """The row-parallel output projection of ``o`` (this rank's block of
        it where ``wo`` is ``split``), summed over ``model``."""
        o = torch.einsum("bsnh,nhd->bsd", o, lp["wo"])
        o = self._reduce_out(o, split)
        if self.cfg.post_norms:
            o = cm.rms_norm(o, lp["post_ln1"])
        return o

    def _attn(self, x, lp, kind, q_pos):
        """One attention sub-layer of the train forward."""
        cfg = self.cfg
        q, k, v = self._qkv(x, lp, q_pos)
        k, v = self._local_kv(k, v)
        o = cm.attention(
            q, k, v, causal=True, q_positions=q_pos, kv_positions=q_pos,
            window=cfg.window if kind == "l" else None,
            logit_cap=cfg.attn_softcap,
        )
        return x + self._attn_out(o, lp, self._split(cfg.n_heads))

    def _mlp(self, x, lp):
        cfg = self.cfg
        ffn = self._split(cfg.d_ff)
        h = self._copy_in(cm.rms_norm(x, lp["ln2"]), ffn)
        g = cm.act_fn(cfg.act)(torch.einsum("bsd,df->bsf", h, lp["wg"]))
        u = torch.einsum("bsd,df->bsf", h, lp["wi"])
        m = self._reduce_out(torch.einsum("bsf,fd->bsd", g * u, lp["wmo"]), ffn)
        if cfg.post_norms:
            m = cm.rms_norm(m, lp["post_ln2"])
        return x + m

    def _embed(self, params, tokens):
        cfg = self.cfg
        x = self._lookup(params["embed"], tokens)
        if cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
        return x.to(cfg.dtype)

    # -- train forward -------------------------------------------------------
    def hidden(self, params, tokens):
        """Backbone: final-normed hidden states (B, S, D)."""
        params = self._zero_top(params)
        return self._backbone(params, self._embed(params, tokens))

    def _backbone(self, params, x):
        """The blocks and the final norm over embedded inputs ``x`` (B, S, D)
        at positions 0..S-1; each block's leaves are gathered over ``data``
        inside its remat region."""
        B, S = x.shape[:2]
        pos = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
        lspecs = None
        if self._dp() > 1:
            specs = self.param_specs(self.mesh)["blocks"]
            lspecs = [specs[str(i)][k] for i in range(len(self.pattern))
                      for k in params["blocks"][str(i)]]

        def body(x, *leaves):
            it = iter(self._zero_layer(leaves, lspecs))
            for i, kind in enumerate(self.pattern):
                lp = {k: next(it) for k in params["blocks"][str(i)]}
                x = self._attn(x, lp, kind, pos)
                x = self._mlp(x, lp)
            return x

        step = cm.maybe_remat(body, self.cfg)
        stacked = [t for i in range(len(self.pattern)) for t in params["blocks"][str(i)].values()]
        for leaves in cm.layer_slices(stacked):
            x = step(x, *leaves)
        return cm.rms_norm(x, params["final_norm"])

    def _out_w(self, params):
        """The unembedding (D, V), or this rank's vocab block of it."""
        cfg = self.cfg
        w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
        return w.to(cfg.dtype)

    def logits(self, params, tokens):
        params = self._zero_top(params)
        return self._unembed(params, self.hidden(params, tokens))

    forward = logits

    def loss(self, params, batch):
        tokens = batch["tokens"]
        params = self._zero_top(params)
        h = self.hidden(params, tokens[:, :-1])
        return self._xent(params, h, tokens[:, 1:], final_cap=self.cfg.final_softcap)

    # -- decode ----------------------------------------------------------------
    def cache_len(self, kind: str, max_len: int) -> int:
        return min(self.cfg.window, max_len) if kind == "l" else max_len

    def init_cache(self, batch: int, max_len: int, device="cuda") -> Any:
        cfg = self.cfg
        nb, KVH, hd = self.n_blocks, cfg.n_kv_heads, cfg.hd
        cache = {}
        for i, kind in enumerate(self.pattern):
            T = self.cache_len(kind, max_len)
            cache[f"k{i}"] = torch.zeros((nb, batch, T, KVH, hd), dtype=cfg.dtype, device=device)
            cache[f"v{i}"] = torch.zeros((nb, batch, T, KVH, hd), dtype=cfg.dtype, device=device)
            cache[f"p{i}"] = torch.full((nb, batch, T), -1, dtype=torch.int32, device=device)
        return cache

    def cache_specs(self, mesh, batch: int, max_len: int) -> Any:
        """The reference's: each kind's cache by ``kv_cache_spec``."""
        specs = {}
        for i, kind in enumerate(self.pattern):
            T = self.cache_len(kind, max_len)
            kv = cm.kv_cache_spec(mesh, batch, T, extra=(None, None))
            specs[f"k{i}"] = kv
            specs[f"v{i}"] = kv
            specs[f"p{i}"] = cm.kv_cache_spec(mesh, batch, T)
        return specs

    def _decode_attn(self, x, lp, kind, ck, cv, cp, pos, time_cut: tuple):
        """One decode attention sub-layer on this rank's blocks of the
        weights and the cache: q, k and v gathered whole over ``model`` in
        one all-gather along the dim the layout cuts (heads for the train
        specs, head_dim for the serve specs; none where the block is
        whole), then rotated; the new slot written and the cache attended
        by ``ShardingMixin._cached_attention``. Returns the sub-layer's
        output (B, 1, D), summed over ``model``."""
        cfg = self.cfg
        q_pos = pos[:, None]
        h = cm.rms_norm(x, lp["ln1"])
        q = torch.einsum("bsd,dnh->bsnh", h, lp["wq"])
        k = torch.einsum("bsd,dkh->bskh", h, lp["wk"])
        v = torch.einsum("bsd,dkh->bskh", h, lp["wv"])
        q, k, v = self._whole_heads(
            (q, k, v), ((cfg.n_heads, cfg.hd), (cfg.n_kv_heads, cfg.hd), (cfg.n_kv_heads, cfg.hd)))
        q = cm.rope(q, q_pos, cfg.rope_theta)
        k = cm.rope(k, q_pos, cfg.rope_theta)
        o = self._cached_attention(q, ck, cv, cp, pos, time_cut, new=(k, v),
                                   window=cfg.window if kind == "l" else None,
                                   logit_cap=cfg.attn_softcap)
        o, cut = self._own_rows(o, lp["wo"])        # wo: (H, hd, D) or this rank's rows
        return self._attn_out(o, lp, cut)

    def decode_step(self, params, cache, tokens, pos, cache_specs=None):
        """tokens: (B, 1) int, pos: (B,) current absolute position.

        Returns (logits (B,1,V), cache) — the cache updated in place.

        Over a mesh, ``params`` are this rank's blocks under the train or
        the serve specs (told apart by each block's shape), and ``cache``,
        ``tokens`` and ``pos`` this rank's blocks under ``cache_specs``,
        the specs the cache was cut by (None: the cache whole on every
        rank). Train-spec blocks cut over ``data`` (ZeRO-3) are gathered a
        layer at a time, as the forward gathers them."""
        cfg = self.cfg
        time_cut = [self._time_cut(None if cache_specs is None else cache_specs[f"p{i}"])
                    for i in range(len(self.pattern))]
        keys = [(str(i), k) for i in range(len(self.pattern)) for k in params["blocks"][str(i)]]
        zero = self._dp() > 1 and params["blocks"]["0"]["wq"].shape[1] != cfg.d_model
        lspecs = None
        if zero:
            params = self._zero_top(params)
            specs = self.param_specs(self.mesh)["blocks"]
            lspecs = [specs[i][k] for i, k in keys]
        x = self._embed(params, tokens)
        stacked = [params["blocks"][i][k] for i, k in keys]
        for b, leaves in enumerate(cm.layer_slices(stacked)):
            blk: dict = {}
            for (i, k), t in zip(keys, self._zero_layer(leaves, lspecs) if zero else leaves):
                blk.setdefault(i, {})[k] = t
            for i, kind in enumerate(self.pattern):
                lp = blk[str(i)]
                x = x + self._decode_attn(x, lp, kind, cache[f"k{i}"][b], cache[f"v{i}"][b],
                                          cache[f"p{i}"][b], pos, time_cut[i])
                x = self._mlp(x, lp)
        x = cm.rms_norm(x, params["final_norm"])
        return cm.softcap(self._unembed(params, x), cfg.final_softcap), cache
