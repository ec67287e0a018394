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
forward (``_zero_top``), and their gradients reduce-scattered. Decode
takes whole params; over a ``model`` axis it waits for ROADMAP Queue 1
item 6.
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
        (``distributed.mesh.shard``)."""
        if serve:
            raise NotImplementedError(
                "weight-stationary serve specs are not ported (ROADMAP Queue 1 item 6)")
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

    def _attn_out(self, o, lp):
        o = torch.einsum("bsnh,nhd->bsd", o, lp["wo"])
        o = self._reduce_out(o, self._split(self.cfg.n_heads))
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
        return x + self._attn_out(o, lp)

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

    def _block(self, params, b: int) -> dict:
        """Block ``b``'s params: a view of each stacked leaf."""
        return {str(i): {k: t[b] for k, t in params["blocks"][str(i)].items()}
                for i in range(len(self.pattern))}

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

    @staticmethod
    def _cache_write(cache_k, cache_v, cache_p, k_new, v_new, pos, slot):
        """Write one token's K/V at per-batch ``slot``, in place.
        shapes: cache (B, T, KVH, hd), k_new/v_new (B, 1, KVH, hd), pos (B,)."""
        rows = torch.arange(cache_k.shape[0], device=cache_k.device)
        slot = slot.long()
        cache_k[rows, slot] = k_new[:, 0].to(cache_k.dtype)
        cache_v[rows, slot] = v_new[:, 0].to(cache_v.dtype)
        cache_p[rows, slot] = pos.to(cache_p.dtype)
        return cache_k, cache_v, cache_p

    def decode_step(self, params, cache, tokens, pos):
        """tokens: (B, 1) int, pos: (B,) current absolute position.

        Returns (logits (B,1,V), cache) — the cache updated in place."""
        cfg = self.cfg
        cm.refuse_model_axis(self.mesh, "decode", "item 6")
        x = self._embed(params, tokens)
        q_pos = pos[:, None]
        for b in range(self.n_blocks):
            blk = self._block(params, b)
            for i, kind in enumerate(self.pattern):
                ck, cv, cp = cache[f"k{i}"][b], cache[f"v{i}"][b], cache[f"p{i}"][b]
                slot = pos % ck.shape[1]   # ring slot for local windows; == pos for global
                lp = blk[str(i)]
                q, k_new, v_new = self._qkv(x, lp, q_pos)
                self._cache_write(ck, cv, cp, k_new, v_new, pos, slot)
                o = cm.attention(
                    q, ck, cv, causal=True, q_positions=q_pos, kv_positions=cp,
                    window=cfg.window if kind == "l" else None,
                    logit_cap=cfg.attn_softcap,
                )
                x = x + self._attn_out(o, lp)
                x = self._mlp(x, lp)
        x = cm.rms_norm(x, params["final_norm"])
        logits = torch.einsum("bsd,dv->bsv", x, self._out_w(params))
        return cm.softcap(logits, cfg.final_softcap), cache
