"""Whisper-family encoder-decoder (audio backbone; conv frontend stubbed).

Twin of ``repro.models.encdec``. The modality frontend is a stub: the batch
provides precomputed frame embeddings (B, enc_positions, d_model) — the
log-mel + 2xConv1d stem's output — and this module implements the
transformer backbone: sinusoidal encoder positions, learned decoder
positions, MHA (kv_heads == heads), plain 2-layer GELU MLPs with biases,
pre-LayerNorm with biases, causal decoder self-attention and
cross-attention to the encoder output.

The params tree is the reference's leaf for leaf: ``embed`` (tied),
``pos_dec`` (``max_target`` rows), ``enc/{self,mlp}``,
``dec/{self,cross,mlp}`` with the layers stacked on a leading axis, and
the final norms with their biases. Each encoder and decoder layer is
recomputed in the backward pass under ``remat="full"``. The encoder's
1500 frames take the blocked online-softmax attention (KV padded to the
block with position -1), the decoder's self- and cross-attention at
Whisper's 448 target positions the dense one.

Decode: ``prefill_cross`` fills each decoder layer's cross-attention K/V
from the encoder output, then ``decode_step`` writes each token's
self-attention K/V into the cache in place and returns that cache.

Over a ``model`` axis (tensor parallelism) ``param_specs`` is the
reference's: the encoder's and decoder's self-attention and the
cross-attention split by heads (the whole encoder output feeds this rank's
cross K/V heads, so its gradient is summed over ``model``), ``w1`` / ``b1``
column- and ``w2`` row-parallel with ``b2`` added once after the sum, and
the tied embedding vocab-parallel where ``model`` divides the vocab.
``pos_dec``, the layer norms and the encoder's sinusoids stay whole. Over
a ``data`` axis (ZeRO-3) both stacks' weights and ``embed`` are cut by
``d_model`` and gathered where they are used (``_run_stack``,
``_zero_top``). The
reference's ``_qspec`` (context-parallel queries where a 16-wide axis
does not divide 20 heads) is a layout hint of GSPMD with no counterpart.
Over a ``model`` axis the decode cache is laid out by the reference's
``cache_specs``: the self-attention cache and the cross K/V both cut by
time, every head on every rank (at a batch that pod x data does not
divide, over ``data`` and ``pod`` too). ``prefill_cross`` re-cuts the
cross K/V of this rank's heads into its block of positions with one
all-to-all over ``model``, then keeps its data and pod sub-block, and
``decode_step`` attends each rank's blocks and combines them by
log-sum-exp.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.distributed.mesh import DATA, MODEL, P, block_index
from repro_torch.models import common as cm
from repro_torch.models.common import ModelConfig


def layer_norm(x, scale, bias, eps=1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """The encoder's position table (length, channels), f32. Computed in
    float64 and rounded once, so every device adds the same table; the
    reference's f32 computation differs from it by up to an ulp of the
    angle (1.2e-4 at position 1500)."""
    t = torch.arange(length, dtype=torch.float64, device=device)[:, None]
    inv = torch.exp(-math.log(10000.0)
                    * torch.arange(channels // 2, dtype=torch.float64, device=device)
                    / (channels // 2 - 1))
    ang = t * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1).float()


class WhisperLM(cm.ShardingMixin, torch.nn.Module):
    def __init__(self, cfg: ModelConfig, mesh=None, *, max_target: int = 448):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        self.max_target = max_target

    # -- params ---------------------------------------------------------------
    def _attn_p(self, ini, n, tag):
        cfg, D = self.cfg, self.cfg.d_model
        H, hd = cfg.n_heads, cfg.hd
        return {
            "ln_s": ini.ones((n, D)), "ln_b": ini.zeros((n, D)),
            "wq": ini(f"{tag}.wq", (n, D, H, hd)),
            "wk": ini(f"{tag}.wk", (n, D, H, hd)),
            "wv": ini(f"{tag}.wv", (n, D, H, hd)),
            "wo": ini(f"{tag}.wo", (n, H, hd, D), scale=1.0 / math.sqrt(H * hd)),
        }

    def _mlp_p(self, ini, n, tag):
        cfg, D = self.cfg, self.cfg.d_model
        return {
            "ln_s": ini.ones((n, D)), "ln_b": ini.zeros((n, D)),
            "w1": ini(f"{tag}.w1", (n, D, cfg.d_ff)),
            "b1": ini.zeros((n, cfg.d_ff)),
            "w2": ini(f"{tag}.w2", (n, cfg.d_ff, D), scale=1.0 / math.sqrt(cfg.d_ff)),
            "b2": ini.zeros((n, D)),
        }

    def init_params(self, seed: int = 0, device="cuda") -> Any:
        cfg = self.cfg
        ini = cm.Initializer(seed, cfg.dtype, device)
        ne, nd, D = cfg.n_enc_layers, cfg.n_layers, cfg.d_model
        return {
            "embed": ini("embed", (cfg.vocab, D), scale=1.0),
            "pos_dec": ini("pos_dec", (self.max_target, D), scale=0.02),
            "enc": {"self": self._attn_p(ini, ne, "enc.self"),
                    "mlp": self._mlp_p(ini, ne, "enc.mlp")},
            "enc_norm_s": ini.ones((D,)), "enc_norm_b": ini.zeros((D,)),
            "dec": {"self": self._attn_p(ini, nd, "dec.self"),
                    "cross": self._attn_p(ini, nd, "dec.cross"),
                    "mlp": self._mlp_p(ini, nd, "dec.mlp")},
            "dec_norm_s": ini.ones((D,)), "dec_norm_b": ini.zeros((D,)),
        }

    def param_specs(self, mesh) -> Any:
        """The reference's train-time PartitionSpecs, entry for entry."""
        cfg = self.cfg
        d_dat = cm.shardable(cfg.d_model, DATA, mesh)
        h_m = cm.shardable(cfg.n_heads, MODEL, mesh)
        f_m = cm.shardable(cfg.d_ff, MODEL, mesh)
        attn = {"ln_s": P(None, None), "ln_b": P(None, None),
                "wq": P(None, d_dat, h_m, None), "wk": P(None, d_dat, h_m, None),
                "wv": P(None, d_dat, h_m, None), "wo": P(None, h_m, None, d_dat)}
        mlp = {"ln_s": P(None, None), "ln_b": P(None, None),
               "w1": P(None, d_dat, f_m), "b1": P(None, f_m),
               "w2": P(None, f_m, d_dat), "b2": P(None, None)}
        return {
            "embed": P(cm.shardable(cfg.vocab, MODEL, mesh), d_dat),
            "pos_dec": P(None, None),
            "enc": {"self": dict(attn), "mlp": dict(mlp)},
            "enc_norm_s": P(None), "enc_norm_b": P(None),
            "dec": {"self": dict(attn), "cross": dict(attn), "mlp": dict(mlp)},
            "dec_norm_s": P(None), "dec_norm_b": P(None),
        }

    # -- sub-layers --------------------------------------------------------------
    def _sa(self, x, lp, *, causal, q_pos):
        """Self-attention, by heads over a split (kv heads = heads)."""
        heads = self._split(self.cfg.n_heads)
        h = self._copy_in(layer_norm(x, lp["ln_s"], lp["ln_b"]), heads)
        q = torch.einsum("bsd,dnh->bsnh", h, lp["wq"])
        k = torch.einsum("bsd,dnh->bsnh", h, lp["wk"])
        v = torch.einsum("bsd,dnh->bsnh", h, lp["wv"])
        o = cm.attention(q, k, v, causal=causal, q_positions=q_pos, kv_positions=q_pos)
        return x + self._reduce_out(torch.einsum("bsnh,nhd->bsd", o, lp["wo"]), heads)

    def _cross(self, x, lp, enc_k, enc_v, enc_pos, q_pos):
        """Cross-attention of this rank's heads over a split (``enc_k`` /
        ``enc_v`` of the same heads)."""
        heads = self._split(self.cfg.n_heads)
        h = self._copy_in(layer_norm(x, lp["ln_s"], lp["ln_b"]), heads)
        q = torch.einsum("bsd,dnh->bsnh", h, lp["wq"])
        o = cm.attention(q, enc_k, enc_v, causal=False,
                         q_positions=q_pos, kv_positions=enc_pos)
        return x + self._reduce_out(torch.einsum("bsnh,nhd->bsd", o, lp["wo"]), heads)

    def _mlp(self, x, lp):
        """``w1`` / ``b1`` column- and ``w2`` row-parallel over a split
        ``d_ff``; the whole ``b2`` is added once, after the sum."""
        ffn = self._split(self.cfg.d_ff)
        h = self._copy_in(layer_norm(x, lp["ln_s"], lp["ln_b"]), ffn)
        h = cm.act_fn("gelu")(torch.einsum("bsd,df->bsf", h, lp["w1"]) + lp["b1"])
        return x + self._reduce_out(torch.einsum("bsf,fd->bsd", h, lp["w2"]), ffn) + lp["b2"]

    def _run_stack(self, layer, name, stack, x, *extra):
        """``x = layer(x, *extra, lp)`` for each layer ``lp`` of ``stack``
        (sub-layers of leaves stacked on a leading axis; ``name`` its key in
        the params tree), each recomputed in the backward pass under remat,
        its leaves gathered over ``data`` inside that region."""
        keys = [(sub, k) for sub in stack for k in stack[sub]]
        lspecs = None
        if self._dp() > 1:
            specs = self.param_specs(self.mesh)[name]
            lspecs = [specs[sub][k] for sub, k in keys]

        def body(x, *args):
            lp: dict = {}
            leaves = self._zero_layer(args[len(extra):], lspecs)
            for (sub, k), t in zip(keys, leaves):
                lp.setdefault(sub, {})[k] = t
            return layer(x, *args[:len(extra)], lp)

        step = cm.maybe_remat(body, self.cfg)
        for leaves in cm.layer_slices([stack[sub][k] for sub, k in keys]):
            x = step(x, *extra, *leaves)
        return x

    @staticmethod
    def _positions(B, T, device):
        return torch.arange(T, dtype=torch.int32, device=device)[None].expand(B, T)

    # -- encoder -------------------------------------------------------------------
    def encode(self, params, audio_embed):
        cfg = self.cfg
        B, T, D = audio_embed.shape
        x = audio_embed.to(cfg.dtype) + sinusoids(T, D, audio_embed.device).to(cfg.dtype)[None]
        pos = self._positions(B, T, x.device)

        def layer(x, lp):
            x = self._sa(x, lp["self"], causal=False, q_pos=pos)
            return self._mlp(x, lp["mlp"])

        x = self._run_stack(layer, "enc", params["enc"], x)
        return layer_norm(x, params["enc_norm_s"], params["enc_norm_b"])

    # -- decoder (train) -------------------------------------------------------------
    def dec_hidden(self, params, tokens, enc_out):
        cfg = self.cfg
        B, S = tokens.shape
        params = self._zero_top(params)
        x = self._lookup(params["embed"], tokens).to(cfg.dtype)
        x = x + params["pos_dec"][:S][None].to(cfg.dtype)
        q_pos = self._positions(B, S, x.device)
        enc_pos = self._positions(B, enc_out.shape[1], x.device)

        def layer(x, enc_out, lp):
            x = self._sa(x, lp["self"], causal=True, q_pos=q_pos)
            ek = torch.einsum("btd,dnh->btnh", enc_out, lp["cross"]["wk"])
            ev = torch.einsum("btd,dnh->btnh", enc_out, lp["cross"]["wv"])
            x = self._cross(x, lp["cross"], ek, ev, enc_pos, q_pos)
            return self._mlp(x, lp["mlp"])

        # the whole encoder output feeds this rank's cross K/V heads only
        enc_out = self._copy_in(enc_out, self._split(cfg.n_heads))
        x = self._run_stack(layer, "dec", params["dec"], x, enc_out)
        return layer_norm(x, params["dec_norm_s"], params["dec_norm_b"])

    def dec_logits(self, params, tokens, enc_out):
        params = self._zero_top(params)
        return self._unembed(params, self.dec_hidden(params, tokens, enc_out))

    def loss(self, params, batch):
        params = self._zero_top(params)
        enc = self.encode(params, batch["audio_embed"])
        h = self.dec_hidden(params, batch["tokens"][:, :-1], enc)
        return self._xent(params, h, batch["tokens"][:, 1:])

    def _out_w(self, params):
        return params["embed"].T.to(self.cfg.dtype)

    # -- decode -----------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device="cuda") -> Any:
        """Decoder self-attn KV ring + cross-attn KV (filled by prefill_cross)."""
        cfg = self.cfg
        nd, H, hd, Te = cfg.n_layers, cfg.n_heads, cfg.hd, cfg.enc_positions

        def zeros(T):
            return torch.zeros((nd, batch, T, H, hd), dtype=cfg.dtype, device=device)

        return {"k": zeros(max_len), "v": zeros(max_len),
                "p": torch.full((nd, batch, max_len), -1, dtype=torch.int32, device=device),
                "ek": zeros(Te), "ev": zeros(Te)}

    def cache_specs(self, mesh, batch: int, max_len: int) -> Any:
        """The reference's: the self-attention cache by ``kv_cache_spec`` on
        ``max_len``, the cross K/V by ``kv_cache_spec`` on the encoder's
        positions (time over ``model``, every head on every rank)."""
        kv = cm.kv_cache_spec(mesh, batch, max_len, extra=(None, None))
        ekv = cm.kv_cache_spec(mesh, batch, self.cfg.enc_positions, extra=(None, None))
        return {"k": kv, "v": kv, "p": cm.kv_cache_spec(mesh, batch, max_len),
                "ek": ekv, "ev": ekv}

    def prefill_cross(self, params, cache, audio_embed, cache_specs=None):
        """Compute the encoder output and fill per-layer cross-attn K/V.

        Over a mesh, ``params`` are this rank's blocks under the train
        specs, ``audio_embed`` its rows and ``cache_specs`` the specs the
        cache is cut by (None: whole on every rank). The encoder runs
        head-parallel, as in training, and this rank's cross ``wk`` /
        ``wv`` heads take every encoder position; the cache wants every
        head of this rank's block of positions, so one all-to-all over
        ``model`` turns the heads' cut into the time's (where the time is
        not cut over ``model``, the heads are gathered). Where the time is
        also cut over ``data`` or ``pod`` (a batch that they do not divide,
        so every rank there computed the same rows) each rank keeps its
        sub-block of that, with no collective."""
        cfg = self.cfg
        enc = self.encode(params, audio_embed)
        specs = self.param_specs(self.mesh)["dec"]["cross"] if self._dp() > 1 else None
        wk, wv = (params["dec"]["cross"][k] if specs is None else self._zero(
            params["dec"]["cross"][k], specs[k]) for k in ("wk", "wv"))
        kv = torch.stack([torch.einsum("btd,ldnh->lbtnh", enc, w) for w in (wk, wv)])
        rest = self._time_cut(None if cache_specs is None else cache_specs["ek"])
        heads_cut = kv.shape[-2] != cfg.n_heads
        if MODEL in rest and heads_cut:  # (2, L, B, Te, H/tp, hd) -> (2, L, B, Te/tp, H, hd)
            tp = self._tp()
            two, L, B, Te, h, hd = kv.shape
            blocks = kv.reshape(two, L, B, tp, Te // tp, h, hd).movedim(3, 0)
            got = cm.all_to_all(blocks, self.mesh.group(MODEL))      # [j]: rank j's heads
            kv = got.permute(1, 2, 3, 4, 0, 5, 6).reshape(two, L, B, Te // tp, tp * h, hd)
            rest = tuple(a for a in rest if a != MODEL)              # model is outermost
        elif heads_cut:
            kv = self._gather_model([kv], -2)[0]
        if rest:
            i, n = block_index(self.mesh, rest)
            kv = kv.narrow(3, i * (kv.shape[3] // n), kv.shape[3] // n)
        return {**cache, "ek": kv[0].contiguous(), "ev": kv[1].contiguous()}

    def decode_step(self, params, cache, tokens, pos, cache_specs=None):
        """tokens: (B, 1) int, pos: (B,) current absolute position (the
        position embedding clamps at ``max_target - 1``).

        Returns (logits (B,1,V), cache) — the cache updated in place.

        Over a mesh, ``params`` are this rank's blocks under the train
        specs (ZeRO blocks gathered a layer at a time) and ``cache`` its
        blocks under ``cache_specs`` (None: whole on every rank). The
        self-attention gathers q, k and v over heads, writes the new slot
        on the rank that holds it and attends each rank's time block; the
        cross-attention gathers q and attends each rank's block of the
        encoder positions, unmasked; each combines the ranks' partial
        softmaxes by log-sum-exp (``ShardingMixin._cached_attention``).
        Each rank then feeds its heads of o to its rows of ``wo``."""
        cfg = self.cfg
        B = tokens.shape[0]
        self_cut, cross_cut = (self._time_cut(None if cache_specs is None else cache_specs[k])
                               for k in ("p", "ek"))
        keys = [(sub, k) for sub in params["dec"] for k in params["dec"][sub]]
        zero = self._dp() > 1 and params["dec"]["self"]["wq"].shape[1] != cfg.d_model
        lspecs = None
        if zero:
            params = self._zero_top(params)
            specs = self.param_specs(self.mesh)["dec"]
            lspecs = [specs[sub][k] for sub, k in keys]
        x = self._lookup(params["embed"], tokens).to(cfg.dtype)
        pos_emb = params["pos_dec"][torch.clamp(pos, max=self.max_target - 1).long()]
        x = x + pos_emb[:, None].to(cfg.dtype)
        te = cache["ek"].shape[2]                          # this rank's encoder positions
        e0 = block_index(self.mesh, cross_cut)[0] * te
        enc_pos = self._positions(B, te, x.device) + e0
        heads = ((cfg.n_heads, cfg.hd),) * 3
        stacked = [params["dec"][sub][k] for sub, k in keys]
        for i, leaves in enumerate(cm.layer_slices(stacked)):
            lp: dict = {}
            for (sub, k), t in zip(keys, self._zero_layer(leaves, lspecs) if zero else leaves):
                lp.setdefault(sub, {})[k] = t
            sa, ca = lp["self"], lp["cross"]
            h = layer_norm(x, sa["ln_s"], sa["ln_b"])
            q, k, v = self._whole_heads([torch.einsum("bsd,dnh->bsnh", h, sa[w])
                                         for w in ("wq", "wk", "wv")], heads)
            o = self._cached_attention(q, cache["k"][i], cache["v"][i], cache["p"][i], pos,
                                       self_cut, new=(k, v))
            x = x + self._heads_out(o, sa["wo"])
            h = layer_norm(x, ca["ln_s"], ca["ln_b"])
            [q] = self._whole_heads([torch.einsum("bsd,dnh->bsnh", h, ca["wq"])], heads[:1])
            o = self._cached_attention(q, cache["ek"][i], cache["ev"][i], enc_pos, pos,
                                       cross_cut, causal=False)
            x = x + self._heads_out(o, ca["wo"])
            x = self._mlp(x, lp["mlp"])
        x = layer_norm(x, params["dec_norm_s"], params["dec_norm_b"])
        return self._unembed(params, x), cache
