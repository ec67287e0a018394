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
Prefill and decode over a ``model`` axis wait for ROADMAP Queue 1 item 6c.
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

    def prefill_cross(self, params, cache, audio_embed):
        """Compute the encoder output and fill per-layer cross-attn K/V."""
        cm.refuse_model_axis(self.mesh, "prefill", "item 6c")
        enc = self.encode(params, audio_embed)
        ek = torch.einsum("btd,ldnh->lbtnh", enc, params["dec"]["cross"]["wk"])
        ev = torch.einsum("btd,ldnh->lbtnh", enc, params["dec"]["cross"]["wv"])
        return {**cache, "ek": ek, "ev": ev}

    def decode_step(self, params, cache, tokens, pos):
        """tokens: (B, 1) int, pos: (B,) current absolute position (the
        position embedding clamps at ``max_target - 1``).

        Returns (logits (B,1,V), cache) — the cache updated in place."""
        cfg = self.cfg
        cm.refuse_model_axis(self.mesh, "decode", "item 6c")
        B = tokens.shape[0]
        x = F.embedding(tokens.long(), params["embed"]).to(cfg.dtype)
        pos_emb = params["pos_dec"][torch.clamp(pos, max=self.max_target - 1).long()]
        x = x + pos_emb[:, None].to(cfg.dtype)
        q_pos = pos[:, None]
        enc_pos = self._positions(B, cache["ek"].shape[2], x.device)
        for i in range(cfg.n_layers):
            sa = {k: t[i] for k, t in params["dec"]["self"].items()}
            ck, cv, cp = cache["k"][i], cache["v"][i], cache["p"][i]
            h = layer_norm(x, sa["ln_s"], sa["ln_b"])
            q = torch.einsum("bsd,dnh->bsnh", h, sa["wq"])
            k = torch.einsum("bsd,dnh->bsnh", h, sa["wk"])
            v = torch.einsum("bsd,dnh->bsnh", h, sa["wv"])
            DenseLM._cache_write(ck, cv, cp, k, v, pos, pos % ck.shape[1])
            o = cm.attention(q, ck, cv, causal=True, q_positions=q_pos, kv_positions=cp)
            x = x + torch.einsum("bsnh,nhd->bsd", o, sa["wo"])
            x = self._cross(x, {k: t[i] for k, t in params["dec"]["cross"].items()},
                            cache["ek"][i], cache["ev"][i], enc_pos, q_pos)
            x = self._mlp(x, {k: t[i] for k, t in params["dec"]["mlp"].items()})
        x = layer_norm(x, params["dec_norm_s"], params["dec_norm_b"])
        logits = torch.einsum("bsd,vd->bsv", x, params["embed"].to(cfg.dtype))
        return logits, cache
