"""Mamba-2 (state-space duality / SSD) language model.

Twin of ``repro.models.ssm``. SSD is a chunking algorithm: the sequence is
cut into chunks; the work inside a chunk becomes dense matmuls, and the
work across chunks a tiny state recurrence over the chunk count (a loop of
``l / chunk`` steps, 8 at seq 2048, where the reference runs a
``lax.scan``). Faithful to the minimal-SSD reference: inputs folded as
(x*dt, A*dt, B, C); depthwise causal conv over (x, B, C); gated RMSNorm
before the out-projection; D skip connection. Decode carries (conv window,
SSM state) per layer and updates the cache in place.

Over a ``model`` axis (tensor parallelism) ``param_specs`` is the
reference's, which cuts only ``norm_scale`` and ``w_out`` (by ``d_inner``)
and ``embed`` (by vocab). The block runs head-parallel: each rank takes,
from the whole ``w_in``, the z, x and dt columns of its heads and the whole
B and C, runs the conv on its channels and the SSD on its heads, sums the
gated norm's squares over ``model`` and ends in a row-parallel ``w_out``.
Each whole leaf then feeds this rank's heads only, so its gradient is
summed over ``model`` (``ShardingMixin._copy_in``). Decode over a
``model`` axis runs the same block on this rank's blocks of the cache,
laid out by the reference's ``cache_specs`` (``decode_step``).
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.distributed.mesh import DATA, MODEL, P
from repro_torch.models import common as cm
from repro_torch.models.common import ModelConfig


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """log-decay matrix: out[..., i, j] = sum_{k=j+1..i} a[..., k], -inf for j>i."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]          # (..., i, j) = cs_i - cs_j
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, -math.inf)


def ssd_chunked(x, a, B, C, chunk: int, h0=None):
    """SSD dual form. x:(b,l,h,p)  a:(b,l,h) log-decay  B,C:(b,l,n).

    Returns (y (b,l,h,p) f32, final_state (b,h,p,n)). Single B/C group
    (mamba2 ngroups=1) broadcast over heads.
    """
    b, l, h, p = x.shape
    n = B.shape[-1]
    pad = (-l) % chunk
    if pad:  # causal: zero-pad the tail, outputs for real positions unchanged
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
        out, last = ssd_chunked(x, a, B, C, chunk, h0)
        return out[:, :l], last
    c = l // chunk
    xq = x.reshape(b, c, chunk, h, p)
    aq = a.reshape(b, c, chunk, h).float()
    Bq = B.reshape(b, c, chunk, n)
    Cq = C.reshape(b, c, chunk, n)

    acs = torch.cumsum(aq, dim=2)                        # (b,c,q,h) f32 decays
    # 1) intra-chunk (dense): Y_diag[q] = sum_{s<=q} C_q.B_s L[q,s] x_s
    L = torch.exp(_segsum(aq.permute(0, 1, 3, 2)))      # (b,c,h,q,s)
    G = torch.einsum("bcqn,bcsn->bcqs", Cq, Bq)          # (b,c,q,s)
    M = G[:, :, None] * L.to(G.dtype)                    # (b,c,h,q,s)
    y_diag = torch.einsum("bchqs,bcshp->bcqhp", M, xq).float()

    # 2) per-chunk end states
    decay_tail = torch.exp(acs[:, :, -1:, :] - acs)      # (b,c,q,h)
    states = torch.einsum("bcqn,bcqhp->bchpn", Bq.float(),
                          decay_tail[..., None] * xq.float())

    # 3) inter-chunk recurrence (a loop over the chunks' states)
    chunk_decay = torch.exp(acs[:, :, -1, :])            # (b,c,h)
    carry = torch.zeros((b, h, p, n), dtype=states.dtype, device=x.device) \
        if h0 is None else h0
    state_in = []
    for j in range(c):
        state_in.append(carry)                           # the state BEFORE chunk j
        carry = states[:, j] + chunk_decay[:, j, :, None, None] * carry
    state_in = torch.stack(state_in, dim=1)              # (b,c,h,p,n)

    # 4) inter-chunk contribution
    y_off = torch.einsum("bcqn,bchpn->bcqhp", Cq.float(), state_in) \
        * torch.exp(acs)[..., None]
    y = (y_diag + y_off).reshape(b, l, h, p)
    return y, carry


def ssd_step(state, x_t, a_t, B_t, C_t):
    """One decode step. state:(b,h,p,n) x_t:(b,h,p) a_t:(b,h) B_t,C_t:(b,n)."""
    decay = torch.exp(a_t)[..., None, None]
    state = decay * state + torch.einsum("bhp,bn->bhpn", x_t, B_t)
    y = torch.einsum("bhpn,bn->bhp", state, C_t)
    return state, y


def _causal_conv(x, w, cache=None):
    """Depthwise causal conv. x:(b,l,d) w:(d,k). cache:(b,k-1,d) prev inputs."""
    k = w.shape[1]
    if cache is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = cache
    xp = torch.cat([pad, x], dim=1)                      # (b, l+k-1, d)
    out = sum(xp[:, i : i + x.shape[1]] * w[:, i] for i in range(k))
    new_cache = xp[:, -(k - 1):, :] if k > 1 else pad
    return out, new_cache


class Mamba2LM(cm.ShardingMixin, torch.nn.Module):
    def __init__(self, cfg: ModelConfig, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        self.d_inner = cfg.d_model * cfg.ssm_expand
        self.nheads = self.d_inner // cfg.ssm_head_dim
        self.n_state = cfg.ssm_state

    # -- params ---------------------------------------------------------------
    def init_params(self, seed: int = 0, device="cuda") -> Any:
        cfg = self.cfg
        ini = cm.Initializer(seed, cfg.dtype, device)
        L, D, di, nh, ns = cfg.n_layers, cfg.d_model, self.d_inner, self.nheads, self.n_state
        conv_d = di + 2 * ns
        a_log = torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32, device=device))
        blocks = {
            "ln": ini.zeros((L, D)),
            "w_in": ini("w_in", (L, D, 2 * di + 2 * ns + nh)),
            "conv_w": ini("conv_w", (L, conv_d, cfg.ssm_conv), scale=0.5),
            "A_log": ini.zeros((L, nh)) + a_log.to(cfg.dtype)[None],
            "D": ini.ones((L, nh)),
            "dt_bias": ini.zeros((L, nh)),
            "norm_scale": ini.zeros((L, di)),
            "w_out": ini("w_out", (L, di, D), scale=1.0 / math.sqrt(di)),
        }
        return {
            "embed": ini("embed", (cfg.vocab, D), scale=1.0),
            "final_norm": ini.zeros((D,)),
            "blocks": blocks,
        }

    def param_specs(self, mesh) -> Any:
        """The reference's train-time PartitionSpecs, entry for entry: only
        ``norm_scale`` and ``w_out`` are cut over ``model`` (by
        ``d_inner``), and ``embed`` by vocab."""
        cfg = self.cfg
        d_dat = cm.shardable(cfg.d_model, DATA, mesh)
        di_m = cm.shardable(self.d_inner, MODEL, mesh)
        return {
            "embed": P(cm.shardable(cfg.vocab, MODEL, mesh), d_dat),
            "final_norm": P(None),
            "blocks": {
                "ln": P(None, None),
                "w_in": P(None, d_dat, None),
                "conv_w": P(None, None, None),
                "A_log": P(None, None),
                "D": P(None, None),
                "dt_bias": P(None, None),
                "norm_scale": P(None, di_m),
                "w_out": P(None, di_m, d_dat),
            },
        }

    # -- the model axis ----------------------------------------------------------
    def _ranges(self):
        """((first, count) of the heads that this rank's SSD runs, (first,
        count) of the ``d_inner`` channels that its gated norm and
        ``w_out`` take): this rank's blocks where ``model`` splits them,
        else all. Where ``d_inner`` splits and the heads do not, every rank
        runs every head and keeps its channels at the norm."""
        tp, r = self._tp(), self._mrank()
        nh, di = self.nheads, self.d_inner
        heads = (r * (nh // tp), nh // tp) if self._split(nh) else (0, nh)
        inner = (r * (di // tp), di // tp) if self._split(di) else (0, di)
        return heads, inner

    def _local(self, lp):
        """This rank's columns of ``w_in`` (z, x and dt of its heads; B and
        C whole), rows of ``conv_w`` (x of its heads; B and C) and entries
        of the per-head leaves. Over a split ``d_inner`` each whole leaf
        feeds this rank's channels only, so its gradient is summed over
        ``model``."""
        (h0, nh), _ = self._ranges()
        part = self._split(self.d_inner)
        lp = {k: self._copy_in(t, part) if k in ("w_in", "conv_w", "A_log", "D", "dt_bias")
              else t for k, t in lp.items()}
        if nh == self.nheads:
            return lp
        hd, di, ns = self.cfg.ssm_head_dim, self.d_inner, self.n_state
        x0, n = h0 * hd, nh * hd
        w, c = lp["w_in"], lp["conv_w"]
        return {**lp,
                "w_in": torch.cat([w[:, x0:x0 + n], w[:, di + x0:di + x0 + n],
                                   w[:, 2 * di:2 * di + 2 * ns],
                                   w[:, 2 * di + 2 * ns + h0:2 * di + 2 * ns + h0 + nh]], dim=-1),
                "conv_w": torch.cat([c[x0:x0 + n], c[di:di + 2 * ns]], dim=0),
                "A_log": lp["A_log"][h0:h0 + nh], "D": lp["D"][h0:h0 + nh],
                "dt_bias": lp["dt_bias"][h0:h0 + nh]}

    # -- shared projections ----------------------------------------------------
    def _split_proj(self, h, lp):
        """z, x, B, C and dt of this rank's heads (``_local``'s leaves)."""
        (_, nh), _ = self._ranges()
        n, ns = nh * self.cfg.ssm_head_dim, self.n_state
        zxbcdt = torch.einsum("bld,de->ble", h, lp["w_in"])
        z, xin, Bc, Cc, dt = torch.split(zxbcdt, [n, n, ns, ns, nh], dim=-1)
        dt = F.softplus(dt.float() + lp["dt_bias"].float())
        return z, xin, Bc, Cc, dt

    def _gated_norm(self, y, scale):
        """``rms_norm`` over the whole ``d_inner`` of this rank's channels
        ``y``: over a split, the sum of squares is summed over ``model``."""
        if not self._split(self.d_inner):
            return cm.rms_norm(y, scale)
        dt = y.dtype
        y = y.float()
        ss = self._sum_stat(torch.sum(torch.square(y), dim=-1, keepdim=True))
        y = y * torch.rsqrt(ss / self.d_inner + 1e-6)
        return (y * (1.0 + scale.float())).to(dt)

    def _finish(self, y, z, x_res, dt, lp):
        """Gated norm + D-skip + out projection. y:(b,l,h,p), this rank's
        heads; ``w_out`` row-parallel over a split ``d_inner``."""
        cfg = self.cfg
        (h0, nh), (i0, ni) = self._ranges()
        hd = cfg.ssm_head_dim
        b, l = y.shape[0], y.shape[1]
        xh = x_res.reshape(b, l, nh, hd)
        y = y + lp["D"].float()[None, None, :, None] * xh.float()
        y = y.reshape(b, l, nh * hd).to(cfg.dtype)
        if ni != nh * hd:                        # every head ran: keep this rank's channels
            y, z = y.narrow(-1, i0 - h0 * hd, ni), z.narrow(-1, i0 - h0 * hd, ni)
        y = self._gated_norm(y * F.silu(z), lp["norm_scale"])
        out = torch.einsum("ble,ed->bld", y, lp["w_out"])
        return self._reduce_out(out, self._split(self.d_inner))

    def _conv_split(self, xin, Bc, Cc, lp, cache=None):
        conv_in = torch.cat([xin, Bc, Cc], dim=-1)
        conv_out, new_conv = _causal_conv(conv_in, lp["conv_w"], cache=cache)
        conv_out = F.silu(conv_out)
        xc, Bc, Cc = torch.split(conv_out, [xin.shape[-1], self.n_state, self.n_state], dim=-1)
        return xc, Bc, Cc, new_conv

    def _embed(self, params, tokens):
        return self._lookup(params["embed"], tokens).to(self.cfg.dtype)

    # -- train forward -----------------------------------------------------------
    def hidden(self, params, tokens):
        """Over a ``model`` axis the block runs head-parallel: each rank
        its heads' z, x, dt and the whole B, C from the whole ``w_in``, the
        conv on its channels, the SSD on its heads, the gated norm over
        the whole ``d_inner`` and a row-parallel ``w_out``. Over a ``data``
        axis ``w_in`` and ``w_out`` are gathered first (ZeRO-3), before the
        head-parallel column selection."""
        cfg = self.cfg
        B, S = tokens.shape
        params = self._zero_top(params)
        x = self._embed(params, tokens)
        hd = cfg.ssm_head_dim
        keys = list(params["blocks"])
        part = self._split(self.d_inner)
        specs = self.param_specs(self.mesh)["blocks"] if self._dp() > 1 else None
        lspecs = None if specs is None else [specs[k] for k in keys]

        def body(x, *leaves):
            lp = self._local(dict(zip(keys, self._zero_layer(leaves, lspecs))))
            h = self._copy_in(cm.rms_norm(x, lp["ln"]), part)
            z, xin, Bc, Cc, dt = self._split_proj(h, lp)
            xc, Bc, Cc, _ = self._conv_split(xin, Bc, Cc, lp)
            A = -torch.exp(lp["A_log"].float())                       # (nh,)
            a = dt * A[None, None, :]                                  # (b,l,nh)
            ssd_dt = torch.bfloat16 if cfg.ssm_bf16 else torch.float32
            xh = xc.reshape(B, -1, dt.shape[-1], hd).float()
            xdt = (xh * dt[..., None]).to(ssd_dt)
            y, _ = ssd_chunked(xdt, a, Bc.to(ssd_dt), Cc.to(ssd_dt),
                               chunk=min(cfg.ssm_chunk, xh.shape[1]))
            return x + self._finish(y, z, xc, dt, lp)

        step = cm.maybe_remat(body, cfg)
        for leaves in cm.layer_slices([params["blocks"][key] for key in keys]):
            x = step(x, *leaves)
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
        return self._xent(params, h, tokens[:, 1:])

    # -- decode ---------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device="cuda") -> Any:
        cfg = self.cfg
        conv_d = self.d_inner + 2 * self.n_state
        return {
            "ssm": torch.zeros((cfg.n_layers, batch, self.nheads, cfg.ssm_head_dim,
                                self.n_state), dtype=torch.float32, device=device),
            "conv": torch.zeros((cfg.n_layers, batch, cfg.ssm_conv - 1, conv_d),
                                dtype=cfg.dtype, device=device),
        }

    def cache_specs(self, mesh, batch: int, max_len: int) -> Any:
        """The reference's: the batch over pod x data where their product
        divides it; over ``model`` the SSM state by heads and the conv
        window by its channels, (x, B, C) concatenated, in contiguous
        blocks."""
        b = cm.cache_batch_spec(mesh, batch)
        nh_m = cm.shardable(self.nheads, MODEL, mesh)
        di_m = cm.shardable(self.d_inner + 2 * self.n_state, MODEL, mesh)
        return {"ssm": P(None, b, nh_m, None, None), "conv": P(None, b, None, di_m)}

    def decode_step(self, params, cache, tokens, pos, cache_specs=None):
        """tokens: (B, 1) int, pos: (B,). Returns (logits (B,1,V), cache) —
        the cache updated in place.

        Over a mesh, ``params`` are this rank's blocks under the train
        specs (ZeRO blocks gathered a layer at a time) and ``cache`` its
        blocks under ``cache_specs``, whose cut each block's shape tells
        (so ``cache_specs`` is not read). The block runs head-parallel as in
        training, on this rank's block of the SSM state. The conv window's
        block is not the compute's channels (those of its heads' x, and the
        whole B and C), so every layer's window is gathered whole over
        ``model`` in one all-gather before the first layer; each rank
        convolves its channels of it and writes back its own block, the
        window shifted by the new token's ``conv_in`` of those channels
        (from the whole ``w_in``)."""
        cfg = self.cfg
        B = tokens.shape[0]
        (h0, nh), _ = self._ranges()
        hd, di, ns = cfg.ssm_head_dim, self.d_inner, self.n_state
        keys = list(params["blocks"])
        zero = self._dp() > 1 and params["blocks"]["w_in"].shape[1] != cfg.d_model
        lspecs = None
        if zero:
            params = self._zero_top(params)
            specs = self.param_specs(self.mesh)["blocks"]
            lspecs = [specs[k] for k in keys]
        x = self._embed(params, tokens)                                # (B,1,D)
        c = cache["conv"].shape[-1]                                    # this rank's channels
        cut = c != di + 2 * ns
        c0 = self._mrank() * c if cut else 0
        windows = self._gather_model([cache["conv"]], -1)[0] if cut else cache["conv"]
        own = nh == self.nheads and not cut                            # every channel, whole
        x0, n = h0 * hd, nh * hd
        for i, leaves in enumerate(cm.layer_slices([params["blocks"][k] for k in keys])):
            whole = dict(zip(keys, self._zero_layer(leaves, lspecs) if zero else leaves))
            lp = self._local(whole)
            h = cm.rms_norm(x, lp["ln"])
            z, xin, Bc, Cc, dt = self._split_proj(h, lp)
            w = windows[i] if nh == self.nheads else torch.cat(
                [windows[i][..., x0:x0 + n], windows[i][..., di:]], dim=-1)
            xc, Bc, Cc, new_conv = self._conv_split(xin, Bc, Cc, lp, cache=w)
            A = -torch.exp(lp["A_log"].float())
            a = (dt * A[None, None, :])[:, 0]                          # (B,nh)
            xdt = xc.reshape(B, nh, hd).float() * dt[:, 0, :, None]
            new_ssm, y = ssd_step(cache["ssm"][i], xdt, a, Bc[:, 0].float(), Cc[:, 0].float())
            cache["ssm"][i] = new_ssm
            if own:
                cache["conv"][i] = new_conv
            else:       # conv channel j is w_in's column d_inner + j
                new_in = torch.einsum("bld,de->ble", h, whole["w_in"][:, di + c0:di + c0 + c])
                cache["conv"][i] = torch.cat([cache["conv"][i][:, 1:], new_in], dim=1)
            x = x + self._finish(y[:, None], z, xc, dt, lp)
        x = cm.rms_norm(x, params["final_norm"])
        return self._unembed(params, x), cache
