"""The port's RecurrentGemma (Griffin) family against the reference's, on the CPU in f32.

recurrentgemma-2b at its smoke size (8 layers: 2 blocks of two RG-LRU
layers and one local-attention layer, then a 2-layer recurrent tail): the
reference's weights, fixed by a seed (``seeded_params``), cross over with
``convert.params_from_reference``; the same inputs, made with numpy, go
through ``repro.models.hybrid`` and ``repro_torch.models.hybrid``. The
log-depth scan of ``rg_lru`` is also held to ``rg_lru_step`` stepped token
by token.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.models import hybrid as jhyb
from repro_torch.configs import registry as treg
from repro_torch.ckpt.checkpoint import _flatten, _unflatten
from repro_torch.convert import params_from_reference
from repro_torch.models import hybrid as thyb
from test_torch_models import _close, _tokens, seeded_params

ARCH = "recurrentgemma-2b"
LOGIT_REL = 2e-5         # f32 across packages: max |err| over max |logit|


def _models(seed=0, n_layers=None):
    jm = jreg.build_model(ARCH, smoke=True)
    tm = treg.build_model(ARCH, smoke=True)
    if n_layers:
        jm = type(jm)(dataclasses.replace(jm.cfg, n_layers=n_layers), None)
        tm = type(tm)(dataclasses.replace(tm.cfg, n_layers=n_layers), None)
    ref = seeded_params(jm, seed)
    return jm, ref, tm, params_from_reference(ref, "cpu")


def _lru_inputs(seed, b=2, l=37, w=6):
    r = np.random.default_rng(seed)
    x, ga, gx = (r.standard_normal((b, l, w)).astype(np.float32) for _ in range(3))
    lam = r.standard_normal(w).astype(np.float32)
    h0 = r.standard_normal((b, w)).astype(np.float32)
    return x, ga, gx, lam, h0


# ---------------------------------------------------------------------------
# the recurrence
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("length", [1, 2, 37, 64])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rg_lru_matches_the_reference_and_the_stepped_recurrence(length, with_h0):
    """``rg_lru``'s log-depth scan against the reference's
    ``associative_scan`` and against ``rg_lru_step`` run token by token from
    the same state: every output and the last state within f32 rounding."""
    x, ga, gx, lam, h0 = _lru_inputs(length, l=length)
    t = [torch.from_numpy(v) for v in (x, ga, gx, lam, h0)]
    y, last = thyb.rg_lru(*t[:4], h0=t[4] if with_h0 else None)
    jy, jlast = jhyb.rg_lru(*(jnp.asarray(v) for v in (x, ga, gx, lam)),
                            h0=jnp.asarray(h0) if with_h0 else None)
    _close(y, jy, rtol=1e-5, atol=1e-6)
    _close(last, jlast, rtol=1e-5, atol=1e-6)
    h = t[4].clone() if with_h0 else torch.zeros_like(t[4])
    ys = []
    for i in range(length):
        h, yi = thyb.rg_lru_step(h, t[0][:, i], t[1][:, i], t[2][:, i], t[3])
        ys.append(yi)
    torch.testing.assert_close(y, torch.stack(ys, 1), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(last, h, rtol=1e-5, atol=1e-6)
    jh, jy0 = jhyb.rg_lru_step(jnp.asarray(h0 if with_h0 else np.zeros_like(h0)),
                               jnp.asarray(x[:, 0]), jnp.asarray(ga[:, 0]),
                               jnp.asarray(gx[:, 0]), jnp.asarray(lam))
    _close(ys[0], jy0)


def test_linear_scan_equals_the_sequential_recurrence():
    r = np.random.default_rng(3)
    a = torch.from_numpy(r.random((3, 100, 4)).astype(np.float64))
    b = torch.from_numpy(r.standard_normal((3, 100, 4)))
    h, want = torch.zeros((3, 4), dtype=torch.float64), []
    for i in range(100):
        h = a[:, i] * h + b[:, i]
        want.append(h)
    torch.testing.assert_close(thyb.linear_scan(a, b), torch.stack(want, 1), rtol=1e-12,
                               atol=1e-12)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_layers", [None, 3])
def test_param_tree_and_layout_equal_the_reference(n_layers):
    """The smoke config (2 blocks + a 2-layer tail) and the depth cut to one
    2:1 period (3 layers: 1 block, no tail): blocks, tail, kinds and every
    leaf's name, shape and dtype."""
    jm, ref, tm, _ = _models(0, n_layers)
    assert (tm.n_blocks, tm.n_tail, tm.kinds) == (jm.n_blocks, jm.n_tail, jm.kinds)
    assert (tm.n_blocks, tm.n_tail) == ((2, 2) if n_layers is None else (1, 0))
    port, want = _flatten(tm.init_params(0, "cpu")), _flatten(ref)
    assert sorted(port) == sorted(want)
    for key, leaf in want.items():
        assert port[key].shape == leaf.shape and port[key].dtype == leaf.dtype, key
    assert torch.equal(port["rec0/lam"], torch.ones_like(port["rec0/lam"]))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n_layers", [None, 3])
def test_logits_loss_and_gradients_match_the_reference(seed, n_layers):
    """Logits within 2e-5 of the largest logit (19 tokens: past the smoke's
    8-token local window), the loss within f32 rounding, and the gradients
    of ``embed``, an RG-LRU layer's ``lam``, ``wa`` and ``conv_w`` and the
    attention layer's ``wq`` within 1e-3 (relative) of the reference's."""
    jm, ref, tm, params = _models(seed, n_layers)
    tok = _tokens(jm, 2, 19, 1)
    want = np.asarray(jm.logits(ref, jnp.asarray(tok)))
    with torch.no_grad():
        got = tm.logits(params, torch.from_numpy(tok)).numpy()
    assert got.shape == want.shape == (2, 19, jm.cfg.vocab)
    assert np.abs(got - want).max() <= LOGIT_REL * np.abs(want).max()
    batch = _tokens(jm, 2, 20, 2)
    leaves = {k: v.detach().requires_grad_() for k, v in _flatten(params).items()}
    loss = tm.loss(_unflatten(leaves), {"tokens": torch.from_numpy(batch)})
    jloss, jgrads = jax.value_and_grad(jm.loss)(ref, {"tokens": jnp.asarray(batch)})
    _close(loss, jloss, rtol=1e-5, atol=1e-5)
    names = ["embed", "rec0/lam", "rec1/wa", "rec0/conv_w", "attn/wq"]
    grads = torch.autograd.grad(loss, [leaves[n] for n in names])
    jflat = _flatten(jax.tree.map(np.asarray, jgrads))
    for name, g in zip(names, grads):
        w = jflat[name].numpy()
        assert np.abs(g.numpy() - w).max() <= 1e-3 * np.abs(w).max() + 1e-7, name


def test_decode_matches_train_forward():
    """The twin of tests/test_models_smoke.py::test_decode_matches_train_forward
    for the hybrid, run past the 8-slot local window (the attention ring
    evicts), and each step's logits equal the reference's decode within
    2e-5 of the largest logit; the cache is updated in place."""
    jm, ref, tm, params = _models(0)
    B, S = 2, 14
    tok = _tokens(jm, B, S, 3)
    with torch.no_grad():
        full = tm.logits(params, torch.from_numpy(tok))
        cache, jcache = tm.init_cache(B, S, device="cpu"), jm.init_cache(B, S)
        assert {k: tuple(v.shape) for k, v in cache.items()} == \
            {k: v.shape for k, v in jcache.items()}
        errs, ref_errs = [], []
        for t in range(S):
            pos = torch.full((B,), t, dtype=torch.int32)
            lg, out = tm.decode_step(params, cache, torch.from_numpy(tok[:, t:t + 1]), pos)
            assert out is cache
            jlg, jcache = jm.decode_step(ref, jcache, jnp.asarray(tok[:, t:t + 1]),
                                         jnp.full((B,), t, jnp.int32))
            errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
            ref_errs.append(float(np.abs(lg.numpy() - np.asarray(jlg)).max()))
    assert max(errs) < 5e-3, max(errs)
    assert max(ref_errs) < LOGIT_REL * float(full.abs().max()), max(ref_errs)
    for key in ("h0", "h1", "ht"):
        _close(cache[key], jcache[key], rtol=1e-4, atol=1e-5)
    assert sorted(cache["ap"][0, 0].tolist()) == list(range(S - tm.cfg.window, S))


def test_remat_full_matches_none():
    tm = treg.build_model(ARCH, smoke=True)
    params = tm.init_params(5, "cpu")
    tok = torch.from_numpy(_tokens(tm, 2, 13, 5))
    out = []
    for remat in ("none", "full"):
        m = thyb.RecurrentGemmaLM(dataclasses.replace(tm.cfg, remat=remat))
        leaves = dict(params)
        leaves["embed"] = params["embed"].detach().requires_grad_()
        loss = m.loss(leaves, {"tokens": tok})
        out.append((loss.detach(), torch.autograd.grad(loss, leaves["embed"])[0]))
    assert torch.equal(out[0][0], out[1][0])
    torch.testing.assert_close(out[0][1], out[1][1], rtol=0, atol=1e-6)


def test_train_and_serve_run_the_depth_cut():
    """``launch.train --layers 3`` (one 2:1 period) learns on the smoke
    config and ``launch.serve --layers 3`` generates in-vocabulary tokens."""
    from repro_torch.launch import serve, train
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--layers", "3"]
    out = train.main(args + ["--seq-len", "32", "--global-batch", "4", "--log-every", "0",
                             "--lr", "3e-2", "--steps", "6"])
    assert np.all(np.isfinite(out["losses"])) and out["losses"][-1] < out["losses"][0]
    seqs = serve.main(args + ["--batch", "2", "--prompt-len", "5", "--gen", "12"])
    assert seqs.shape == (2, 17) and (seqs >= 0).all() and (seqs < 128).all()
