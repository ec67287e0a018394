"""The port's Mamba-2 (SSD) family against the reference's, on the CPU in f32.

mamba2-370m at its smoke size: the reference's weights, fixed by a seed
(``seeded_params``), cross over with ``convert.params_from_reference``; the
same inputs, made with numpy, go through ``repro.models.ssm`` and
``repro_torch.models.ssm``. The chunked dual form is also held to the
recurrence it computes, stepped token by token.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.models import ssm as jssm
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_reference
from repro_torch.models import ssm as tssm
from test_torch_models import _close, _tokens, seeded_params

ARCH = "mamba2-370m"
LOGIT_REL = 2e-5         # f32 across packages: max |err| over max |logit|


def _models(seed=0):
    jm = jreg.build_model(ARCH, smoke=True)
    ref = seeded_params(jm, seed)
    return jm, ref, treg.build_model(ARCH, smoke=True), params_from_reference(ref, "cpu")


def _ssd_inputs(seed, b=2, l=21, h=3, p=4, n=5):
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, l, h, p)).astype(np.float32)
    a = -np.abs(r.standard_normal((b, l, h))).astype(np.float32) * 0.5
    B = r.standard_normal((b, l, n)).astype(np.float32)
    C = r.standard_normal((b, l, n)).astype(np.float32)
    h0 = r.standard_normal((b, h, p, n)).astype(np.float32)
    return x, a, B, C, h0


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------
def test_segsum_and_causal_conv_match_the_reference():
    r = np.random.default_rng(0)
    a = r.standard_normal((2, 3, 7)).astype(np.float32)
    got, want = tssm._segsum(torch.from_numpy(a)).numpy(), np.asarray(jssm._segsum(jnp.asarray(a)))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[np.isfinite(got)], want[np.isfinite(want)], rtol=1e-5,
                               atol=1e-5)
    x = r.standard_normal((2, 9, 6)).astype(np.float32)
    w = r.standard_normal((6, 4)).astype(np.float32)
    cache = r.standard_normal((2, 3, 6)).astype(np.float32)
    for c in (None, cache):
        out, new = tssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                     None if c is None else torch.from_numpy(c))
        jout, jnew = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                       None if c is None else jnp.asarray(c))
        _close(out, jout)
        _close(new, jnew, rtol=0, atol=0)


@pytest.mark.parametrize("chunk", [4, 7, 21, 32])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_the_reference_and_the_stepped_recurrence(chunk, with_h0):
    """``ssd_chunked`` (padded tails when the chunk does not divide 21
    tokens, one chunk, a chunk longer than the sequence; with and without
    a carried state) against the reference's, and against ``ssd_step``
    run token by token from the same state: the outputs and the final
    state within f32 rounding."""
    x, a, B, C, h0 = _ssd_inputs(1)
    t = [torch.from_numpy(v) for v in (x, a, B, C, h0)]
    y, last = tssm.ssd_chunked(*t[:4], chunk, h0=t[4] if with_h0 else None)
    jy, jlast = jssm.ssd_chunked(*(jnp.asarray(v) for v in (x, a, B, C)), chunk,
                                 h0=jnp.asarray(h0) if with_h0 else None)
    _close(y, jy, rtol=1e-4, atol=1e-5)
    _close(last, jlast, rtol=1e-4, atol=1e-5)
    state = t[4].clone() if with_h0 else torch.zeros_like(t[4])
    ys = []
    for i in range(x.shape[1]):
        state, yi = tssm.ssd_step(state, t[0][:, i], t[1][:, i], t[2][:, i], t[3][:, i])
        ys.append(yi)
    torch.testing.assert_close(y, torch.stack(ys, 1), rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(last, state, rtol=1e-4, atol=1e-5)
    jstate, (jx, ja, jB, jC) = jnp.asarray(h0 if with_h0 else np.zeros_like(h0)), \
        (jnp.asarray(v) for v in (x, a, B, C))
    jstate, jy0 = jssm.ssd_step(jstate, jx[:, 0], ja[:, 0], jB[:, 0], jC[:, 0])
    _close(ys[0], jy0)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
def test_param_tree_equals_the_reference():
    jm, ref, tm, params = _models()
    port = tm.init_params(0, "cpu")
    assert sorted(port) == sorted(ref) and sorted(port["blocks"]) == sorted(ref["blocks"])
    for key, leaf in ref["blocks"].items():
        assert tuple(port["blocks"][key].shape) == leaf.shape, key
        assert port["blocks"][key].dtype == torch.float32 and leaf.dtype == np.float32
    _close(port["blocks"]["A_log"], ref["blocks"]["A_log"], rtol=1e-6, atol=1e-7)
    assert torch.equal(port["blocks"]["D"], torch.ones_like(port["blocks"]["D"]))
    for key in ("embed", "final_norm"):
        assert tuple(port[key].shape) == ref[key].shape


@pytest.mark.parametrize("seed", [0, 1])
def test_logits_loss_and_gradients_match_the_reference(seed):
    """Logits within 2e-5 of the largest logit over 3 layers and 21 tokens
    (chunk 8: two whole chunks and a padded tail), the loss within f32
    rounding, and the gradients of ``embed``, ``w_in``, ``A_log`` and
    ``conv_w`` within 1e-3 (relative) of the reference's."""
    jm, ref, tm, params = _models(seed)
    tok = _tokens(jm, 2, 21, 1)
    want = np.asarray(jm.logits(ref, jnp.asarray(tok)))
    with torch.no_grad():
        got = tm.logits(params, torch.from_numpy(tok)).numpy()
    assert got.shape == want.shape == (2, 21, jm.cfg.vocab)
    assert np.abs(got - want).max() <= LOGIT_REL * np.abs(want).max()
    batch = _tokens(jm, 2, 22, 2)
    leaves = {"embed": params["embed"].detach().requires_grad_(),
              "final_norm": params["final_norm"],
              "blocks": {k: v.detach().requires_grad_() for k, v in params["blocks"].items()}}
    loss = tm.loss(leaves, {"tokens": torch.from_numpy(batch)})
    jloss, jgrads = jax.value_and_grad(jm.loss)(ref, {"tokens": jnp.asarray(batch)})
    _close(loss, jloss, rtol=1e-5, atol=1e-5)
    names = ("w_in", "A_log", "conv_w")
    grads = torch.autograd.grad(loss, [leaves["embed"]] + [leaves["blocks"][n] for n in names])
    for g, w in zip(grads, [jgrads["embed"]] + [jgrads["blocks"][n] for n in names]):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-3 * np.abs(w).max() + 1e-7


def test_decode_matches_train_forward():
    """The twin of tests/test_models_smoke.py::test_decode_matches_train_forward
    for mamba2, and each step's logits equal the reference's decode within
    2e-5 of the largest logit; the cache is updated in place."""
    jm, ref, tm, params = _models(0)
    B, S = 2, 12
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
    _close(cache["ssm"], jcache["ssm"], rtol=1e-4, atol=1e-5)


def test_remat_full_matches_none():
    import dataclasses
    tm = treg.build_model(ARCH, smoke=True)
    params = tm.init_params(5, "cpu")
    tok = torch.from_numpy(_tokens(tm, 2, 13, 5))
    out = []
    for remat in ("none", "full"):
        m = tssm.Mamba2LM(dataclasses.replace(tm.cfg, remat=remat))
        leaves = dict(params)
        leaves["embed"] = params["embed"].detach().requires_grad_()
        loss = m.loss(leaves, {"tokens": tok})
        out.append((loss.detach(), torch.autograd.grad(loss, leaves["embed"])[0]))
    assert torch.equal(out[0][0], out[1][0])
    torch.testing.assert_close(out[0][1], out[1][1], rtol=0, atol=1e-6)


def test_train_and_serve_run_the_smoke_config():
    """``launch.train`` learns on mamba2's smoke config and resumes from its
    own checkpoint; ``launch.serve`` generates in-vocabulary tokens."""
    import tempfile

    from repro_torch.launch import serve, train
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--seq-len", "32",
            "--global-batch", "4", "--log-every", "0", "--lr", "3e-2"]
    with tempfile.TemporaryDirectory() as root:
        out1 = train.main(args + ["--steps", "6", "--ckpt-dir", root, "--ckpt-every", "6"])
        assert np.all(np.isfinite(out1["losses"])) and out1["losses"][-1] < out1["losses"][0]
        out2 = train.main(args + ["--steps", "8", "--ckpt-dir", root])
        assert len(out2["losses"]) == 2
    seqs = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "5", "--gen", "6"])
    assert seqs.shape == (2, 11) and (seqs >= 0).all() and (seqs < 128).all()
