"""The port's Whisper encoder-decoder against the reference's, on the CPU in f32.

whisper-large-v3 at its smoke size (2 encoder and 2 decoder layers, d 64,
24 encoder frames): the reference's weights, fixed by a seed
(``seeded_params``), cross over with ``convert.params_from_reference``; the
same inputs, made with numpy, go through ``repro.models.encdec`` and
``repro_torch.models.encdec``. Tolerances are stated per test: both run f32
and differ by summation order. The init's attention logits reach ~50 and
its tied logits ~30, so an error that scales with them is bounded against
the largest logit. Each stage is held to 2e-5 on the same inputs; the
chained forward (the port's encoder output into the port's decoder) is
held to 1e-4, because the decoder's cross-attention, its logits near 50,
amplifies the encoder's f32 rounding (measured 4-5e-6) about eightfold
(up to 3.9e-5 over these seeds).
"""
import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.launch import steps as jsteps
from repro.models import encdec as jenc
from repro_torch.ckpt.checkpoint import _flatten, _unflatten
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_reference
from repro_torch.launch import steps as tsteps
from repro_torch.models import encdec as tenc
from test_torch_models import _close, _tokens, seeded_params

ARCH = "whisper-large-v3"
LOGIT_REL = 2e-5         # f32 across packages: max |err| over max |logit|
CHAIN_REL = 1e-4         # encode then dec_logits, each package on its own encoder output
GRAD_REL = 1e-3          # f32 gradients: max |err| over max |grad| of the leaf
LOSS_RTOL = 1e-4         # f32 losses after up to 4 resumed steps of both packages
ARGS = ["--arch", ARCH, "--smoke", "--seq-len", "16", "--global-batch", "4",
        "--log-every", "0", "--lr", "3e-2"]


def _models(seed=0, max_target=None):
    """Both packages' smoke models (``max_target`` rows of decoder positions
    where given: the registry never builds fewer than 448) and the seeded
    reference weights in both."""
    jm = jreg.build_model(ARCH, smoke=True)
    tm = treg.build_model(ARCH, smoke=True)
    if max_target:
        jm = type(jm)(jm.cfg, None, max_target=max_target)
        tm = type(tm)(tm.cfg, None, max_target=max_target)
    ref = seeded_params(jm, seed)
    return jm, ref, tm, params_from_reference(ref, "cpu")


def _audio(m, B, seed, T=None):
    T = T or m.cfg.enc_positions
    return np.random.default_rng(seed).standard_normal((B, T, m.cfg.d_model)).astype(np.float32)


def _rel_err(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------
def test_layer_norm_and_sinusoids_equal_the_reference():
    r = np.random.default_rng(0)
    x = (r.standard_normal((2, 7, 64)) * 3 + 1).astype(np.float32)
    s, b = (r.standard_normal(64).astype(np.float32) for _ in range(2))
    _close(tenc.layer_norm(*(torch.from_numpy(a) for a in (x, s, b))),
           jenc.layer_norm(*(jnp.asarray(a) for a in (x, s, b))), rtol=1e-5, atol=1e-5)
    for length, channels in ((24, 64), (1500, 1280)):
        # sin/cos of angles up to 1500: an ulp of the angle is ~1e-4
        _close(tenc.sinusoids(length, channels), jenc.sinusoids(length, channels),
               rtol=0, atol=1e-6 * length)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("max_target", [448, 40])
def test_param_tree_equals_the_reference(max_target):
    """Every leaf's name, shape and dtype, ``pos_dec`` with ``max_target``
    rows, and the ones and zeros of the norms and biases."""
    jm, ref, tm, _ = _models(0, max_target=max_target)
    port, want = _flatten(tm.init_params(0, "cpu")), _flatten(ref)
    assert sorted(port) == sorted(want)
    for key, leaf in want.items():
        assert port[key].shape == leaf.shape and port[key].dtype == leaf.dtype, key
    assert port["pos_dec"].shape == (max_target, tm.cfg.d_model)
    for key in ("enc/self/ln_s", "dec/cross/ln_s", "dec/mlp/ln_s", "enc_norm_s"):
        assert torch.equal(port[key], torch.ones_like(port[key])), key
    for key in ("enc/mlp/b1", "dec/mlp/b2", "dec/self/ln_b", "dec_norm_b"):
        assert torch.equal(port[key], torch.zeros_like(port[key])), key


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_logits_match_the_reference(seed):
    """``encode`` within 2e-5 of the reference's (over its largest output),
    ``dec_logits`` on the reference's encoder output within 2e-5 of the
    largest logit, and the chain of the two within ``CHAIN_REL``."""
    jm, ref, tm, params = _models(seed)
    tok, audio = _tokens(jm, 2, 12, seed + 10), _audio(jm, 2, seed + 20)
    jenc_out = jm.encode(ref, jnp.asarray(audio))
    want = jm.dec_logits(ref, jnp.asarray(tok), jenc_out)
    with torch.no_grad():
        enc = tm.encode(params, torch.from_numpy(audio))
        got = tm.dec_logits(params, torch.from_numpy(tok), torch.from_numpy(np.array(jenc_out)))
        chained = tm.dec_logits(params, torch.from_numpy(tok), enc)
    assert got.shape == (2, 12, jm.cfg.vocab)
    assert _rel_err(enc, jenc_out) <= LOGIT_REL, seed
    assert _rel_err(got, want) <= LOGIT_REL, seed
    assert _rel_err(chained, want) <= CHAIN_REL, seed


def test_encoder_past_the_dense_limit_takes_the_blocked_attention(monkeypatch):
    """1100 frames (over ``ATTN_DENSE_MAX``): the encoder's attention runs
    the online softmax over KV blocks, padded to 1536 with position -1, in
    both packages; the outputs agree within 2e-5 of the largest. Both add
    the reference's sinusoid table: at angles up to 1100 the two packages'
    tables differ by up to 1e-4 (an ulp of the angle), which is an input
    difference, bounded in test_layer_norm_and_sinusoids_equal_the_reference."""
    from repro_torch.models import common as tcm
    jm, ref, tm, params = _models(0)
    audio = _audio(jm, 1, 5, T=1100)
    assert 1100 > tcm.ATTN_DENSE_MAX and 1100 % tcm.ATTN_BLOCK_KV
    monkeypatch.setattr(tenc, "sinusoids", lambda length, channels, device=None:
                        torch.from_numpy(np.array(jenc.sinusoids(length, channels))))
    with torch.no_grad():
        got = tm.encode(params, torch.from_numpy(audio))
    assert _rel_err(got, jm.encode(ref, jnp.asarray(audio))) <= LOGIT_REL


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_gradients_match_the_reference(seed):
    """The teacher-forced loss within f32 rounding (rtol 1e-5) and the
    gradients of the tied embedding, the decoder positions and one leaf of
    each sub-layer within 1e-3 of the leaf's largest gradient."""
    jm, ref, tm, params = _models(seed)
    batch = {"tokens": _tokens(jm, 2, 13, seed + 30), "audio_embed": _audio(jm, 2, seed + 40)}
    leaves = {k: v.detach().requires_grad_() for k, v in _flatten(params).items()}
    loss = tm.loss(_unflatten(leaves), {k: torch.from_numpy(v) for k, v in batch.items()})
    jloss, jgrads = jax.value_and_grad(jm.loss)(ref, {k: jnp.asarray(v) for k, v in batch.items()})
    _close(loss, jloss, rtol=1e-5, atol=1e-5)
    names = ["embed", "pos_dec", "enc/self/wq", "enc/mlp/w1", "enc/mlp/b1", "dec/self/wk",
             "dec/cross/wv", "dec/cross/ln_s", "dec/mlp/w2", "enc_norm_b"]
    grads = torch.autograd.grad(loss, [leaves[n] for n in names])
    jflat = _flatten(jax.tree.map(np.asarray, jgrads))
    for name, g in zip(names, grads):
        w = jflat[name].numpy()
        assert np.abs(g.numpy() - w).max() <= GRAD_REL * np.abs(w).max() + 1e-7, name


def test_prefill_cross_and_decode_match_the_reference():
    """``prefill_cross`` fills ``ek`` and ``ev`` as the reference does
    (2e-5 of the largest); then, from the reference's ``ek`` and ``ev``,
    each decode step's logits equal the reference's (2e-5 of the largest
    logit), the cache is updated in place, and its ``k``, ``v`` and ``p``
    equal the reference's. Each step also equals the port's teacher-forced
    ``dec_logits`` (the reference's
    test_whisper_decode_matches_teacher_forcing bound, 5e-3)."""
    jm, ref, tm, params = _models(0)
    B, S = 2, 10
    tok, audio = _tokens(jm, B, S, 1), _audio(jm, B, 2)
    with torch.no_grad():
        full = tm.dec_logits(params, torch.from_numpy(tok),
                             tm.encode(params, torch.from_numpy(audio)))
        cache, jcache = tm.init_cache(B, S, device="cpu"), jm.init_cache(B, S)
        assert {k: tuple(v.shape) for k, v in cache.items()} == \
            {k: v.shape for k, v in jcache.items()}
        assert {k: str(v.dtype).replace("torch.", "") for k, v in cache.items()} == \
            {k: v.dtype.name for k, v in jcache.items()}
        assert (cache["p"] == -1).all()
        cache = tm.prefill_cross(params, cache, torch.from_numpy(audio))
        jcache = jm.prefill_cross(ref, jcache, jnp.asarray(audio))
        for key in ("ek", "ev"):
            assert _rel_err(cache[key], jcache[key]) <= LOGIT_REL, key
        steps = {k: v.clone() for k, v in cache.items()}
        steps.update({k: torch.from_numpy(np.array(jcache[k])) for k in ("ek", "ev")})
        errs, ref_errs = [], []
        for t in range(S):
            pos = torch.full((B,), t, dtype=torch.int32)
            lg, out = tm.decode_step(params, cache, torch.from_numpy(tok[:, t:t + 1]), pos)
            assert out is cache
            errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
            lg, _ = tm.decode_step(params, steps, torch.from_numpy(tok[:, t:t + 1]), pos)
            jlg, jcache = jm.decode_step(ref, jcache, jnp.asarray(tok[:, t:t + 1]),
                                         jnp.full((B,), t, jnp.int32))
            ref_errs.append(_rel_err(lg, jlg))
    assert max(errs) < 5e-3, max(errs)
    assert max(ref_errs) <= LOGIT_REL, max(ref_errs)
    for key in ("k", "v"):
        assert _rel_err(steps[key], jcache[key]) <= LOGIT_REL, key
    assert np.array_equal(steps["p"].numpy(), np.asarray(jcache["p"]))


def test_decode_past_max_target_clamps_the_position_embedding():
    """A model with 6 decoder positions decodes 9 tokens: from position 5 on
    both packages add ``pos_dec[5]`` (an unclamped index past the table
    would raise in torch), and every step's logits agree (from the
    reference's cross-attention cache, as above)."""
    jm, ref, tm, params = _models(0, max_target=6)
    assert tm.max_target == jm.max_target == 6
    B, S = 2, 9
    tok, audio = _tokens(jm, B, S, 3), _audio(jm, B, 4)
    with torch.no_grad():
        cache = tm.prefill_cross(params, tm.init_cache(B, S, device="cpu"),
                                 torch.from_numpy(audio))
        jcache = jm.prefill_cross(ref, jm.init_cache(B, S), jnp.asarray(audio))
        cache.update({k: torch.from_numpy(np.array(jcache[k])) for k in ("ek", "ev")})
        for t in range(S):
            lg, cache = tm.decode_step(params, cache, torch.from_numpy(tok[:, t:t + 1]),
                                       torch.full((B,), t, dtype=torch.int32))
            jlg, jcache = jm.decode_step(ref, jcache, jnp.asarray(tok[:, t:t + 1]),
                                         jnp.full((B,), t, jnp.int32))
            assert _rel_err(lg, jlg) <= LOGIT_REL, t


def test_prefill_step_equals_the_reference_body():
    """``build_prefill_step``'s encdec branch: the encoder, the decoder and
    the last position against ``embed``, as the reference's step body
    computes it."""
    from repro.launch.train import parse_mesh
    jm, ref, tm, params = _models(1)
    batch = {"tokens": _tokens(jm, 2, 9, 5), "audio_embed": _audio(jm, 2, 6)}
    cell = jreg.ShapeCell("custom", 9, 2, "prefill")
    want = jsteps.build_prefill_step(jm, parse_mesh("1x1"), cell=cell).fn(
        ref, {k: jnp.asarray(v) for k, v in batch.items()})
    got = tsteps.build_prefill_step(tm).fn(params,
                                           {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == (2, 1, jm.cfg.vocab)
    assert _rel_err(got, want) <= LOGIT_REL
    with torch.no_grad():
        full = tm.dec_logits(params, torch.from_numpy(batch["tokens"]),
                             tm.encode(params, torch.from_numpy(batch["audio_embed"])))
    torch.testing.assert_close(got, full[:, -1:])


def test_remat_full_matches_none():
    """Each encoder and decoder layer recomputed in the backward pass gives
    the loss and gradients of keeping the activations."""
    tm = treg.build_model(ARCH, smoke=True)
    params = tm.init_params(5, "cpu")
    batch = {"tokens": torch.from_numpy(_tokens(tm, 2, 13, 5)),
             "audio_embed": torch.from_numpy(_audio(tm, 2, 6))}
    out = []
    for remat in ("none", "full"):
        m = tenc.WhisperLM(dataclasses.replace(tm.cfg, remat=remat))
        leaves = {k: v.detach().requires_grad_() for k, v in _flatten(params).items()}
        loss = m.loss(_unflatten(leaves), batch)
        out.append((loss.detach(), torch.autograd.grad(
            loss, [leaves["embed"], leaves["enc/self/wq"], leaves["dec/cross/wk"]])))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_layers", [1, 3])
def test_with_layers_equals_the_reference(n_layers):
    """``with_layers`` sets both stacks and keeps ``max_target``, as the
    reference's ``_with_layers`` does."""
    from repro_torch.launch.train import with_layers
    for shape in (None, "train_4k"):
        jm = jreg.build_model(ARCH, shape=shape)
        tm = treg.build_model(ARCH, shape=shape)
        jcut = jsteps._with_layers(ARCH, jm, None, n_layers, shape)
        tcut = with_layers(tm, n_layers)
        assert type(tcut) is tenc.WhisperLM
        assert (tcut.cfg.n_layers, tcut.cfg.n_enc_layers, tcut.max_target) == \
            (jcut.cfg.n_layers, jcut.cfg.n_enc_layers, jcut.max_target) == \
            (n_layers, n_layers, 448 if shape is None else 4096)
        assert dataclasses.replace(tcut.cfg, dtype=None) == \
            dataclasses.replace(tm.cfg, n_layers=n_layers, n_enc_layers=n_layers, dtype=None)


def test_generate_raises_in_both_packages():
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    jm, ref, tm, params = _models(0)
    prompts = _tokens(jm, 2, 4, 0)
    with pytest.raises(NotImplementedError, match="prefill_cross"):
        jserve.generate(jm, ref, jnp.asarray(prompts), 2, 6)
    with pytest.raises(NotImplementedError, match="prefill_cross"):
        tserve.generate(tm, params, torch.from_numpy(prompts), 2, 6)


def test_train_lowers_the_loss_resumes_and_splits_microbatches(tmp_path):
    """``launch.train`` on the smoke config: the loss falls over 8 steps
    with a checkpoint at 6, a second run resumes at 6, and two microbatches
    (``audio_embed`` split with the tokens) give the one-batch losses."""
    from repro_torch.launch.train import main
    base = ARGS + ["--device", "cpu"]
    out1 = main(base + ["--steps", "8", "--ckpt-dir", str(tmp_path), "--ckpt-every", "6"])
    assert np.all(np.isfinite(out1["losses"])) and out1["losses"][-1] < out1["losses"][0]
    out2 = main(base + ["--steps", "8", "--ckpt-dir", str(tmp_path)])
    np.testing.assert_allclose(out2["losses"], out1["losses"][6:], rtol=1e-5)
    one = main(base + ["--steps", "3"])["losses"]
    np.testing.assert_allclose(main(base + ["--steps", "3", "--microbatches", "2"])["losses"],
                               one, rtol=1e-5)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_checkpoints_resume_across_packages(tmp_path, writer):
    """A root written by one package's ``train.main`` (6 steps, checkpoint at
    step 6) is resumed to step 9 by both; the three losses agree within f32
    tolerance, and the MANIFESTs name the same leaves, shapes, dtypes and
    chunk plans."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain
    run = {"ref": lambda a: jtrain.main(ARGS + a),
           "port": lambda a: ttrain.main(ARGS + ["--device", "cpu"] + a)}
    root = tmp_path / "root"
    run[writer](["--steps", "6", "--ckpt-dir", str(root), "--ckpt-every", "6"])
    resumed = {}
    for pkg in ("ref", "port"):
        shutil.copytree(root, tmp_path / pkg)
        resumed[pkg] = run[pkg](["--steps", "9", "--ckpt-dir", str(tmp_path / pkg),
                                 "--ckpt-every", "9"])["losses"]
    assert len(resumed["port"]) == len(resumed["ref"]) == 3
    np.testing.assert_allclose(resumed["port"], resumed["ref"], rtol=LOSS_RTOL)
    manifests = []
    for pkg in ("ref", "port"):
        with open(tmp_path / pkg / "step_00000009" / "MANIFEST.json") as fh:
            manifests.append({k: (e["shape"], e["dtype"], e["nbytes"],
                                  [(c["offset"], c["length"]) for c in e["chunks"]])
                              for k, e in json.load(fh)["leaves"].items()})
    assert manifests[0] == manifests[1]
    assert {"params/pos_dec", "params/dec/cross/wk", "opt/m/enc/mlp/b1"} <= set(manifests[0])
