"""The port's InternVL2 VLM against the reference's, on the CPU in f32.

internvl2-2b at its smoke size (2 layers, d 32, GQA 4/2 heads, untied
embeddings, 8 visual tokens): the reference's weights, fixed by a seed
(``seeded_params``), cross over with ``convert.params_from_reference``; the
same tokens and patch embeddings, made with numpy, go through
``repro.models.vlm`` and ``repro_torch.models.vlm``: the visual prefix,
the text-only loss, the prefill step's vlm branch, and decode (the dense
model's, text only).
"""
import json
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.launch import steps as jsteps
from repro_torch.ckpt.checkpoint import _flatten, _unflatten
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_reference
from repro_torch.launch import steps as tsteps
from repro_torch.models.transformer import DenseLM
from repro_torch.models.vlm import InternVLM
from test_torch_models import _close, _tokens, seeded_params

ARCH = "internvl2-2b"
LOGIT_REL = 2e-5         # f32 across packages: max |err| over max |logit|
GRAD_REL = 1e-3          # f32 gradients: max |err| over max |grad| of the leaf
LOSS_RTOL = 1e-4         # f32 losses after up to 4 resumed steps of both packages
ARGS = ["--arch", ARCH, "--smoke", "--seq-len", "16", "--global-batch", "4",
        "--log-every", "0", "--lr", "3e-2"]


def _models(seed=0):
    jm = jreg.build_model(ARCH, smoke=True)
    tm = treg.build_model(ARCH, smoke=True)
    ref = seeded_params(jm, seed)
    return jm, ref, tm, params_from_reference(ref, "cpu")


def _vis(m, B, Nv, seed):
    return np.random.default_rng(seed).standard_normal((B, Nv, m.cfg.d_model)).astype(np.float32)


def _rel_err(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_param_tree_equals_the_reference():
    """Every leaf's name, shape and dtype (the dense tree with ``unembed``),
    and the model is the dense model's subclass."""
    jm, ref, tm, _ = _models(0)
    assert isinstance(tm, InternVLM) and isinstance(tm, DenseLM)
    port, want = _flatten(tm.init_params(0, "cpu")), _flatten(ref)
    assert sorted(port) == sorted(want)
    for key, leaf in want.items():
        assert port[key].shape == leaf.shape and port[key].dtype == leaf.dtype, key
    assert port["unembed"].shape == (tm.cfg.d_model, tm.cfg.vocab)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_vis", [8, 0])
def test_logits_match_the_reference(seed, n_vis):
    """``logits_mm`` over the visual prefix and the tokens (Nv + S
    positions) within 2e-5 of the largest logit; with Nv = 0 it is the
    text-only ``logits``."""
    jm, ref, tm, params = _models(seed)
    tok, vis = _tokens(jm, 2, 11, seed + 10), _vis(jm, 2, n_vis, seed + 20)
    want = jm.logits_mm(ref, jnp.asarray(tok), jnp.asarray(vis))
    with torch.no_grad():
        got = tm.logits_mm(params, torch.from_numpy(tok), torch.from_numpy(vis))
        assert got.shape == (2, n_vis + 11, jm.cfg.vocab)
        assert _rel_err(got, want) <= LOGIT_REL, (seed, n_vis)
        if n_vis == 0:
            torch.testing.assert_close(got, tm.logits(params, torch.from_numpy(tok)))


@pytest.mark.parametrize("n_vis", [8, 0])
def test_loss_and_gradients_match_the_reference(n_vis):
    """The text-only loss (positions Nv-1 .. Nv+S-2 predict tokens[:, 1:];
    the whole sequence when Nv = 0) within f32 rounding (rtol 1e-5), and the
    gradients of both embeddings and a block's leaves within 1e-3 of the
    leaf's largest gradient."""
    jm, ref, tm, params = _models(1)
    batch = {"tokens": _tokens(jm, 2, 13, 30), "vis_embed": _vis(jm, 2, n_vis, 40)}
    leaves = {k: v.detach().requires_grad_() for k, v in _flatten(params).items()}
    loss = tm.loss(_unflatten(leaves), {k: torch.from_numpy(v) for k, v in batch.items()})
    jloss, jgrads = jax.value_and_grad(jm.loss)(ref, {k: jnp.asarray(v) for k, v in batch.items()})
    _close(loss, jloss, rtol=1e-5, atol=1e-5)
    names = ["embed", "unembed", "final_norm", "blocks/0/wq", "blocks/0/wk", "blocks/0/wg",
             "blocks/0/ln2"]
    grads = torch.autograd.grad(loss, [leaves[n] for n in names])
    jflat = _flatten(jax.tree.map(np.asarray, jgrads))
    for name, g in zip(names, grads):
        w = jflat[name].numpy()
        assert np.abs(g.numpy() - w).max() <= GRAD_REL * np.abs(w).max() + 1e-7, name


def test_prefill_step_equals_the_reference_body():
    """``build_prefill_step``'s vlm branch: ``hidden_mm`` and the last
    position against ``_out_w``, as the reference's step body computes it,
    and ``logits_mm``' last position."""
    from repro.launch.train import parse_mesh
    jm, ref, tm, params = _models(2)
    batch = {"tokens": _tokens(jm, 2, 9, 5), "vis_embed": _vis(jm, 2, 8, 6)}
    cell = jreg.ShapeCell("custom", 17, 2, "prefill")
    want = jsteps.build_prefill_step(jm, parse_mesh("1x1"), cell=cell).fn(
        ref, {k: jnp.asarray(v) for k, v in batch.items()})
    got = tsteps.build_prefill_step(tm).fn(params,
                                           {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == (2, 1, jm.cfg.vocab)
    assert _rel_err(got, want) <= LOGIT_REL
    with torch.no_grad():
        full = tm.logits_mm(params, *(torch.from_numpy(batch[k]) for k in ("tokens", "vis_embed")))
    torch.testing.assert_close(got, full[:, -1:])


def test_decode_is_the_dense_models_and_matches_the_reference():
    """Decode is ``DenseLM``'s, text only: each step equals the reference's
    decode within 2e-5 of the largest logit and the train forward within
    the dense test's 5e-3."""
    assert InternVLM.decode_step is DenseLM.decode_step
    jm, ref, tm, params = _models(0)
    B, S = 2, 12
    tok = _tokens(jm, B, S, 3)
    with torch.no_grad():
        full = tm.logits(params, torch.from_numpy(tok))
        cache, jcache = tm.init_cache(B, S, device="cpu"), jm.init_cache(B, S)
        errs, ref_errs = [], []
        for t in range(S):
            pos = torch.full((B,), t, dtype=torch.int32)
            lg, cache = tm.decode_step(params, cache, torch.from_numpy(tok[:, t:t + 1]), pos)
            jlg, jcache = jm.decode_step(ref, jcache, jnp.asarray(tok[:, t:t + 1]),
                                         jnp.full((B,), t, jnp.int32))
            errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
            ref_errs.append(_rel_err(lg, jlg))
    assert max(errs) < 5e-3 and max(ref_errs) <= LOGIT_REL, (max(errs), max(ref_errs))


def test_generate_and_serve_text_only():
    """``launch.serve`` generates through the inherited decode."""
    from repro_torch.launch import serve
    seqs = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                       "--prompt-len", "5", "--gen", "7"])
    assert seqs.shape == (2, 12) and (seqs >= 0).all() and (seqs < 128).all()


def test_train_lowers_the_loss_resumes_and_splits_microbatches(tmp_path):
    """``launch.train`` on the smoke config at seq 64 (its logits start near
    uniform, so it learns slower than the dense smoke): the loss falls over
    14 steps with a checkpoint at 10, a second run resumes at 10, and two
    microbatches (``vis_embed`` split with the tokens) give the one-batch
    losses."""
    from repro_torch.launch.train import main
    base = ARGS + ["--device", "cpu", "--seq-len", "64"]
    out1 = main(base + ["--steps", "14", "--ckpt-dir", str(tmp_path), "--ckpt-every", "10"])
    assert np.all(np.isfinite(out1["losses"])) and out1["losses"][-1] < out1["losses"][0]
    out2 = main(base + ["--steps", "14", "--ckpt-dir", str(tmp_path)])
    np.testing.assert_allclose(out2["losses"], out1["losses"][10:], rtol=1e-5)
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
    assert {"params/unembed", "opt/v/blocks/0/wq"} <= set(manifests[0])
