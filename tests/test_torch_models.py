"""The port's dense model against the reference's, on the CPU in f32.

The same inputs, made from a seed with numpy, go through
``repro.models.common`` / ``repro.models.transformer`` and their twins in
``repro_torch``; the reference's weights, fixed by a seed (``seeded_params``),
cross over with ``convert.params_from_reference``. Tolerances are stated per
test: the two packages run the same f32 arithmetic, so they differ by
summation order (XLA's and torch's matmuls, reductions and transcendental
functions), and an error that scales with the terms summed is bounded
against the largest logit, not by a flat constant.

``seeded_params`` is shared by ``tests/test_torch_{moe,ssm,hybrid}.py``.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.models import common as jcm
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_reference, params_to_reference
from repro_torch.models import common as tcm

DENSE = ("gemma-2b", "gemma2-2b", "mistral-nemo-12b", "yi-34b")
RTOL, ATOL = 2e-5, 2e-5            # f32, one op or one layer


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach().numpy() if isinstance(got, torch.Tensor)
                                          else got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol, atol=atol)


def _trunc_normal(rng, shape):
    """Standard normal draws of ``rng`` truncated to [-2, 2] by redrawing."""
    x = rng.standard_normal(shape)
    bad = np.abs(x) > 2.0
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(x) > 2.0
    return x


def seeded_params(jm, seed: int) -> dict:
    """The reference model ``jm``'s params (a tree of numpy arrays) with every
    drawn leaf fixed by ``seed``.

    The reference's ``Initializer`` keys each leaf by ``hash(path)``, which
    Python salts per process, so its ``init_params(0)`` gives other weights in
    every process. Here ``init_params`` runs with an initializer that records
    each drawn leaf's scale (the model's, else ``1/sqrt(fan_in)``); those
    leaves are then filled from ``np.random.default_rng(seed)`` in sorted
    path order with the reference's law, a standard normal truncated to ±2
    times the scale. Zeros, ones and constants (``A_log``) stay the
    reference's."""
    drawn = {}

    class Recording(jcm.Initializer):
        def __call__(self, path, shape, scale=None):
            if scale is None:
                scale = 1.0 / math.sqrt(shape[-2] if len(shape) >= 2 else shape[-1])
            leaf = np.zeros(tuple(shape), np.float32)
            drawn[id(leaf)] = (leaf, scale, self.dtype)
            return leaf

    real, jcm.Initializer = jcm.Initializer, Recording
    try:
        tree = jm.init_params(0)
    finally:
        jcm.Initializer = real
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    out = [np.asarray(leaf) for _, leaf in flat]
    rng = np.random.default_rng(seed)
    for i in sorted(range(len(flat)), key=lambda j: jax.tree_util.keystr(flat[j][0])):
        if id(flat[i][1]) in drawn:
            leaf, scale, dtype = drawn[id(flat[i][1])]
            out[i] = np.asarray(jnp.asarray(_trunc_normal(rng, leaf.shape) * scale, dtype))
    return jax.tree_util.tree_unflatten(treedef, out)


def _ref_params(arch, seed=0):
    m = jreg.build_model(arch, smoke=True)
    return m, seeded_params(m, seed)


def _port_model(arch):
    return treg.build_model(arch, smoke=True)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------
def test_rms_norm_rope_softcap_gated_mlp():
    r = _rng(0)
    x = r.standard_normal((2, 7, 4, 16)).astype(np.float32)
    scale = r.standard_normal(16).astype(np.float32) * 0.1
    for unit in (True, False):
        _close(tcm.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), unit_offset=unit),
               jcm.rms_norm(jnp.asarray(x), jnp.asarray(scale), unit_offset=unit))
    pos = r.integers(0, 5000, (2, 7)).astype(np.int32)
    for theta in (10000.0, 1_000_000.0):
        _close(tcm.rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
               jcm.rope(jnp.asarray(x), jnp.asarray(pos), theta))
    lg = (r.standard_normal((3, 11)) * 80).astype(np.float32)
    for cap in (None, 30.0, 50.0):
        _close(tcm.softcap(torch.from_numpy(lg), cap), jcm.softcap(jnp.asarray(lg), cap))
    h = r.standard_normal((5, 24)).astype(np.float32)
    wi, wg = (r.standard_normal((24, 40)).astype(np.float32) * 0.2 for _ in range(2))
    wo = r.standard_normal((40, 24)).astype(np.float32) * 0.2
    for act in ("silu", "gelu"):
        _close(tcm.gated_mlp(*(torch.from_numpy(a) for a in (h, wi, wg, wo)), act),
               jcm.gated_mlp(*(jnp.asarray(a) for a in (h, wi, wg, wo)), act))


@pytest.mark.parametrize("final_cap", [None, 30.0])
def test_cross_entropy_and_chunked_xent(final_cap):
    r = _rng(1)
    logits = (r.standard_normal((2, 9, 50)) * 3).astype(np.float32)
    labels = r.integers(0, 50, (2, 9)).astype(np.int32)
    mask = (r.random((2, 9)) > 0.3).astype(np.float32)
    for m in (None, mask):
        _close(tcm.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                 mask=None if m is None else torch.from_numpy(m),
                                 final_cap=final_cap),
               jcm.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 mask=None if m is None else jnp.asarray(m),
                                 final_cap=final_cap))
    h = r.standard_normal((2, 21, 16)).astype(np.float32)
    w = r.standard_normal((16, 50)).astype(np.float32) * 0.5
    labels = r.integers(0, 50, (2, 21)).astype(np.int32)
    mask = (r.random((2, 21)) > 0.2).astype(np.float32)
    for chunk in (8, 64):                  # padded chunks, and one whole pass
        for m in (None, mask):
            got = tcm.chunked_xent(torch.from_numpy(h), torch.from_numpy(w),
                                   torch.from_numpy(labels), final_cap=final_cap,
                                   mask=None if m is None else torch.from_numpy(m),
                                   seq_chunk=chunk)
            want = jcm.chunked_xent(jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels),
                                    final_cap=final_cap,
                                    mask=None if m is None else jnp.asarray(m),
                                    seq_chunk=chunk)
            _close(got, want)


def _attn_inputs(seed, B, S, T, H, KVH, hd, invalid=0.0, decode=False):
    r = _rng(seed)
    q = r.standard_normal((B, S, H, hd)).astype(np.float32)
    k = r.standard_normal((B, T, KVH, hd)).astype(np.float32)
    v = r.standard_normal((B, T, KVH, hd)).astype(np.float32)
    q_pos = (np.full((B, S), T - 1) if decode else np.tile(np.arange(S), (B, 1))).astype(np.int32)
    kv_pos = np.tile(np.arange(T), (B, 1)).astype(np.int32)
    if invalid:
        drop = r.random((B, T)) < invalid
        drop[:, 0] = False                 # every query keeps one valid key
        kv_pos[drop] = -1
    return q, k, v, q_pos, kv_pos


@pytest.mark.parametrize("window", [None, 100])
@pytest.mark.parametrize("cap", [None, 50.0])
@pytest.mark.parametrize("shape", ["dense", "blocked", "blocked_256", "decode"])
def test_attention_paths(shape, cap, window):
    """Both of the reference's attention paths: the dense one (S <= 1024)
    and the blocked online softmax (S > 1024, with KV padding to the
    block), GQA, global and local windows, with and without a soft-cap,
    with invalid (-1) cache slots."""
    B, H, KVH, hd = 2, 4, 2, 8
    kw = {}
    if shape == "dense":
        args = _attn_inputs(2, B, 37, 37, H, KVH, hd, invalid=0.2)
    elif shape == "decode":
        args = _attn_inputs(3, B, 1, 150, H, KVH, hd, invalid=0.3, decode=True)
    else:
        B = 1
        args = _attn_inputs(4, B, 1030, 1030, H, KVH, hd, invalid=0.1)
        if shape == "blocked_256":
            kw["block_kv"] = 256
    q, k, v, q_pos, kv_pos = args
    got = tcm.attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True,
                        q_positions=torch.from_numpy(q_pos),
                        kv_positions=torch.from_numpy(kv_pos),
                        window=window, logit_cap=cap, **kw)
    want = jcm.attention(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                         q_positions=jnp.asarray(q_pos), kv_positions=jnp.asarray(kv_pos),
                         window=window, logit_cap=cap, **kw)
    assert got.shape == want.shape
    _close(got, want, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# configs and the registry
# ---------------------------------------------------------------------------
def _fields(cfg):
    out = dataclasses.asdict(cfg)
    out["dtype"] = str(out["dtype"]).replace("torch.", "").replace("<class 'jax.numpy.", "") \
        .replace("'>", "")
    return out


@pytest.mark.parametrize("arch", treg.ARCHS)
def test_configs_copy_the_reference_field_for_field(arch):
    for smoke in (False, True):
        want = _fields(jreg.get_config(arch, smoke=smoke))
        got = _fields(treg.get_config(arch, smoke=smoke))
        assert got == want, arch
    # the reference's published sizes (tests/test_models_smoke.py)
    full = treg.get_config(arch)
    assert full.param_count() == jreg.get_config(arch).param_count()
    assert full.active_param_count() == jreg.get_config(arch).active_param_count()
    assert full.layer_kinds() == jreg.get_config(arch).layer_kinds()
    assert full.hd == jreg.get_config(arch).hd


def test_registry_matches_and_refuses_unported_families():
    """Every arch of the reference builds its family's twin (an encdec with
    the reference's ``max_target`` rule); an arch outside ``ARCHS`` raises
    ``KeyError``."""
    assert treg.ARCHS == jreg.ARCHS
    assert {k: dataclasses.astuple(v) for k, v in treg.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jreg.SHAPES.items()}
    assert treg.cells(include_skipped=True) == jreg.cells(include_skipped=True)
    for arch in jreg.ARCHS:
        for shape in jreg.SHAPES:
            assert treg.skip_reason(arch, shape) == jreg.skip_reason(arch, shape)
        for smoke in (False, True):
            assert type(treg.build_model(arch, smoke=smoke)).__name__ == \
                type(jreg.build_model(arch, smoke=smoke)).__name__
    for shape in (None, *jreg.SHAPES):
        for kw in ({}, {"max_target": 100}, {"max_target": 1000}):
            assert treg.build_model("whisper-large-v3", shape=shape, **kw).max_target == \
                jreg.build_model("whisper-large-v3", shape=shape, **kw).max_target
    with pytest.raises(KeyError):
        treg.build_model("gpt-2")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE)
def test_param_tree_equals_the_reference(arch):
    """Leaf names, shapes and dtypes of ``init_params``, and the crossing
    of the reference's weights into the port and back."""
    jm, ref = _ref_params(arch)
    port = _port_model(arch).init_params(0, "cpu")
    flat_ref = {"/".join(str(getattr(p, "key", p)) for p in path): leaf
                for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]}
    flat_port = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat_port[prefix + k] = v

    walk(port, "")
    assert sorted(flat_port) == sorted(flat_ref)
    for key, leaf in flat_ref.items():
        assert tuple(flat_port[key].shape) == leaf.shape, key
        assert str(flat_port[key].dtype).replace("torch.", "") == leaf.dtype.name, key
    crossed = params_from_reference(ref, "cpu")
    back = params_to_reference(crossed)
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        got = back
        for p in path:
            got = got[p.key]
        np.testing.assert_array_equal(got, leaf)


def _tokens(m, B, S, seed):
    return _rng(seed).integers(0, m.cfg.vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("arch", DENSE)
def test_logits_and_loss_match_the_reference(arch, seed):
    """Logits within 2e-5 of the largest logit (f32 error grows with the
    terms summed, so a flat bound fails on a draw whose logits reach ~50),
    the loss within f32 rounding, ``embed``'s gradient within 1e-3; over
    three weight seeds."""
    jm, ref = _ref_params(arch, seed)
    tm = _port_model(arch)
    params = params_from_reference(ref, "cpu")
    tok = _tokens(jm, 2, 16, 1)
    want = np.asarray(jm.logits(ref, jnp.asarray(tok)))
    got = tm.logits(params, torch.from_numpy(tok)).detach().numpy()
    assert got.shape == want.shape == (2, 16, jm.cfg.vocab)
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max(), (arch, seed)
    batch = _tokens(jm, 2, 17, 2)
    _close(tm.loss(params, {"tokens": torch.from_numpy(batch)}),
           jm.loss(ref, {"tokens": jnp.asarray(batch)}), rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad(
        tm.loss({k: v for k, v in params.items()} | {"embed": params["embed"].requires_grad_()},
                {"tokens": torch.from_numpy(batch)}), params["embed"])[0]
    jgrads = jax.grad(jm.loss)(ref, {"tokens": jnp.asarray(batch)})["embed"]
    _close(grads, jgrads, rtol=1e-3, atol=1e-4)      # |grad| up to ~0.1


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_train_forward(arch):
    """Step-by-step decode with KV caches reproduces the full forward (the
    twin of tests/test_models_smoke.py::test_decode_matches_train_forward,
    same tolerance), and each step's logits equal the reference's decode
    within 2e-5 of the largest logit."""
    jm, ref = _ref_params(arch)
    tm = _port_model(arch)
    params = params_from_reference(ref, "cpu")
    B, S = 2, 12
    tok = _tokens(jm, B, S, 3)
    with torch.no_grad():
        full = tcm.softcap(tm.logits(params, torch.from_numpy(tok)), tm.cfg.final_softcap)
        cache = tm.init_cache(B, S, device="cpu")
        jcache = jm.init_cache(B, S)
        errs, ref_errs = [], []
        for t in range(S):
            pos = torch.full((B,), t, dtype=torch.int32)
            lg, cache = tm.decode_step(params, cache, torch.from_numpy(tok[:, t:t + 1]), pos)
            jlg, jcache = jm.decode_step(ref, jcache, jnp.asarray(tok[:, t:t + 1]),
                                         jnp.full((B,), t, jnp.int32))
            errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
            ref_errs.append(float(np.abs(lg.numpy() - np.asarray(jlg)).max()))
    assert max(errs) < 5e-3, (arch, max(errs))
    # f32 across packages: 2e-5 of the largest logit (gemma's reach ~50)
    assert max(ref_errs) < 2e-5 * float(full.abs().max()), (arch, max(ref_errs))


def test_local_window_ring_buffer_exceeds_window():
    """Decode beyond the window: the ring buffer evicts correctly (gemma2,
    window 8 in its smoke config; the twin of the reference's test)."""
    jm, ref = _ref_params("gemma2-2b")
    tm = _port_model("gemma2-2b")
    params = params_from_reference(ref, "cpu")
    B, S = 1, 20
    tok = _tokens(jm, B, S, 4)
    with torch.no_grad():
        full = tcm.softcap(tm.logits(params, torch.from_numpy(tok)), tm.cfg.final_softcap)
        cache = tm.init_cache(B, S, device="cpu")
        assert cache["k0"].shape[2] == tm.cfg.window and cache["k1"].shape[2] == S
        for t in range(S):
            lg, cache = tm.decode_step(params, cache, torch.from_numpy(tok[:, t:t + 1]),
                                       torch.full((B,), t, dtype=torch.int32))
    assert float((lg[:, 0] - full[:, -1]).abs().max()) < 5e-3
    # the local layer's ring holds the last `window` positions
    assert sorted(cache["p0"][0, 0].tolist()) == list(range(S - tm.cfg.window, S))


def test_remat_full_matches_none():
    """``remat="full"`` recomputes each block in the backward pass and gives
    the same loss and gradients as keeping the activations."""
    tm = _port_model("gemma2-2b")
    params = tm.init_params(5, "cpu")
    tok = torch.from_numpy(_tokens(tm, 2, 13, 5))
    out = []
    for remat in ("none", "full"):
        m = type(tm)(dataclasses.replace(tm.cfg, remat=remat))
        leaves = {k: v for k, v in params.items()}
        leaves["embed"] = params["embed"].detach().requires_grad_()
        loss = m.loss(leaves, {"tokens": tok})
        out.append((loss.detach(), torch.autograd.grad(loss, leaves["embed"])[0]))
    assert torch.equal(out[0][0], out[1][0])
    torch.testing.assert_close(out[0][1], out[1][1], rtol=0, atol=1e-6)
