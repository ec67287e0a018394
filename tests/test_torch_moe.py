"""The port's MoE family against the reference's, on the CPU in f32.

qwen3-moe-30b-a3b and grok-1-314b at their smoke sizes: the reference's
weights, fixed by a seed (``seeded_params``), cross over with
``convert.params_from_reference``; the same tokens, made with numpy, go
through ``repro.models.moe`` and ``repro_torch.models.moe``. Routing is
compared only where it cannot flip: each test asserts that the logs of the
k-th and (k+1)-th router probabilities of every token are at least
``MARGIN`` apart, far above the f32 difference between the packages, so
both pick the same experts. One case scales a router column so that an expert overflows its
capacity and drops assignments, and holds both packages to each other there.
"""
import dataclasses
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.models import moe as jmoe
from repro_torch.configs import registry as treg
from repro_torch.ckpt.checkpoint import _flatten, _unflatten
from repro_torch.convert import params_from_reference
from repro_torch.distributed.mesh import Mesh
from repro_torch.models import common as tcm
from repro_torch.models import moe as tmoe
from test_torch_models import _close, _tokens, seeded_params
from test_torch_train import LOSS_RTOL, _manifest

MOE = ("qwen3-moe-30b-a3b", "grok-1-314b")
MARGIN = 1e-4            # least log-probability gap between the k-th and (k+1)-th expert
LOGIT_REL = 2e-5         # f32 across packages: max |err| over max |logit|


def _models(arch, seed=0, cf=2.0):
    jm = jreg.build_model(arch, smoke=True)
    if cf != 2.0:
        jm = type(jm)(jm.cfg, None, cf=cf)
    ref = seeded_params(jm, seed)
    tm = treg.build_model(arch, smoke=True, cf=cf)
    return jm, ref, tm, params_from_reference(ref, "cpu")


def _assert_no_near_ties(route_log, k):
    """Every token's k-th router log-probability beats its (k+1)-th by MARGIN."""
    assert route_log
    for probs in route_log:
        if k >= probs.shape[-1]:
            continue                    # every expert is chosen: no choice to flip
        top = torch.topk(probs, k + 1, dim=-1).values
        assert float((top[:, k - 1].log() - top[:, k].log()).min()) > MARGIN


# ---------------------------------------------------------------------------
# layout, capacity, the registry
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE)
def test_layout_capacity_and_param_tree_equal_the_reference(arch):
    """``expert_layout`` and ``capacity`` for every model-axis size and
    token count, and ``init_params``'s leaf names, shapes and dtypes: the
    reference's pre-sliced ``(nb, tp, E_loc, D, F/SPLIT)`` expert leaves."""
    for full in (True, False):
        jc, tc = jreg.get_config(arch, smoke=not full), treg.get_config(arch, smoke=not full)
        for tp in (1, 2, 4, 8, 16):
            assert tmoe.expert_layout(tc, tp) == jmoe.expert_layout(jc, tp)
            for t_sub, cf in ((1, 2.0), (4, 2.0), (256, 2.0), (8192, 2.0), (128, 16.0)):
                assert tmoe.capacity(t_sub, tc, tp, cf) == jmoe.capacity(t_sub, jc, tp, cf)
    full = treg.get_config(arch)
    assert tmoe.capacity(8192, full, 1, 2.0) == (1024 if arch.startswith("qwen3") else 4096)
    jm, ref, tm, _ = _models(arch)
    port, want = _flatten(tm.init_params(0, "cpu")), _flatten(ref)
    assert sorted(port) == sorted(want)
    for key, leaf in want.items():
        assert port[key].shape == leaf.shape and port[key].dtype == leaf.dtype, key
    assert {"blocks/0/router", "blocks/0/we_g", "blocks/0/we_i", "blocks/0/we_o"} <= set(port)
    assert not {"blocks/0/wi", "blocks/0/wg", "blocks/0/wmo"} & set(port)


def test_a_mesh_of_more_than_one_device_raises():
    """Where expert parallelism cannot run, both packages raise: a model
    axis that E neither divides nor is divided by (qwen3-moe's 8 experts
    on 3 columns) fails ``expert_layout``'s assert at ``init_params``, and
    the port's ``_moe_local`` over 2 columns without their group raises
    (the reference's, given no axis name, would skip its all-to-alls). A
    mesh of four over pod x data with model 1 builds with tp 1 (its train
    steps are held to the reference's in ``test_torch_dist_train``)."""
    cfg = treg.get_config("qwen3-moe-30b-a3b", smoke=True)
    three = Mesh({"data": 1, "model": 3}, (torch.device("cpu"),))
    jm = jreg.build_model("qwen3-moe-30b-a3b", smoke=True)
    jm.tp = 3
    with pytest.raises(AssertionError):
        jm.init_params(0)
    with pytest.raises(AssertionError):
        tmoe.MoELM(cfg, three).init_params(0, "cpu")
    with pytest.raises(AssertionError):
        tmoe.expert_layout(cfg, 3)
    four = Mesh({"pod": 2, "data": 2, "model": 1}, (torch.device("cpu"),))
    assert tmoe.MoELM(cfg, four).tp == 1
    x = torch.zeros((4, cfg.d_model))
    with pytest.raises(ValueError, match="needs their group"):
        tmoe._moe_local(x, None, None, None, None, cfg=cfg, tp=2, cf=2.0)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", MOE)
def test_a_model_axis_builds_with_the_reference_leaf_shapes(arch, tp):
    """A model axis of 2 or 4 builds a ``MoELM`` with that tp, whose
    ``init_params`` has the reference's leaves, shapes and dtypes at the
    same tp: ``(nb, tp, E_loc, D, F/SPLIT)`` (grok-1's smoke, 2 experts, on
    4 columns: E_loc 1, SPLIT 2). With SPLIT 1 the draws are the one-column
    weights reshaped (flat order, the same scale), so a model axis starts
    from the one-device weights."""
    cfg = treg.get_config(arch, smoke=True)
    tm = tmoe.MoELM(cfg, Mesh({"pod": 1, "data": 1, "model": tp}, (torch.device("cpu"),)))
    assert tm.tp == tp
    jm = jreg.build_model(arch, smoke=True)
    jm.tp = tp
    port, want = _flatten(tm.init_params(0, "cpu")), _flatten(jm.init_params(0))
    assert sorted(port) == sorted(want)
    for key, leaf in want.items():
        assert port[key].shape == leaf.shape and port[key].dtype == leaf.dtype, key
    e_loc, split, _ = tmoe.expert_layout(cfg, tp)
    assert port["blocks/0/we_g"].shape == (cfg.n_layers, tp, e_loc, cfg.d_model, cfg.d_ff // split)
    one = _flatten(tmoe.MoELM(cfg).init_params(0, "cpu"))
    for key in one:
        if split == 1:
            assert torch.equal(port[key].reshape(one[key].shape), one[key]), key
        elif not key.endswith(("we_g", "we_i", "we_o")):
            assert torch.equal(port[key], one[key]), key


# ---------------------------------------------------------------------------
# the MoE block alone, with capacity drops
# ---------------------------------------------------------------------------
def _block_inputs(cfg, T, seed, hot=None):
    r = np.random.default_rng(seed)
    D, E, Fd = cfg.d_model, cfg.n_experts, cfg.d_ff
    x = r.standard_normal((T, D)).astype(np.float32)
    wr = (r.standard_normal((D, E)) / np.sqrt(D)).astype(np.float32)
    if hot is not None:                 # tokens lean one way, and expert `hot` looks there
        x += 0.5
        wr[:, hot] = 0.5
    wg, wi = ((r.standard_normal((E, D, Fd)) / np.sqrt(D)).astype(np.float32) for _ in range(2))
    wo = (r.standard_normal((E, Fd, D)) / np.sqrt(Fd)).astype(np.float32)
    return x, wr, wg, wi, wo


@pytest.mark.parametrize("hot", [None, 3])
def test_moe_block_and_its_gradients_match_the_reference(hot):
    """``_moe_local`` on 64 tokens of qwen3-moe's smoke width (8 experts,
    top-2, C = 32 at cf 2): outputs and the gradients of x, the router and
    the three expert weights within f32 rounding. With ``hot`` set, one
    router column is scaled so that its expert gets more than C assignments:
    at least one is dropped, and both packages drop the same ones."""
    cfg = treg.get_config("qwen3-moe-30b-a3b", smoke=True)
    jcfg = jreg.get_config("qwen3-moe-30b-a3b", smoke=True)
    T, k = 64, cfg.top_k
    arrays = _block_inputs(cfg, T, 7, hot)
    log = []
    tensors = [torch.from_numpy(a).requires_grad_() for a in arrays]
    got = tmoe._moe_local(*tensors, cfg=cfg, tp=1, cf=2.0, route_log=log)
    _assert_no_near_ties(log, k)
    C = tmoe.capacity(T, cfg, 1, 2.0)
    per_expert = torch.bincount(torch.topk(log[0], k).indices.reshape(-1), minlength=cfg.n_experts)
    dropped = int(torch.clamp(per_expert - C, min=0).sum())
    assert (dropped > 0) == (hot is not None), (per_expert.tolist(), C)

    def ref_fn(x, wr, wg, wi, wo):
        return jmoe._moe_local(x, wr, wg, wi, wo, cfg=jcfg, tp=1, axis_name=None, cf=2.0)

    want = ref_fn(*(jnp.asarray(a) for a in arrays))
    _close(got, want, rtol=1e-5, atol=1e-5)
    cot = np.random.default_rng(8).standard_normal((T, cfg.d_model)).astype(np.float32)
    grads = torch.autograd.grad(got, tensors, torch.from_numpy(cot))
    _, vjp = jax.vjp(ref_fn, *(jnp.asarray(a) for a in arrays))
    for g, w in zip(grads, vjp(jnp.asarray(cot))):
        _close(g, w, rtol=1e-4, atol=1e-5)


def test_bucket_slots_equal_the_one_hot_cumsum_rank():
    """The stable-sort rank equals the reference's ``sum(cumsum(one_hot) *
    one_hot) - 1`` (``repro/models/moe.py:87-88``) on assignments with many
    repeats, and on one expert taking every assignment."""
    r = np.random.default_rng(4)
    for E, n in ((8, 1000), (128, 4096), (4, 1)):
        flat = r.integers(0, E, n)
        onehot = np.eye(E, dtype=np.int64)[flat]
        want = (np.cumsum(onehot, axis=0) * onehot).sum(1) - 1
        assert np.array_equal(tmoe.bucket_slots(torch.from_numpy(flat), E).numpy(), want)
    assert tmoe.bucket_slots(torch.zeros(9, dtype=torch.long), 3).tolist() == list(range(9))


def test_a_dropped_assignment_never_lands_in_the_last_slot():
    """Every token routed to one expert (top-1 of 8, C = 4 at 8 tokens and
    cf 2): the first C keep their rows, the rest return zero, and slot C-1
    holds the C-th token, not a dropped one."""
    cfg = dataclasses.replace(treg.get_config("qwen3-moe-30b-a3b", smoke=True), top_k=1)
    T, D, E = 8, cfg.d_model, cfg.n_experts
    x = torch.rand((T, D), generator=torch.Generator().manual_seed(0)) + 0.1
    wr = torch.zeros((D, E))
    wr[:, 0] = 1.0                                   # expert 0 wins for every token
    d = min(D, cfg.d_ff)
    wg = torch.zeros((E, D, cfg.d_ff))
    wg[:, torch.arange(d), torch.arange(d)] = 1.0    # the experts pass x's first d lanes
    wi, wo = wg, wg.transpose(1, 2).contiguous()
    C = tmoe.capacity(T, cfg, 1, 2.0)
    assert C == 4
    y = tmoe._moe_local(x, wr, wg, wi, wo, cfg=cfg, tp=1, cf=2.0)
    want = torch.nn.functional.silu(x[:, :d]) * x[:, :d]
    torch.testing.assert_close(y[:C, :d], want[:C], rtol=1e-6, atol=1e-6)
    assert torch.equal(y[C:], torch.zeros_like(y[C:]))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch", MOE)
def test_logits_loss_and_gradients_match_the_reference(arch, seed):
    """Logits within 2e-5 of the largest logit, the loss within f32
    rounding, and the gradients of ``embed``, the routers and the expert
    weights within 1e-3 (relative) of the reference's."""
    jm, ref, tm, params = _models(arch, seed)
    tm.route_log = []
    tok = _tokens(jm, 2, 16, 1)
    want = np.asarray(jm.logits(ref, jnp.asarray(tok)))
    with torch.no_grad():
        got = tm.logits(params, torch.from_numpy(tok)).numpy()
    _assert_no_near_ties(tm.route_log, tm.cfg.top_k)
    tm.route_log = None
    assert got.shape == want.shape == (2, 16, jm.cfg.vocab)
    assert np.abs(got - want).max() <= LOGIT_REL * np.abs(want).max()
    batch = _tokens(jm, 2, 17, 2)
    leaves = {k: v.detach().requires_grad_() for k, v in _flatten(params).items()}
    loss = tm.loss(_unflatten(leaves), {"tokens": torch.from_numpy(batch)})
    jloss, jgrads = jax.value_and_grad(jm.loss)(ref, {"tokens": jnp.asarray(batch)})
    _close(loss, jloss, rtol=1e-5, atol=1e-5)
    names = ["embed", "blocks/0/router", "blocks/0/we_g", "blocks/0/we_i", "blocks/0/we_o"]
    grads = torch.autograd.grad(loss, [leaves[n] for n in names])
    jflat = _flatten(jax.tree.map(np.asarray, jgrads))
    for name, g in zip(names, grads):
        w = jflat[name].numpy()
        assert np.abs(g.numpy() - w).max() <= 1e-3 * np.abs(w).max() + 1e-7, name


@pytest.mark.parametrize("arch,cf", [("qwen3-moe-30b-a3b", 1.0), ("grok-1-314b", 0.25)])
def test_logits_match_the_reference_with_capacity_drops(arch, cf):
    """Expert 0 overflows its capacity in every layer (asserted from the
    port's routing), and the two packages still give the same logits and
    loss. qwen3-moe: each router's column of expert 0 scaled by 8, so that
    expert takes about half of the 32 tokens against C = 8 at cf 1.
    grok-1's smoke takes both of its 2 experts for every token, so it
    overflows at cf 0.25 (C = 8 slots for 32 assignments an expert)."""
    jm, ref, tm, _ = _models(arch, 3, cf=cf)
    ref = jax.tree.map(np.array, ref)
    ref["blocks"]["0"]["router"][..., 0] *= 8.0
    params = params_from_reference(ref, "cpu")
    tok = _tokens(jm, 2, 16, 5)
    tm.route_log = []
    with torch.no_grad():
        got = tm.logits(params, torch.from_numpy(tok)).numpy()
    k, E = tm.cfg.top_k, tm.cfg.n_experts
    C = tmoe.capacity(tok.size, tm.cfg, 1, tm.cf)
    _assert_no_near_ties(tm.route_log, k)
    counts = [torch.bincount(torch.topk(p, k).indices.reshape(-1), minlength=E)
              for p in tm.route_log]
    assert len(counts) == tm.cfg.n_layers
    assert all(int(c[0]) > C for c in counts), ([c.tolist() for c in counts], C)
    want = np.asarray(jm.logits(ref, jnp.asarray(tok)))
    assert np.abs(got - want).max() <= LOGIT_REL * np.abs(want).max()
    batch = _tokens(jm, 2, 17, 6)
    _close(tm.loss(params, {"tokens": torch.from_numpy(batch)}),
           jm.loss(ref, {"tokens": jnp.asarray(batch)}), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", MOE)
def test_decode_matches_train_forward(arch):
    """The twin of tests/test_models_smoke.py::test_decode_matches_train_forward
    (cf 16: no token dropped), and each step's logits equal the reference's
    decode within 2e-5 of the largest logit."""
    jm, ref, tm, params = _models(arch, 0, cf=16.0)
    B, S = 2, 12
    tok = _tokens(jm, B, S, 3)
    with torch.no_grad():
        full = tcm.softcap(tm.logits(params, torch.from_numpy(tok)), tm.cfg.final_softcap)
        cache, jcache = tm.init_cache(B, S, device="cpu"), jm.init_cache(B, S)
        errs, ref_errs = [], []
        for t in range(S):
            pos = torch.full((B,), t, dtype=torch.int32)
            lg, cache = tm.decode_step(params, cache, torch.from_numpy(tok[:, t:t + 1]), pos)
            jlg, jcache = jm.decode_step(ref, jcache, jnp.asarray(tok[:, t:t + 1]),
                                         jnp.full((B,), t, jnp.int32))
            errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
            ref_errs.append(float(np.abs(lg.numpy() - np.asarray(jlg)).max()))
    assert max(errs) < 5e-3, (arch, max(errs))
    assert max(ref_errs) < LOGIT_REL * float(full.abs().max()), (arch, max(ref_errs))


def test_remat_full_matches_none():
    """``remat="full"`` recomputes the MoE blocks in the backward pass with
    the same loss and gradients as keeping the activations."""
    tm = treg.build_model("qwen3-moe-30b-a3b", smoke=True)
    params = tm.init_params(5, "cpu")
    tok = torch.from_numpy(_tokens(tm, 2, 13, 5))
    out = []
    for remat in ("none", "full"):
        m = tmoe.MoELM(dataclasses.replace(tm.cfg, remat=remat))
        leaves = dict(params)
        leaves["embed"] = params["embed"].detach().requires_grad_()
        loss = m.loss(leaves, {"tokens": tok})
        out.append((loss.detach(), torch.autograd.grad(loss, leaves["embed"])[0]))
    assert torch.equal(out[0][0], out[1][0])
    torch.testing.assert_close(out[0][1], out[1][1], rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------
MOE_ARGS = ["--arch", "qwen3-moe-30b-a3b", "--smoke", "--mesh", "1x1", "--seq-len", "32",
            "--global-batch", "4", "--log-every", "0", "--lr", "3e-3"]


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_checkpoints_resume_across_packages(tmp_path, writer):
    """A qwen3-moe smoke root written by one package's ``train.main`` (6
    steps, checkpoint at step 6) is resumed to step 9 by both; the losses
    agree within f32 tolerance and the MANIFESTs name the same leaves, with
    the same shapes, dtypes and chunk plans (the expert leaves included)."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain
    run = {"ref": lambda a: jtrain.main(MOE_ARGS + a),
           "port": lambda a: ttrain.main(MOE_ARGS + ["--device", "cpu"] + a)}
    root = tmp_path / "root"
    run[writer](["--steps", "6", "--ckpt-dir", str(root), "--ckpt-every", "6"])
    resumed = {}
    for pkg in ("ref", "port"):
        shutil.copytree(root, tmp_path / pkg)
        resumed[pkg] = run[pkg](["--steps", "9", "--ckpt-dir", str(tmp_path / pkg),
                                 "--ckpt-every", "9"])["losses"]
    assert len(resumed["port"]) == len(resumed["ref"]) == 3
    np.testing.assert_allclose(resumed["port"], resumed["ref"], rtol=LOSS_RTOL)
    a, b = _manifest(tmp_path / "ref", 9), _manifest(tmp_path / "port", 9)
    assert sorted(a["leaves"]) == sorted(b["leaves"])
    assert {"params/blocks/0/we_g", "opt/m/blocks/0/router", "opt/v/unembed"} <= set(a["leaves"])
    for key, ea in a["leaves"].items():
        eb = b["leaves"][key]
        for field in ("shape", "dtype", "nbytes", "file", "chunk_bytes"):
            assert ea[field] == eb[field], (key, field)


def test_with_layers_keeps_the_capacity_factor():
    from repro_torch.launch.train import with_layers
    m = with_layers(treg.build_model("qwen3-moe-30b-a3b", smoke=True, cf=16.0), 1)
    assert isinstance(m, tmoe.MoELM) and m.cf == 16.0 and m.cfg.n_layers == 1
