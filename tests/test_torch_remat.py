"""``remat="dots"``: the port's ``remat_policy`` against the reference's, on
the CPU in f32.

The reference checkpoints each layer with jax's
``dots_with_no_batch_dims_saveable``: the outputs of the ``dot_general``s
that have no batch dims (the weight projections) are kept, the rest is
recomputed in the backward pass. The port's ``maybe_remat`` runs
``torch.utils.checkpoint`` with a selective-checkpoint policy that decides
by the same dims' kind (``common._NoBatchDots``), not by aten's ``mm`` /
``bmm`` or their batch size. Held, on the smoke configs of gemma-2b,
qwen3-moe-30b-a3b, mamba2-370m, recurrentgemma-2b and whisper-large-v3
(``remat`` set by ``dataclasses.replace``), with the reference's seeded
weights (``test_torch_models.seeded_params``, crossed over with
``convert.params_from_reference``):

  * every leaf's gradient of the loss under "dots" within 1e-4 of the
    leaf's largest gradient of the reference's under "dots" (whisper's
    within 1e-3, its gradient bound in ``test_torch_encdec``: its init
    amplifies f32 rounding through the encoder, 1.7e-4 here);
  * the same gradients equal to the port's own under "full" bit for bit,
    and within 1e-6 of the leaf's largest under "none" (keeping the
    activations lets autograd sum some gradients in another order);
  * the outputs the policy saves, counted call by call of the checkpointed
    layer: the reference's products with no batch dims in each of its
    "dots" regions (from its jaxpr), and for gemma-2b the layer's seven
    weight projections, at B = 4 and at B = 1 (one kv head: its attention
    products reach aten as ``bmm`` of batch 1, like a projection, and are
    not saved);
  * over ZeRO-3 (gemma-2b on a (1, 4, 1) mesh of four gloo ranks): the
    gather of a layer's weights over ``data`` is not a product, so "dots"
    gathers again in the backward pass as "full" does (the same count of
    all-gathers, more than "none"'s), with "full"'s gradients bit for bit.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jreg
from repro.launch.steps import _rebuild as ref_rebuild
from repro_torch.ckpt.checkpoint import _flatten, _unflatten
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_reference
from repro_torch.launch.train import rebuild
from repro_torch.models import common as tcm
from test_torch_collectives import spawn_world
from test_torch_models import seeded_params

ARCHS = ("gemma-2b", "qwen3-moe-30b-a3b", "mamba2-370m", "recurrentgemma-2b",
         "whisper-large-v3")
GRAD_REL = 1e-4                    # of the leaf's largest gradient, against the reference
WHISPER_GRAD_REL = 1e-3            # test_torch_encdec.GRAD_REL
NONE_REL = 1e-6                    # "dots" against "none": the order of autograd's sums
S = 12


def _models(arch, remat):
    jm = jreg.build_model(arch, smoke=True)
    tm = treg.build_model(arch, smoke=True)
    return (ref_rebuild(jm, None, dataclasses.replace(jm.cfg, remat=remat), None),
            rebuild(tm, dataclasses.replace(tm.cfg, remat=remat)))


def _batch(cfg, B, seed=3):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["audio_embed"] = rng.standard_normal((B, cfg.enc_positions, cfg.d_model)) \
            .astype(np.float32)
    return batch


def _port_grads(tm, params, batch):
    leaves = {k: v.detach().requires_grad_() for k, v in _flatten(params).items()}
    loss = tm.loss(_unflatten(leaves), {k: torch.from_numpy(v) for k, v in batch.items()})
    return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


@pytest.fixture(scope="module", params=ARCHS)
def grads(request):
    arch = request.param
    jm, _ = _models(arch, "dots")
    ref = seeded_params(jm, 0)
    params = params_from_reference(ref, "cpu")
    batch = _batch(jm.cfg, 2)
    jgrads = jax.grad(jm.loss)(ref, {k: jnp.asarray(v) for k, v in batch.items()})
    out = {"ref": {k: np.asarray(v) for k, v in _flatten(jax.tree.map(np.asarray, jgrads))
                   .items()}}
    for remat in ("dots", "full", "none"):
        out[remat] = _port_grads(_models(arch, remat)[1], params, batch)
    return arch, out


def test_dots_gradients_match_the_reference(grads):
    arch, g = grads
    rel = WHISPER_GRAD_REL if arch.startswith("whisper") else GRAD_REL
    assert sorted(g["dots"]) == sorted(g["ref"])
    for name, got in g["dots"].items():
        want = np.asarray(g["ref"][name], np.float64)
        err = np.abs(got.double().numpy() - want).max()
        assert err <= rel * np.abs(want).max() + 1e-9, (arch, name, err)


def test_dots_gradients_equal_full_and_none(grads):
    arch, g = grads
    for name, got in g["dots"].items():
        assert torch.equal(got, g["full"][name]), (arch, name)
        other = g["none"][name]
        assert (got - other).abs().max() <= NONE_REL * other.abs().max() + 1e-12, (arch, name)


# ---------------------------------------------------------------------------
# what the policy saves
# ---------------------------------------------------------------------------
def _reference_saved(jm, ref, batch) -> set:
    """For each ``jax.checkpoint`` region of the reference's loss under
    ``dots_with_no_batch_dims_saveable``, the sorted element counts of its
    ``dot_general``s with no batch dims."""
    policy = jax.checkpoint_policies.dots_with_no_batch_dims_saveable
    jaxpr = jax.make_jaxpr(jm.loss)(ref, {k: jnp.asarray(v) for k, v in batch.items()})
    found = []

    def dots(jx):
        out = []
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general":
                (_c, (lb, _rb)) = eqn.params["dimension_numbers"]
                if not lb:
                    out.append(int(np.prod(eqn.outvars[0].aval.shape)))
            for sub in jax.core.jaxprs_in_params(eqn.params):
                out += dots(sub)
        return out

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.params.get("policy") is policy:
                found.append(tuple(sorted(dots(eqn.params["jaxpr"]))))
                continue
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jaxpr.jaxpr)
    return set(found)


def _port_saved(tm, params, batch, monkeypatch) -> list:
    """For each call of a checkpointed layer of the port's loss, the sorted
    element counts of the outputs ``_dots_policy`` saves."""
    calls: dict = {}
    real = tcm._dots_policy

    def spy(state, ctx, op, *args, **kwargs):
        policy = real(state, ctx, op, *args, **kwargs)
        if policy == tcm.CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            calls.setdefault(id(state), []).append(op(*args, **kwargs).numel())
        return policy

    monkeypatch.setattr(tcm, "_dots_policy", spy)
    _port_grads(tm, params, batch)
    return [tuple(sorted(c)) for c in calls.values()]


@pytest.mark.parametrize("arch,B", [(a, 4) for a in ARCHS] + [("gemma-2b", 1)])
def test_dots_saves_the_weight_projections_and_nothing_else(arch, B, monkeypatch):
    jm, tm = _models(arch, "dots")
    ref = seeded_params(jm, 0)
    batch = _batch(jm.cfg, B)
    want = _reference_saved(jm, ref, batch)
    got = _port_saved(tm, params_from_reference(ref, "cpu"), batch, monkeypatch)
    assert got and want and set(got) == want, (got, want)
    if arch == "gemma-2b":
        cfg, t = tm.cfg, B * S
        proj = sorted([t * cfg.n_heads * cfg.hd, t * cfg.n_kv_heads * cfg.hd,
                       t * cfg.n_kv_heads * cfg.hd, t * cfg.d_model, t * cfg.d_ff,
                       t * cfg.d_ff, t * cfg.d_model])
        assert got == [tuple(proj)] * cfg.n_layers


def test_remat_policy_names():
    assert tcm.remat_policy("none") is None
    assert tcm.remat_policy("full") is torch.utils.checkpoint.noop_context_fn
    assert tcm.remat_policy("dots") is tcm._dots_context


def _zero_world(rank, root):
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.launch.train import shard_state

    mesh = make_mesh((1, 4, 1), ("pod", "data", "model"), device="cpu")
    one = treg.build_model("gemma-2b", smoke=True)
    params = one.init_params(0, "cpu")
    tokens = _batch(one.cfg, 4)["tokens"][rank:rank + 1]
    real, count = tcm.all_gather_into, [0]

    def counting(*args, **kwargs):
        count[0] += 1
        return real(*args, **kwargs)

    out = {}
    tcm.all_gather_into = counting
    try:
        for remat in ("dots", "full", "none"):
            tm = rebuild(treg.build_model("gemma-2b", mesh, smoke=True),
                         dataclasses.replace(one.cfg, remat=remat))
            blocks = shard_state(mesh, params, tm.param_specs(mesh))
            count[0] = 0
            grads = _port_grads(tm, blocks, {"tokens": tokens})
            out[remat] = {"gathers": count[0],
                          "grads": {k: v.numpy().tolist() for k, v in grads.items()}}
    finally:
        tcm.all_gather_into = real
    (root / f"zero{rank}.json").write_text(json.dumps(out))


def test_dots_gathers_zero_blocks_again_in_the_backward(tmp_path):
    spawn_world(_zero_world, 4, (tmp_path,), tmp_path, timeout=120)
    for r in range(4):
        got = json.loads((tmp_path / f"zero{r}.json").read_text())
        assert got["dots"]["gathers"] == got["full"]["gathers"] > got["none"]["gathers"] > 0
        assert got["dots"]["grads"] == got["full"]["grads"]
