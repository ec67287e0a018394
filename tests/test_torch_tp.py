"""The port's model axis (tensor parallelism) against the reference's, on
four CPU ranks.

The dense transformer (gemma-2b's smoke config: one kv head, tied
embeddings) and the vlm (internvl2-2b's: untied) on (1, 2, 2) and
(1, 1, 4) pod x data x model meshes under "auto", and on (2, 1, 2) under
"chunked"; each also with an odd vocab of 127 (``dataclasses.replace`` in
both packages), whose ``embed`` and ``unembed`` stay whole (``shardable``),
as internvl2-2b's 92553 does at full width. The port runs in one world of
four gloo ranks (``test_torch_collectives.spawn_world``), each rank on its
blocks of the reference's weights (``test_torch_models.seeded_params``,
crossed over with ``convert.params_from_reference``, then
``launch.train.shard_state``); the reference runs the same cases on four
fake devices in one subprocess, started before the port's world so the two
overlap. Held, case by case:

  * ``DenseLM.param_specs`` equal to the reference's, entry for entry, for
    the smoke configs of gemma-2b, internvl2-2b, mistral-nemo-12b and
    yi-34b (whose six heads stay whole on four ranks), the train specs and
    the weight-stationary serve specs (``serve=True``);
  * the logits (``logits``; ``logits_mm`` for the vlm), gathered over
    ``model``, within ``LOGITS_RTOL`` of the largest logit;
  * step 1's gradients, gathered, within ``GRAD_RTOL`` (1e-4) of each
    leaf's norm (gemma-2b's smoke logits reach ~50 at a loss of 36, and the
    f32 summation orders leave up to 4.5e-5 there; internvl2-2b's, 8e-6);
  * three train steps: the losses of each and step 1's grad norm within
    ``LOSS_RTOL`` (1e-4); the params after step 1, gathered, within
    ``UPDATE_RTOL`` (1e-3) of the norm of the reference's update (the bound
    and its reason are ``test_torch_dist_train``'s), that norm taken over
    the elements whose AdamW denominator sqrt(v̂) is at least ``SETTLED``
    (100·eps). Below it AdamW's step lr·m̂/(sqrt(v̂) + eps) turns a
    difference of summation order of 1e-10 into up to lr/100, so those
    elements are held within 2·lr. The tied odd-vocab gemma-2b has such
    elements (the port's own one-device step and the reference's differ by
    3e-3 of the update's norm over all of ``wi``), and their differences
    feed the next steps' gradients: by step 2, elements whose denominator
    is settled differ by 0.14·lr there, so the later steps' params are held
    by their losses;
  * every leaf that is not cut over ``model`` bit-equal on every rank
    after every step (norms, gemma-2b's one-kv-head ``wk`` / ``wv``, the
    odd vocab's ``embed`` and ``unembed``);
  * every tensor handed to ``torch.distributed`` contiguous, as NCCL needs.

Then ``launch.train.main`` itself, the twin of
``tests/test_system.py::test_elastic_restart_smaller_mesh``: gemma-2b on
``--mesh 2x2`` (data x model) saves at step 3 and runs to 5; a world of
two resumes that root on ``1x2`` with the same losses. The saved MANIFEST
names the leaves, shapes, dtypes and chunks of a one-device run's, and
step 1's loss is the one-device run's: every mesh starts from the
one-device weights. JAX is imported only in the reference's subprocess and
in the spec test.
"""
import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from test_torch_collectives import spawn_world
from test_torch_dist_train import (
    ADAM_B2, SETTLED, _flat, _require_contiguous, _unflat, assert_blocks_agree, cut_of,
    finish_multidevice, start_multidevice)

LOSS_RTOL, UPDATE_RTOL = 1e-4, 1e-3
GRAD_RTOL = LOSS_RTOL              # of a leaf's gradient norm: f32, summation order only
LOGITS_RTOL = 2e-5                 # of the largest logit: f32, summation order only
STEPS, LR, SEQ, BATCH, SEED = 3, 1e-2, 32, 8, 3
AXES = ("pod", "data", "model")
ODD_VOCAB = 127
CASES = [(arch, shape, mode, vocab)
         for arch in ("gemma-2b", "internvl2-2b")
         for shape, mode, vocab in (((1, 2, 2), "auto", None), ((1, 1, 4), "auto", None),
                                    ((2, 1, 2), "chunked", None),
                                    ((1, 2, 2) if arch == "gemma-2b" else (1, 1, 4), "auto",
                                     ODD_VOCAB))]
# over ATTN_DENSE_MAX (1024) and two seq chunks of the loss (512): the blocked
# attention and the vocab-parallel chunked cross-entropy, recomputed under remat
LONG_SEQ = 1100
SHARD_MESHES = ((1, 1, 4), (2, 2, 1))
ELASTIC_ARGS = ["--arch", "gemma-2b", "--smoke", "--seq-len", "32", "--global-batch", "4",
                "--log-every", "0", "--lr", "3e-3", "--device", "cpu", "--seed", "1"]


def _name(arch, shape, mode, vocab):
    return f"{arch}-{'x'.join(map(str, shape))}-{mode}" + (f"-v{vocab}" if vocab else "")


NAMES = [_name(*c) for c in CASES]


def _weights_key(arch, vocab):
    return f"{arch}-v{vocab}" if vocab else arch


# ---------------------------------------------------------------------------
# the inputs: seeded reference weights, logit inputs, visual embeddings
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def root(tmp_path_factory):
    from repro.configs import registry as jreg
    from test_torch_models import seeded_params

    path = tmp_path_factory.mktemp("tp")
    for arch, vocab in {(a, v) for a, _s, _m, v in CASES}:
        jm = jreg.build_model(arch, smoke=True)
        if vocab:
            jm = type(jm)(dataclasses.replace(jm.cfg, vocab=vocab), None)
        np.savez(path / f"params-{_weights_key(arch, vocab)}.npz", **_flat(seeded_params(jm, 0)))
        cfg = jm.cfg
        rng = np.random.default_rng(7)
        np.savez(path / f"inputs-{_weights_key(arch, vocab)}.npz",
                 tokens=rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32),
                 vis=rng.standard_normal((2, max(cfg.n_vis_tokens, 1), cfg.d_model)).astype(np.float32),
                 train_vis=rng.standard_normal((BATCH, max(cfg.n_vis_tokens, 1), cfg.d_model))
                 .astype(np.float32))
    np.save(path / "long_tokens.npy",
            np.random.default_rng(8).integers(0, 128, (2, LONG_SEQ + 1)).astype(np.int32))
    return path


# ---------------------------------------------------------------------------
# the reference: the same cases on four fake devices, in the background
# ---------------------------------------------------------------------------
REFERENCE = """
import dataclasses, json
import numpy as np, jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.registry import build_model, ShapeCell
from repro.data.pipeline import DataConfig, _batch_at
from repro.distributed.mesh import make_mesh
from repro.launch.steps import build_train_step
from repro.optim import adamw

root, CASES, STEPS, LR, SEQ, BATCH, SEED = ARGS
out, meta = {}, {}

def unflat(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree

for arch, shape, mode, vocab, name, wkey in CASES:
    mesh = make_mesh(tuple(shape), ("pod", "data", "model"), devices=jax.devices()[:4])
    model = build_model(arch, mesh, smoke=True)
    if vocab:
        model = type(model)(dataclasses.replace(model.cfg, vocab=vocab), mesh)
    vlm = model.cfg.family == "vlm"
    inp = dict(np.load(f"{root}/inputs-{wkey}.npz"))
    ocfg = adamw.AdamWConfig(lr=LR, warmup_steps=1)
    b = build_train_step(model, mesh, ocfg, cell=ShapeCell("t", SEQ, BATCH, "train"),
                         sync_mode=mode)
    with mesh:
        pspecs = model.param_specs(mesh)
        params = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                              unflat(dict(np.load(f"{root}/params-{wkey}.npz"))), pspecs)
        if vlm:
            lg = jax.jit(model.logits_mm)(params, inp["tokens"], inp["vis"])
        else:
            lg = jax.jit(model.logits)(params, inp["tokens"])
        out[f"{name}/logits"] = np.asarray(lg)
        step = jax.jit(b.fn, in_shardings=b.in_shardings, out_shardings=b.out_shardings)
        opt = adamw.init(params, ocfg)
        bsh = NamedSharding(mesh, P(("pod", "data"), None))
        losses, norms = [], []
        for i in range(STEPS):
            tok = _batch_at(DataConfig(vocab=model.cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                                       seed=SEED), i)
            batch = {"tokens": jax.device_put(tok, bsh)}
            if vlm:
                batch["vis_embed"] = jax.device_put(
                    inp["train_vis"], NamedSharding(mesh, P(("pod", "data"), None, None)))
            if i == 0:
                grads = jax.jit(jax.grad(model.loss))(params, batch)
                for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
                    out[f"{name}/grad/" + "/".join(p.key for p in path)] = np.asarray(leaf)
            params, opt, stats = step(params, opt, batch)
            losses.append(float(stats["loss"]))
            norms.append(float(stats["grad_norm"]))
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
                out[f"{name}/{i}/" + "/".join(p.key for p in path)] = np.asarray(leaf)
            if i == 0:
                for path, leaf in jax.tree_util.tree_flatten_with_path(opt.v)[0]:
                    out[f"{name}/v0/" + "/".join(p.key for p in path)] = np.asarray(leaf)
    meta[name] = {"losses": losses, "grad_norms": norms}
np.savez(root + "/ref.npz", **out)
json.dump(meta, open(root + "/ref.json", "w"))
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def reference_started(root):
    cases = [(a, list(s), m, v, _name(a, s, m, v), _weights_key(a, v)) for a, s, m, v in CASES]
    code = REFERENCE.replace("ARGS", repr((str(root), cases, STEPS, LR, SEQ, BATCH, SEED)))
    log = open(root / "ref.log", "w")
    proc = start_multidevice(code, 4, log)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    log.close()


# ---------------------------------------------------------------------------
# the port: four gloo ranks, then two
# ---------------------------------------------------------------------------
def _port_tp(rank, root):
    import torch.distributed as dist

    from repro_torch.configs import registry as treg
    from repro_torch.configs.registry import ShapeCell
    from repro_torch.convert import gather_params, params_from_reference
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.distributed.mesh import P, gather, make_mesh, model_dims, shard
    from repro_torch.launch import train
    from repro_torch.launch.steps import (
        _value_and_grad, batch_mean, build_train_step, zero_leaves)
    from repro_torch.optim import adamw

    loose = _require_contiguous(dist)
    out, meta = {}, {"mesh": {}}
    for arch, shape, mode, vocab in CASES:
        name = _name(arch, shape, mode, vocab)
        wkey = _weights_key(arch, vocab)
        mesh = make_mesh(shape, AXES, device="cpu")
        meta["mesh"][name] = {a: mesh.rank(a) for a in AXES}
        model = treg.build_model(arch, mesh, smoke=True)
        if vocab:
            model = train.rebuild(model, dataclasses.replace(model.cfg, vocab=vocab))
        vlm = model.cfg.family == "vlm"
        specs = model.param_specs(mesh)
        inp = dict(np.load(root / f"inputs-{wkey}.npz"))
        whole = params_from_reference(_unflat(dict(np.load(root / f"params-{wkey}.npz"))), "cpu")
        params = train.shard_state(mesh, whole, specs)
        tokens = torch.from_numpy(inp["tokens"])
        with torch.no_grad():
            lg = (model.logits_mm(params, tokens, torch.from_numpy(inp["vis"])) if vlm
                  else model.logits(params, tokens))
        if rank == 0:
            out[f"{name}/logits"] = lg.numpy()
        ocfg = adamw.AdamWConfig(lr=LR, warmup_steps=1)
        opt = adamw.init(params, ocfg)
        step = build_train_step(model, mesh, ocfg, cell=ShapeCell("t", SEQ, BATCH, "train"),
                                sync_mode=mode).fn
        data = TokenPipeline(DataConfig(vocab=model.cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                                        seed=SEED), mesh)
        rows = TokenPipeline._rows(BATCH, mesh)
        losses, norms = [], []
        try:
            for i in range(STEPS):
                batch = next(data)
                if vlm:
                    batch["vis_embed"] = torch.from_numpy(inp["train_vis"][rows])
                if i == 0:
                    loss, grads = _value_and_grad(model, params, batch)
                    if shape[0] * shape[1] > 1:                  # pod x data
                        grads = batch_mean(loss, grads, mesh, zero_leaves(model, mesh))[1]
                    for key, t in _flat(gather_params(grads, mesh, specs)).items():
                        if rank == 0:
                            out[f"{name}/grad/{key}"] = t.numpy().copy()
                params, opt, stats = step(params, opt, batch)
                losses.append(float(stats["loss"]))
                norms.append(float(stats["grad_norm"]))
                full = _flat(gather_params(params, mesh, specs)) if i == 0 else {}
                for key, t in _flat(params).items():
                    out[f"block/{name}/{i}/{key}"] = t.numpy().copy()    # every rank's own
                    if rank == 0 and i == 0:
                        out[f"{name}/{i}/{key}"] = full[key].numpy().copy()
        finally:
            data.close()
        meta[name] = {"losses": losses, "grad_norms": norms, "cut": cut_of(mesh, specs),
                      "whole": sorted(k for k, s in _flat(specs).items() if not model_dims(s))}
    # the blocks of a whole tensor, and the long-sequence paths under remat
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    for shape in SHARD_MESHES:
        mesh = make_mesh(shape, AXES, device="cpu")
        for spec in (P(None, "model"), P(("pod", "data"), "model"), P("model", None),
                     P("data", None)):
            block = shard(mesh, x, spec)
            out[f"shard/{shape}/{spec!r}"] = block.numpy().copy()
            out[f"gather/{shape}/{spec!r}"] = gather(mesh, block, spec).numpy()
    mesh = make_mesh((1, 1, 4), AXES, device="cpu")
    model = train.rebuild(treg.build_model("gemma-2b", mesh, smoke=True),
                          dataclasses.replace(treg.get_config("gemma-2b", smoke=True), remat="full"))
    whole = params_from_reference(_unflat(dict(np.load(root / "params-gemma-2b.npz"))), "cpu")
    specs = model.param_specs(mesh)
    tokens = torch.from_numpy(np.load(root / "long_tokens.npy"))
    loss, grads = _value_and_grad(model, train.shard_state(mesh, whole, specs), {"tokens": tokens})
    meta["long_loss"] = float(loss)
    for key, t in _flat(gather_params(grads, mesh, specs)).items():     # every rank gathers
        if rank == 0:
            out[f"long/{key}"] = t.numpy()
    ck = root / "elastic"
    meta["launch"] = train.main(ELASTIC_ARGS + ["--mesh", "2x2", "--steps", "5",
                                                "--ckpt-dir", str(ck), "--ckpt-every", "3"])["losses"]
    meta["not_contiguous"] = loose
    np.savez(root / f"port{rank}.npz", **out)
    (root / f"port{rank}.json").write_text(json.dumps(meta))


def _port_elastic(rank, root):
    from repro_torch.launch import train

    losses = train.main(ELASTIC_ARGS + ["--mesh", "1x2", "--steps", "5",
                                        "--ckpt-dir", str(root / "elastic")])["losses"]
    (root / f"elastic{rank}.json").write_text(json.dumps(losses))


@pytest.fixture(scope="module")
def port(root, reference_started):
    spawn_world(_port_tp, 4, (root,), root, timeout=240)
    arrays = [dict(np.load(root / f"port{r}.npz")) for r in range(4)]
    meta = [json.loads((root / f"port{r}.json").read_text()) for r in range(4)]
    return arrays, meta


@pytest.fixture(scope="module")
def elastic(port, root):
    spawn_world(_port_elastic, 2, (root,), root, timeout=90)
    return [json.loads((root / f"elastic{r}.json").read_text()) for r in range(2)]


@pytest.fixture(scope="module")
def reference(port, root, reference_started):
    finish_multidevice(reference_started, root / "ref.log", 420, "REFERENCE_OK")
    return dict(np.load(root / "ref.npz")), json.loads((root / "ref.json").read_text())


# ---------------------------------------------------------------------------
# the tests (the port's world first, so no test waits for both)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["gemma-2b", "internvl2-2b", "mistral-nemo-12b", "yi-34b"])
@pytest.mark.parametrize("shape", [(1, 2, 2), (1, 1, 4)])
def test_param_specs_equal_the_reference(arch, shape):
    """``param_specs`` names the reference's mesh axes for every dim of every
    leaf (a dim that ``model`` does not divide stays whole in both)."""
    from repro.configs import registry as jreg

    from repro_torch.configs import registry as treg
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.optim import adamw

    port_mesh = Mesh(dict(zip(AXES, shape)), (torch.device("cpu"),))
    ref_mesh = types.SimpleNamespace(shape=dict(zip(AXES, shape)), axis_names=AXES)
    got = _flat(treg.build_model(arch, smoke=True).param_specs(port_mesh))
    want = _flat(jreg.build_model(arch, smoke=True).param_specs(ref_mesh))
    assert sorted(got) == sorted(want)
    for key in want:
        assert tuple(got[key]) == tuple(want[key]), key
    assert adamw.state_specs(got).m is got and tuple(adamw.state_specs(got).step) == ()
    got = _flat(treg.build_model(arch, smoke=True).param_specs(port_mesh, serve=True))
    want = _flat(jreg.build_model(arch, smoke=True).param_specs(ref_mesh, serve=True))
    assert sorted(got) == sorted(want)
    for key in want:
        assert tuple(got[key]) == tuple(want[key]), ("serve", key)


def test_the_mesh_lays_ranks_out_row_major(port):
    """Rank r of (p, d, m) is p*D*M + d*M + m on every mesh, as
    ``jax.make_mesh`` lays devices out."""
    for r, meta in enumerate(port[1]):
        for (arch, shape, mode, vocab), name in zip(CASES, NAMES):
            P_, D, M = shape
            assert meta["mesh"][name] == {"pod": r // (D * M), "data": r // M % D,
                                          "model": r % M}


@pytest.mark.parametrize("name", NAMES)
def test_logits_match_the_reference(name, port, reference):
    got, want = port[0][0][f"{name}/logits"], reference[0][f"{name}/logits"]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= LOGITS_RTOL * np.abs(want).max()


@pytest.mark.parametrize("name", NAMES)
def test_step1_gradients_match_the_reference(name, port, reference):
    """Step 1's gradients, meaned over pod x data and gathered over
    ``model``, leaf by leaf within GRAD_RTOL of the norm of the reference's
    (f32, the two packages' summation orders)."""
    got = {k: v for k, v in port[0][0].items() if k.startswith(f"{name}/grad/")}
    want = {k: v for k, v in reference[0].items() if k.startswith(f"{name}/grad/")}
    assert got and sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        assert np.linalg.norm(got[k] - w) <= GRAD_RTOL * np.linalg.norm(w), k


@pytest.mark.parametrize("name", NAMES)
def test_train_steps_match_the_reference(name, port, reference, root):
    """Losses of every step and step 1's grad norm within LOSS_RTOL; the
    whole params after step 1 within UPDATE_RTOL of the norm of the
    reference's update over the elements whose AdamW denominator sqrt(v̂)
    is at least ``SETTLED``, and the others within 2·lr."""
    arrays, meta = port
    ref_arrays, ref_meta = reference
    np.testing.assert_allclose(meta[0][name]["losses"], ref_meta[name]["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(meta[0][name]["grad_norms"][0], ref_meta[name]["grad_norms"][0],
                               rtol=LOSS_RTOL)
    arch, _s, _m, vocab = CASES[NAMES.index(name)]
    init = dict(np.load(root / f"params-{_weights_key(arch, vocab)}.npz"))
    keys = sorted(k for k in ref_arrays if k.startswith(f"{name}/0/"))
    assert keys and keys == sorted(k for k in arrays[0] if k.startswith(f"{name}/0/"))
    for k in keys:
        leaf = k.split("/", 2)[2]
        got, want = arrays[0][k].astype(np.float64), ref_arrays[k].astype(np.float64)
        assert got.shape == want.shape, k
        settled = np.sqrt(ref_arrays[f"{name}/v0/{leaf}"] / (1.0 - ADAM_B2)) >= SETTLED
        update = np.linalg.norm((want - init[leaf])[settled])
        assert update > 0, k
        assert np.linalg.norm((got - want)[settled]) <= UPDATE_RTOL * update, k
        assert np.all(np.abs(got - want)[~settled] <= 2 * LR), k


@pytest.mark.parametrize("name", NAMES)
def test_every_model_rank_has_the_same_losses_and_whole_leaves(name, port):
    """Every rank reports the same losses and grad norms, and every leaf is
    bit-equal after every step on the ranks that hold the same block of it
    (all four ranks for a leaf no axis cuts; over a ``data`` axis ZeRO cuts
    every weight's ``d_model`` dim): the operators sum each partial
    gradient of a leaf whole over ``model`` over the group, so no rank's
    copy drifts."""
    arrays, meta = port
    whole = meta[0][name]["whole"]
    assert {"final_norm", "blocks/0/ln1", "blocks/0/ln2"} <= set(whole)
    if name.startswith("gemma-2b"):          # one kv head: whole on every mesh
        assert {"blocks/0/wk", "blocks/0/wv"} <= set(whole)
    if name.endswith(f"v{ODD_VOCAB}"):
        assert "embed" in whole and ("unembed" in whole or name.startswith("gemma-2b"))
    coords = [m["mesh"][name] for m in meta]
    for r in range(1, 4):
        assert meta[r][name]["losses"] == meta[0][name]["losses"]
        assert meta[r][name]["grad_norms"] == meta[0][name]["grad_norms"]
    for i in range(STEPS):
        assert_blocks_agree(arrays, coords, meta[0][name]["cut"], f"block/{name}/{i}/")


@pytest.mark.parametrize("spec", ["P(None, 'model')", "P(('pod', 'data'), 'model')",
                                  "P('model', None)", "P('data', None)"])
def test_shard_cuts_this_ranks_block_and_gather_undoes_it(spec, port):
    """``shard`` keeps this rank's block of each dim whose entry names mesh
    axes, row-major over the axes of a tuple entry, as ``jax.device_put``
    under ``NamedSharding`` cuts it (on (1, 1, 4) and on (2, 2, 1), where
    ``('pod', 'data')`` cuts over all four ranks); ``gather`` puts the
    whole back."""
    x = np.arange(8 * 12, dtype=np.float32).reshape(8, 12)
    entries = eval(spec, {"P": lambda *e: e})
    for shape in SHARD_MESHES:
        for r, arrays in enumerate(port[0]):
            coords = dict(zip(AXES, np.unravel_index(r, shape)))
            want = x
            for d, e in enumerate(entries):
                axes = () if e is None else (e if isinstance(e, tuple) else (e,))
                n = int(np.prod([shape[AXES.index(a)] for a in axes]))
                idx = 0
                for a in axes:
                    idx = idx * shape[AXES.index(a)] + int(coords[a])
                size = x.shape[d] // n
                want = np.take(want, range(idx * size, (idx + 1) * size), axis=d)
            assert arrays[f"shard/{shape}/{spec}"].tobytes() == want.tobytes(), (shape, r)
            assert arrays[f"gather/{shape}/{spec}"].tobytes() == x.tobytes()


def test_long_sequences_under_remat_match_one_device(port, root):
    """gemma-2b's smoke config under ``remat="full"`` on (1, 1, 4), 1100
    positions: the blocked attention over this rank's heads and the
    vocab-parallel cross-entropy over three sequence chunks, each recomputed
    in the backward pass with its collectives. The loss within LOSS_RTOL and
    each gathered gradient within GRAD_RTOL of the port's one-device step on
    the same weights (itself held to the reference in
    ``test_torch_models``)."""
    from repro_torch.configs import registry as treg
    from repro_torch.convert import params_from_reference
    from repro_torch.launch import train
    from repro_torch.launch.steps import _value_and_grad

    model = train.rebuild(treg.build_model("gemma-2b", smoke=True),
                          dataclasses.replace(treg.get_config("gemma-2b", smoke=True), remat="full"))
    whole = params_from_reference(_unflat(dict(np.load(root / "params-gemma-2b.npz"))), "cpu")
    tokens = torch.from_numpy(np.load(root / "long_tokens.npy"))
    loss, grads = _value_and_grad(model, whole, {"tokens": tokens})
    arrays, meta = port
    for m in meta:
        np.testing.assert_allclose(m["long_loss"], float(loss), rtol=LOSS_RTOL)
    for key, g in _flat(grads).items():
        got = arrays[0][f"long/{key}"]
        assert got.shape == tuple(g.shape), key
        assert np.linalg.norm(got - g.numpy()) <= GRAD_RTOL * np.linalg.norm(g.numpy()), key


@pytest.mark.parametrize("names", [("batch", "seq", "embed"), ("fsdp", "ffn"), ("vocab", "fsdp"),
                                   ("heads", None, "kv_heads"), ("experts", "expert_ffn"),
                                   ("state", "conv", "head_dim")])
def test_spec_and_batch_spec_equal_the_reference(names):
    from repro.distributed import mesh as jmesh

    from repro_torch.distributed import mesh as tmesh
    assert tuple(tmesh.spec(*names)) == tuple(jmesh.spec(*names))
    for axes in (AXES, ("data", "model")):
        tm = tmesh.Mesh(dict.fromkeys(axes, 1), (torch.device("cpu"),))
        jm = types.SimpleNamespace(axis_names=axes)
        for seq in (False, True):
            assert tuple(tmesh.batch_spec(tm, seq_sharded=seq)) == \
                tuple(jmesh.batch_spec(jm, seq_sharded=seq))


@pytest.mark.parametrize("axes", [AXES, ("data", "model"), ("model",)])
@pytest.mark.parametrize("exclude_pod", [False, True])
def test_batch_axes_and_shardable_equal_the_reference(axes, exclude_pod):
    from repro.models import common as jcm

    from repro_torch.models import common as tcm
    mesh = types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, (2, 2, 4)[-len(axes):])))
    assert tcm.batch_axes(mesh, exclude_pod) == jcm.batch_axes(mesh, exclude_pod)
    for size in (1, 2, 6, 8, 127):
        for axis in ("pod", "data", "model"):
            assert tcm.shardable(size, axis, mesh) == jcm.shardable(size, axis, mesh)


def test_every_tensor_sent_is_contiguous(port):
    for meta in port[1]:
        assert meta["not_contiguous"] == []


def test_elastic_resume_over_data_x_model(port, elastic, root, tmp_path):
    """``--mesh 2x2`` saves at step 3 and runs to 5; ``1x2`` on two ranks
    resumes step 3 with the same losses of steps 4-5. The root's MANIFEST
    names the leaves, shapes, dtypes and chunks of a one-device run's, and
    step 1's loss is the one-device run's."""
    from repro_torch.launch import train

    launch = port[1][0]["launch"]
    for meta in port[1]:
        assert meta["launch"] == launch and len(launch) == 5 and np.all(np.isfinite(launch))
    for losses in elastic:
        assert len(losses) == 2
        np.testing.assert_allclose(losses, launch[3:], rtol=LOSS_RTOL)
    one = train.main(ELASTIC_ARGS + ["--mesh", "1x1", "--steps", "3", "--ckpt-dir", str(tmp_path),
                                     "--ckpt-every", "3"])["losses"]
    np.testing.assert_allclose(launch[0], one[0], rtol=LOSS_RTOL)

    def layout(path):
        with open(path / "step_00000003" / "MANIFEST.json") as fh:
            leaves = json.load(fh)["leaves"]
        return {k: ({f: e[f] for f in ("shape", "dtype", "nbytes", "file", "chunk_bytes")},
                    [(c["offset"], c["length"]) for c in e["chunks"]]) for k, e in leaves.items()}

    assert layout(root / "elastic") == layout(tmp_path)
