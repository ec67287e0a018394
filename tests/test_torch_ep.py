"""The port's expert parallelism (the MoE over a ``model`` axis) against the
reference's, on four CPU ranks.

qwen3-moe-30b-a3b's smoke config (8 experts, top-2) and grok-1-314b's (2
experts, top-2) on (1, 2, 2) and (1, 1, 4) pod x data x model meshes under
"auto": E_loc 4 / 2 for qwen3-moe, and for grok-1 one expert a column on 2
columns and SPLIT 2 on 4 (each column an F/2 slice of one expert). Two more
qwen3-moe cases on (1, 1, 4): one scales expert 0's router column by 8 at
capacity factor 1, so that every column sends expert 0 more rows than its
capacity and drops some; one at ``NO_DROP_CF``, where no column can drop.
The port runs in one world of four gloo ranks
(``test_torch_collectives.spawn_world``), each rank on its blocks of the
reference's weights at the same tp (``test_torch_models.seeded_params``,
crossed over with ``convert.params_from_reference``, then
``launch.train.shard_state``); the reference runs the same cases on four
fake devices in one subprocess, started before the port's world so the two
overlap. The sequences are 31 and 15 positions long, which no model axis
over 1 divides: the reference then takes the slice / all-gather bracket,
the port's only path (at a length that tp divides it takes a
sequence-sharded fast path that gives each column other tokens, pinned by
``test_the_reference_fast_path_routes_other_tokens_on_each_column``).
Held, case by case:

  * ``MoELM.param_specs`` equal to the reference's, entry for entry;
  * the logits of two sequences, each data shard's rows (the reference's
    ``shard_map`` routes each data shard's rows with their own capacity),
    within ``LOGITS_RTOL`` of the largest logit;
  * step 1's gradients, meaned over pod x data and gathered over
    ``model``, within ``GRAD_RTOL`` of each leaf's norm;
  * three train steps' losses and step 1's grad norm within ``LOSS_RTOL``;
  * every leaf bit-equal after every step on the ranks that hold the same
    block of it: every rank for a leaf no axis cuts, and over a ``data``
    axis the ranks of one ZeRO block (every weight's ``d_model`` dim is cut
    over ``data``; the router, the kv heads that four columns do not
    divide, and the norms stay whole over ``model``);
  * every tensor handed to ``torch.distributed`` contiguous, as NCCL needs
    (the all-to-alls' buffers included).

On (1, 1, 4), where nothing is dropped, the port's loss and gradients are
also held within ``SELF_RTOL`` (1e-5) of its own one-device run on the same
weights, laid out for one column by the relayout law (``to_one_column``).

Then ``launch.train.main`` on the qwen3-moe smoke config: ``--mesh 2x2``
(data x model) saves at step 3 and runs to 5, a world of two resumes that
root on ``1x2`` with the same losses, and its MANIFEST names the leaves,
shapes, dtypes and chunks of the reference's at tp 2. A whole expert
leaf's shape depends on tp, so neither package restores the root onto
another model size: on 4 columns both raise ``ValueError`` at the restore
(dim 1 of 2 does not split over 4), on one column ``ValueError`` at the
first step (weights of 4 experts a column where one column holds 8).
JAX is imported only in the reference's subprocess and in the in-process
tests.
"""
import json
import shutil
import types

import numpy as np
import pytest
import torch

from test_torch_collectives import spawn_world
from test_torch_dist_train import (
    _flat, _require_contiguous, _unflat, assert_blocks_agree, cut_of, finish_multidevice,
    start_multidevice)

LOSS_RTOL = 1e-4
GRAD_RTOL = LOSS_RTOL              # of a leaf's gradient norm: f32, summation order only
LOGITS_RTOL = 2e-5                 # of the largest logit
SELF_RTOL = 1e-5                   # (1, 1, 4) against the port's own one-device run
# odd lengths (31 positions a sequence, 15 for the logits): the reference takes the
# slice / all-gather bracket, the port's only path, whenever tp does not divide the
# sequence (else its sequence-sharded fast path routes other tokens on each column)
STEPS, LR, SEQ, BATCH, SEED = 3, 1e-2, 31, 8, 3
EVEN_SEQ = 32                      # the fast path's case: qwen3-moe on (1, 1, 4) only
AXES = ("pod", "data", "model")
MOE = ("qwen3-moe-30b-a3b", "grok-1-314b")
HOT_CF = 1.0                       # the drops case: expert 0's router column x 8 at cf 1
CASES = [(arch, shape, 2.0, False) for arch in MOE for shape in ((1, 2, 2), (1, 1, 4))]
NO_DROP_CF = 4.0                   # C = T_sub on 4 columns: no column can overflow an expert
CASES += [("qwen3-moe-30b-a3b", (1, 1, 4), HOT_CF, True),
          ("qwen3-moe-30b-a3b", (1, 1, 4), NO_DROP_CF, False)]
LAUNCH_ARGS = ["--arch", "qwen3-moe-30b-a3b", "--smoke", "--seq-len", "32", "--global-batch", "4",
               "--log-every", "0", "--lr", "3e-3", "--seed", "1"]


def _name(arch, shape, cf, hot):
    tag = "-hot" if hot else (f"-cf{cf:g}" if cf != 2.0 else "")
    return f"{arch}-{'x'.join(map(str, shape))}{tag}"


def _weights_key(arch, shape, hot):
    return f"{arch}-tp{shape[2]}" + ("-hot" if hot else "")


NAMES = [_name(*c) for c in CASES]
EVEN = _name("qwen3-moe-30b-a3b", (1, 1, 4), 2.0, False)


def _even_tokens() -> torch.Tensor:
    """Step 1's inputs at EVEN_SEQ positions, which four columns divide."""
    from repro_torch.data.pipeline import DataConfig, _batch_at

    return torch.from_numpy(np.asarray(_batch_at(DataConfig(
        vocab=128, seq_len=EVEN_SEQ, global_batch=BATCH, seed=SEED), 0)))[:, :-1]


def to_one_column(flat: dict, cfg, tp: int) -> dict:
    """A flat tree (numpy) laid out for ``tp`` columns, laid out for one:
    with SPLIT 1 each expert leaf ``(nb, tp, E_loc, ...)`` reshapes to
    ``(nb, 1, E, ...)`` (expert g·E_loc + el); with SPLIT > 1 column
    e·SPLIT + h holds F-slice h of expert e, so ``we_g`` / ``we_i`` go
    ``(nb, E, SPLIT, D, fs)`` → ``(nb, 1, E, D, F)`` and ``we_o``
    ``(nb, E, SPLIT, fs, D)`` → ``(nb, 1, E, F, D)``."""
    from repro_torch.models.moe import expert_layout

    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff
    _e_loc, split, _ = expert_layout(cfg, tp)
    out = {}
    for key, a in flat.items():
        leaf = key.rsplit("/", 1)[-1]
        nb = a.shape[0]
        if leaf in ("we_g", "we_i"):
            a = a.reshape(nb, E, split, D, Fd // split).transpose(0, 1, 3, 2, 4)
            a = a.reshape(nb, 1, E, D, Fd)
        elif leaf == "we_o":
            a = a.reshape(nb, 1, E, Fd, D)
        out[key] = np.ascontiguousarray(a)
    return out


def _hot(flat: dict) -> dict:
    """Expert 0's column of every router scaled by 8."""
    flat = dict(flat)
    for key in [k for k in flat if k.endswith("/router")]:
        flat[key] = flat[key].copy()
        flat[key][..., 0] *= 8.0
    return flat


# ---------------------------------------------------------------------------
# the inputs: seeded reference weights at each tp, logit inputs
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def root(tmp_path_factory):
    from repro.configs import registry as jreg
    from test_torch_models import seeded_params

    path = tmp_path_factory.mktemp("ep")
    for arch, shape, _cf, hot in CASES:
        jm = jreg.build_model(arch, smoke=True)
        jm.tp = shape[2]
        flat = _flat(seeded_params(jm, 0))
        np.savez(path / f"params-{_weights_key(arch, shape, hot)}.npz",
                 **(_hot(flat) if hot else flat))
    np.save(path / "tokens.npy",
            np.random.default_rng(7).integers(0, 128, (2, 15)).astype(np.int32))
    return path


# ---------------------------------------------------------------------------
# the reference: the same cases on four fake devices, in the background
# ---------------------------------------------------------------------------
REFERENCE = """
import json, shutil
import numpy as np, jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.registry import build_model, ShapeCell
from repro.data.pipeline import DataConfig, _batch_at
from repro.distributed.mesh import make_mesh
from repro.launch import train
from repro.launch.steps import build_train_step
from repro.optim import adamw

root, CASES, STEPS, LR, SEQ, BATCH, SEED, launch_args, EVEN, EVEN_SEQ = ARGS
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

tokens = np.load(f"{root}/tokens.npy")
for arch, shape, cf, name, wkey in CASES:
    mesh = make_mesh(tuple(shape), ("pod", "data", "model"), devices=jax.devices()[:4])
    model = build_model(arch, mesh, smoke=True, cf=cf)
    ocfg = adamw.AdamWConfig(lr=LR, warmup_steps=1)
    b = build_train_step(model, mesh, ocfg, cell=ShapeCell("t", SEQ, BATCH, "train"))
    with mesh:
        pspecs = model.param_specs(mesh)
        params = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                              unflat(dict(np.load(f"{root}/params-{wkey}.npz"))), pspecs)
        out[f"{name}/logits"] = np.asarray(jax.jit(model.logits)(params, tokens))
        if name == EVEN:
            tok = _batch_at(DataConfig(vocab=model.cfg.vocab, seq_len=EVEN_SEQ,
                                       global_batch=BATCH, seed=SEED), 0)[:, :-1]
            out[f"{name}/logits_even"] = np.asarray(jax.jit(model.logits)(params, tok))
        step = jax.jit(b.fn, in_shardings=b.in_shardings, out_shardings=b.out_shardings)
        opt = adamw.init(params, ocfg)
        bsh = NamedSharding(mesh, P(("pod", "data"), None))
        losses, norms = [], []
        for i in range(STEPS):
            tok = _batch_at(DataConfig(vocab=model.cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                                       seed=SEED), i)
            batch = {"tokens": jax.device_put(tok, bsh)}
            if i == 0:
                grads = jax.jit(jax.grad(model.loss))(params, batch)
                for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
                    out[f"{name}/grad/" + "/".join(p.key for p in path)] = np.asarray(leaf)
            params, opt, stats = step(params, opt, batch)
            losses.append(float(stats["loss"]))
            norms.append(float(stats["grad_norm"]))
    meta[name] = {"losses": losses, "grad_norms": norms}

# the launcher: a root saved on data x model, restored on a model axis of 4
ck = f"{root}/ref_launch"
train.main(launch_args + ["--mesh", "2x2", "--steps", "3", "--ckpt-dir", ck, "--ckpt-every", "3"])
meta["manifest"] = json.load(open(f"{ck}/step_00000003/MANIFEST.json"))
shutil.copytree(ck, f"{ck}_1x4")
try:
    train.main(launch_args + ["--mesh", "1x4", "--steps", "4", "--ckpt-dir", f"{ck}_1x4"])
    meta["resize"] = None
except Exception as e:
    meta["resize"] = [type(e).__name__, str(e)]
np.savez(root + "/ref.npz", **out)
json.dump(meta, open(root + "/ref.json", "w"))
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def reference_started(root):
    cases = [(a, list(s), cf, _name(a, s, cf, hot), _weights_key(a, s, hot))
             for a, s, cf, hot in CASES]
    code = REFERENCE.replace("ARGS", repr((str(root), cases, STEPS, LR, SEQ, BATCH, SEED,
                                           LAUNCH_ARGS, EVEN, EVEN_SEQ)))
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
def _port_ep(rank, root):
    import torch.distributed as dist

    from repro_torch.configs import registry as treg
    from repro_torch.convert import gather_params, params_from_reference
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.distributed.mesh import make_mesh, model_dims
    from repro_torch.launch import train
    from repro_torch.launch.steps import (
        _value_and_grad, batch_mean, build_train_step, zero_leaves)
    from repro_torch.configs.registry import ShapeCell
    from repro_torch.models.moe import capacity
    from repro_torch.optim import adamw

    loose = _require_contiguous(dist)
    out, meta = {}, {"mesh": {}}
    tokens = torch.from_numpy(np.load(root / "tokens.npy"))
    for arch, shape, cf, hot in CASES:
        name = _name(arch, shape, cf, hot)
        mesh = make_mesh(shape, AXES, device="cpu")
        meta["mesh"][name] = {a: mesh.rank(a) for a in AXES}
        model = treg.build_model(arch, mesh, smoke=True, cf=cf)
        specs = model.param_specs(mesh)
        whole = params_from_reference(
            _unflat(dict(np.load(root / f"params-{_weights_key(arch, shape, hot)}.npz"))), "cpu")
        params = train.shard_state(mesh, whole, specs)
        with torch.no_grad():      # this data shard's rows, as the reference routes them
            out[f"{name}/logits"] = model.logits(
                params, tokens[TokenPipeline._rows(tokens.shape[0], mesh)]).numpy()
            if name == EVEN:
                out[f"{name}/logits_even"] = model.logits(params, _even_tokens()).numpy()
        ocfg = adamw.AdamWConfig(lr=LR, warmup_steps=1)
        opt = adamw.init(params, ocfg)
        step = build_train_step(model, mesh, ocfg, cell=ShapeCell("t", SEQ, BATCH, "train")).fn
        data = TokenPipeline(DataConfig(vocab=model.cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                                        seed=SEED), mesh)
        losses, norms = [], []
        try:
            for i in range(STEPS):
                batch = next(data)
                if i == 0:
                    model.route_log = []
                    loss, grads = _value_and_grad(model, params, batch)
                    t_sub = batch["tokens"][:, 1:].numel() // shape[2]
                    C = capacity(t_sub, model.cfg, shape[2], cf)
                    k, E = model.cfg.top_k, model.cfg.n_experts
                    meta[f"{name}/dropped"] = sum(
                        int(torch.clamp(torch.bincount(torch.topk(p, k).indices.reshape(-1),
                                                       minlength=E) - C, min=0).sum())
                        for p in model.route_log)
                    model.route_log = None
                    if shape[0] * shape[1] > 1:                  # pod x data
                        loss, grads = batch_mean(loss, grads, mesh, zero_leaves(model, mesh))
                    meta[f"{name}/loss0"] = float(loss)
                    for key, t in _flat(gather_params(grads, mesh, specs)).items():
                        if rank == 0:
                            out[f"{name}/grad/{key}"] = t.numpy().copy()
                params, opt, stats = step(params, opt, batch)
                losses.append(float(stats["loss"]))
                norms.append(float(stats["grad_norm"]))
                for key, t in _flat(params).items():
                    out[f"{name}/{i}/{key}"] = t.numpy().copy()          # every rank's own
        finally:
            data.close()
        meta[name] = {"losses": losses, "grad_norms": norms, "cut": cut_of(mesh, specs),
                      "whole": sorted(k for k, s in _flat(specs).items() if not model_dims(s))}
    # the launcher on data x model, then a restore onto another model size
    ck = root / "launch"
    meta["launch"] = train.main(LAUNCH_ARGS + [
        "--device", "cpu", "--mesh", "2x2", "--steps", "5", "--ckpt-dir", str(ck),
        "--ckpt-every", "3"])["losses"]
    if rank == 0:
        shutil.copytree(ck, root / "launch_1x4")
    dist.barrier()
    try:
        train.main(LAUNCH_ARGS + ["--device", "cpu", "--mesh", "1x4", "--steps", "4",
                                  "--ckpt-dir", str(root / "launch_1x4")])
        meta["resize"] = None
    except Exception as e:        # every rank raises at its restore, before any collective
        meta["resize"] = [type(e).__name__, str(e)]
    meta["not_contiguous"] = loose
    np.savez(root / f"port{rank}.npz", **out)
    (root / f"port{rank}.json").write_text(json.dumps(meta))


def _port_elastic(rank, root):
    from repro_torch.launch import train

    losses = train.main(LAUNCH_ARGS + ["--device", "cpu", "--mesh", "1x2", "--steps", "5",
                                       "--ckpt-dir", str(root / "launch")])["losses"]
    (root / f"elastic{rank}.json").write_text(json.dumps(losses))


@pytest.fixture(scope="module")
def port(root, reference_started):
    spawn_world(_port_ep, 4, (root,), root, timeout=240)
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


def _port_logits(port, name):
    """The port's logits of both sequences: each data shard's rows from its
    model rank 0."""
    arrays, meta = port
    shards = sorted((m["mesh"][name]["data"], r) for r, m in enumerate(meta)
                    if m["mesh"][name]["model"] == 0)
    return np.concatenate([arrays[r][f"{name}/logits"] for _d, r in shards])


# ---------------------------------------------------------------------------
# the tests (the port's world first, so no test waits for both)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("shape", [(1, 2, 2), (1, 1, 4)])
def test_param_specs_equal_the_reference(arch, shape):
    """``MoELM.param_specs``: the experts' column dim over ``model``, the
    router whole, the attention's entries the dense family's."""
    from repro.configs import registry as jreg

    from repro_torch.configs import registry as treg
    from repro_torch.distributed.mesh import Mesh

    port_mesh = Mesh(dict(zip(AXES, shape)), (torch.device("cpu"),))
    ref_mesh = types.SimpleNamespace(shape=dict(zip(AXES, shape)), axis_names=AXES)
    got = _flat(treg.build_model(arch, smoke=True).param_specs(port_mesh))
    want = _flat(jreg.build_model(arch, smoke=True).param_specs(ref_mesh))
    assert sorted(got) == sorted(want)
    for key in want:
        assert tuple(got[key]) == tuple(want[key]), key
    assert tuple(got["blocks/0/we_g"])[:3] == (None, "model", None)
    assert "model" not in tuple(got["blocks/0/router"])


@pytest.mark.parametrize("name", NAMES)
def test_logits_match_the_reference(name, port, reference):
    got, want = _port_logits(port, name), reference[0][f"{name}/logits"]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= LOGITS_RTOL * np.abs(want).max()


@pytest.mark.parametrize("name", NAMES)
def test_step1_gradients_match_the_reference(name, port, reference):
    """Step 1's gradients, meaned over pod x data and gathered over
    ``model``, leaf by leaf within GRAD_RTOL of the norm of the reference's:
    the experts' through both all-to-alls, the router's and the normed
    residual's summed over ``model``."""
    got = {k: v for k, v in port[0][0].items() if k.startswith(f"{name}/grad/")}
    want = {k: v for k, v in reference[0].items() if k.startswith(f"{name}/grad/")}
    assert got and sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        assert np.linalg.norm(got[k] - w) <= GRAD_RTOL * np.linalg.norm(w), k


@pytest.mark.parametrize("name", NAMES)
def test_train_steps_match_the_reference(name, port, reference):
    meta, ref_meta = port[1], reference[1]
    np.testing.assert_allclose(meta[0][name]["losses"], ref_meta[name]["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(meta[0][name]["grad_norms"][0], ref_meta[name]["grad_norms"][0],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", NAMES)
def test_every_model_rank_has_the_same_losses_and_whole_leaves(name, port):
    """Every rank reports the same losses and grad norms, and every leaf is
    bit-equal after every step on the ranks that hold the same block of it
    (on all four ranks for a leaf no axis cuts; over a ``data`` axis ZeRO
    cuts every weight's ``d_model`` dim, the router's too): the router's
    and the normed residual's partial gradients are summed over ``model``,
    so no rank's copy drifts."""
    arrays, meta = port
    whole = meta[0][name]["whole"]
    assert {"blocks/0/router", "blocks/0/ln2", "final_norm"} <= set(whole)
    assert not {"blocks/0/we_g", "blocks/0/we_i", "blocks/0/we_o"} & set(whole)
    coords = [m["mesh"][name] for m in meta]
    for r in range(1, 4):
        assert meta[r][name]["losses"] == meta[0][name]["losses"]
        assert meta[r][name]["grad_norms"] == meta[0][name]["grad_norms"]
    for i in range(STEPS):
        assert_blocks_agree(arrays, coords, meta[0][name]["cut"], f"{name}/{i}/")


def test_the_hot_case_drops_assignments(port):
    """The drops case overflows expert 0's capacity on every column (the
    other cases are held with whatever they drop)."""
    name = _name("qwen3-moe-30b-a3b", (1, 1, 4), HOT_CF, True)
    assert all(m[f"{name}/dropped"] > 0 for m in port[1])


@pytest.mark.parametrize("name", [_name("qwen3-moe-30b-a3b", (1, 1, 4), NO_DROP_CF, False),
                                  _name("grok-1-314b", (1, 1, 4), 2.0, False)])
def test_one_data_shard_matches_the_ports_one_device_run(name, port, root):
    """On (1, 1, 4) the four columns together route one data shard's tokens,
    as one device does: the loss within SELF_RTOL and each gathered
    gradient, laid out for one column (``to_one_column``), within SELF_RTOL
    of its norm, against the port's one-device run on the same weights.
    Only where nothing is dropped: a column's capacity is not one device's,
    so at cf 2 qwen3-moe's columns drop assignments that one device keeps;
    at ``NO_DROP_CF`` each column's C is its token count, and grok-1's two
    experts take every token at any cf."""
    from repro_torch.configs import registry as treg
    from repro_torch.convert import params_from_reference
    from repro_torch.data.pipeline import DataConfig, _batch_at
    from repro_torch.launch.steps import _value_and_grad

    arch, shape, cf, hot = CASES[NAMES.index(name)]
    model = treg.build_model(arch, smoke=True, cf=cf)
    flat = dict(np.load(root / f"params-{_weights_key(arch, shape, hot)}.npz"))
    params = params_from_reference(_unflat(to_one_column(flat, model.cfg, shape[2])), "cpu")
    tok = torch.from_numpy(np.asarray(_batch_at(DataConfig(
        vocab=model.cfg.vocab, seq_len=SEQ, global_batch=BATCH, seed=SEED), 0)))
    loss, grads = _value_and_grad(model, params, {"tokens": tok})
    arrays, meta = port
    np.testing.assert_allclose(meta[0][f"{name}/loss0"], float(loss), rtol=SELF_RTOL)
    got = to_one_column({k.split("/grad/", 1)[1]: v for k, v in arrays[0].items()
                         if k.startswith(f"{name}/grad/")}, model.cfg, shape[2])
    for key, g in _flat(grads).items():
        assert got[key].shape == tuple(g.shape), key
        w = g.numpy()
        assert np.linalg.norm(got[key] - w) <= SELF_RTOL * np.linalg.norm(w), key


def test_the_reference_fast_path_routes_other_tokens_on_each_column(port, reference, root):
    """A deliberate difference, pinned: at 32 positions, which four columns
    divide, the reference's column m routes positions 8m..8m+7 of every
    sequence (its sequence-sharded fast path), the port's column m the rows
    j ≡ m (mod 4) as at any length. On these weights the fast path's column
    0 sends expert 4 more rows than its capacity and drops the last (all in
    the last sequence), so the reference's logits leave one device's there,
    while the port's equal its one-device logits everywhere."""
    from repro_torch.configs import registry as treg
    from repro_torch.convert import params_from_reference

    model = treg.build_model("qwen3-moe-30b-a3b", smoke=True)
    flat = dict(np.load(root / f"params-{_weights_key('qwen3-moe-30b-a3b', (1, 1, 4), False)}.npz"))
    params = params_from_reference(_unflat(to_one_column(flat, model.cfg, 4)), "cpu")
    with torch.no_grad():
        one = model.logits(params, _even_tokens()).numpy()
    scale = np.abs(one).max()
    port_err = np.abs(port[0][0][f"{EVEN}/logits_even"] - one).max(-1)
    ref_err = np.abs(reference[0][f"{EVEN}/logits_even"] - one).max(-1)
    assert port_err.max() <= LOGITS_RTOL * scale
    assert ref_err[:-1].max() <= LOGITS_RTOL * scale       # every sequence but the last
    assert ref_err[-1].max() > 1e-2 * scale


def test_the_relayout_law_gives_one_columns_weights():
    """The port's own draws at tp 4 (SPLIT 1: qwen3-moe's 8 experts) are the
    one-column draws reshaped; ``to_one_column`` undoes a SPLIT 2 layout
    (grok-1's 2 experts on 4 columns) slice by slice."""
    from repro_torch.configs import registry as treg
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.models.moe import MoELM

    mesh = Mesh(dict(zip(AXES, (1, 1, 4))), (torch.device("cpu"),))
    cfg = treg.get_config("qwen3-moe-30b-a3b", smoke=True)
    four = {k: v.numpy() for k, v in _flat(MoELM(cfg, mesh).init_params(2, "cpu")).items()}
    one = _flat(MoELM(cfg).init_params(2, "cpu"))
    for key, t in to_one_column(four, cfg, 4).items():
        assert t.tobytes() == one[key].numpy().tobytes(), key
    cfg = treg.get_config("grok-1-314b", smoke=True)
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff
    a = np.arange(E * D * Fd, dtype=np.float32).reshape(1, 1, E, D, Fd)
    split = a.reshape(1, E, D, 2, Fd // 2).transpose(0, 1, 3, 2, 4).reshape(1, 4, 1, D, Fd // 2)
    assert np.array_equal(to_one_column({"b/we_g": split}, cfg, 4)["b/we_g"], a)
    assert np.array_equal(split[0, 3, 0], a[0, 0, 1, :, Fd // 2:])   # column 3: expert 1, slice 1


def test_every_tensor_sent_is_contiguous(port):
    for meta in port[1]:
        assert meta["not_contiguous"] == []


def test_elastic_resume_over_data_x_model(port, elastic, root, reference):
    """``--mesh 2x2`` saves at step 3 and runs to 5; ``1x2`` on two ranks
    resumes step 3 with the same losses of steps 4-5. The root's MANIFEST
    names the leaves, shapes, dtypes and chunks of the reference's root saved
    on 2x2."""
    launch = port[1][0]["launch"]
    for meta in port[1]:
        assert meta["launch"] == launch and len(launch) == 5 and np.all(np.isfinite(launch))
    for losses in elastic:
        assert len(losses) == 2
        np.testing.assert_allclose(losses, launch[3:], rtol=LOSS_RTOL)

    def layout(manifest):
        return {k: ({f: e[f] for f in ("shape", "dtype", "nbytes", "file", "chunk_bytes")},
                    [(c["offset"], c["length"]) for c in e["chunks"]])
                for k, e in manifest["leaves"].items()}

    with open(root / "launch" / "step_00000003" / "MANIFEST.json") as fh:
        got = layout(json.load(fh))
    assert got == layout(reference[1]["manifest"])
    assert got["params/blocks/0/we_g"][0]["shape"] == [2, 2, 4, 32, 64]     # (nb, tp, E_loc, D, F)


def test_neither_package_restores_onto_another_model_size(port, reference, root, tmp_path):
    """A root saved on 2 columns: on 4 both packages raise ``ValueError`` at
    the restore (the expert leaves' dim 1 of 2 does not split over 4); on one
    column both restore, then raise ``ValueError`` at the first step (the
    tree holds 4 experts a column where one column holds 8). No package
    lays the experts out anew."""
    import repro.launch.train as jtrain

    from repro_torch.launch import train as ttrain

    ref = reference[1]["resize"]
    assert ref[0] == "ValueError" and "should be divisible by 4, but it is equal to 2" in ref[1]
    for meta in port[1]:
        assert meta["resize"][0] == "ValueError"
        assert "does not split over 4 ranks" in meta["resize"][1]
    for pkg, run in (("port", lambda a: ttrain.main(a + ["--device", "cpu"])),
                     ("ref", jtrain.main)):
        ck = tmp_path / pkg
        shutil.copytree(root / "launch", ck)
        with pytest.raises(ValueError, match="4 experts a column, where 1 columns hold 8"
                           if pkg == "port" else r"\(8\) does not match previous terms \(4\)"):
            run(LAUNCH_ARGS + ["--mesh", "1x1", "--steps", "4", "--ckpt-dir", str(ck)])
