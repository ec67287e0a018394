"""The port's multi-rank train step and launcher against the reference's, on
four CPU ranks.

gemma-2b's smoke config on a (2, 2, 1) pod x data x model mesh: the port
in one world of four gloo ranks (``test_torch_collectives.spawn_world``),
the reference's ``build_train_step`` on four fake devices in one
subprocess (``conftest.run_multidevice``), both from the same weights
(``test_torch_models.seeded_params``, crossed over with
``convert.params_from_reference``) and the same (seed, step)-keyed
batches, each rank of the port taking its block ``p * dp + d`` of the
global batch. For ``sync_mode`` "auto", "chunked" and "chunked_bf16":

  * losses and grad norms within ``LOSS_RTOL`` (1e-4) of the reference's;
  * params after every step, leaf by leaf: the norm of the difference
    within ``UPDATE_RTOL`` (1e-3) of the norm of the reference's update
    (its params after the step less the initial ones). The two packages'
    f32 gradients differ by summation order only (XLA's and torch's
    matmuls; the data axis's all-reduce against GSPMD's), about 1e-6
    relative. AdamW divides each gradient by its own magnitude, so an
    element whose gradient is near zero can move by a sizeable part of lr
    in one package and not the other (a few elements a leaf, up to about
    1 % of a step): no elementwise bound below lr holds, while the update
    as a whole agrees to about 2e-4. "chunked_bf16" sums each pod's
    gradient rounded to bf16: where the two pods' gradients cancel, that
    rounding (2^-8 of each addend) is large against the sum, so a 1e-6
    difference between the packages' f32 gradients can change the
    compressed mean's sign. After its first step every param is within
    2·lr of the reference's (that step moves each by lr·g/(|g| + eps) and
    the same decay), and all but 1e-3 of each leaf's within 1e-3·lr; later
    steps compound the flips along a trajectory whose loss swings from
    33.6 to 35.7 to 28.5 at this lr, so only its losses are held there;
  * every rank ends with the same params, bit for bit.

Then ``launch.train.main`` itself on the four ranks (``--mesh 2x2x1``,
``--sync-mode chunked``, a checkpoint written by rank 0 at step 3, resumed
by every rank), and the elastic resume of that root on two ranks
(``--mesh 1x2x1``): the resumed losses repeat the uninterrupted run's. JAX
is imported only inside the tests that run the reference.
"""
import json

import numpy as np
import pytest
import torch

from conftest import run_multidevice
from test_torch_collectives import spawn_world

LOSS_RTOL = 1e-4
STEPS, LR, SEQ, BATCH, SEED = 3, 1e-2, 32, 8, 3
UPDATE_RTOL = 1e-3
MODES = ("auto", "chunked", "chunked_bf16")
LAUNCH_ARGS = ["--arch", "gemma-2b", "--smoke", "--seq-len", "16", "--global-batch", "8",
               "--log-every", "0", "--lr", "3e-3", "--device", "cpu", "--seed", "1"]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _unflat(flat):
    root = {}
    for key, v in flat.items():
        node = root
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The seeded reference weights of gemma-2b's smoke config, as an npz."""
    from repro.configs import registry as jreg
    from test_torch_models import seeded_params

    path = tmp_path_factory.mktemp("dist_train")
    jm = jreg.build_model("gemma-2b", smoke=True)
    np.savez(path / "params.npz", **_flat(seeded_params(jm, 0)))
    return path


# ---------------------------------------------------------------------------
# the port: four gloo ranks, then two
# ---------------------------------------------------------------------------
def _require_contiguous(dist) -> list:
    """Record every tensor this rank hands to ``torch.distributed`` that is
    not contiguous: NCCL refuses them, where gloo takes them."""
    loose = []

    def wrap(name, fn):
        def call(*args, **kw):
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            tensors += [op.tensor for a in args if isinstance(a, list) for op in a
                        if isinstance(op, dist.P2POp)]
            loose.extend(f"{name} {tuple(t.shape)} {t.stride()}" for t in tensors
                         if not t.is_contiguous())
            return fn(*args, **kw)
        return call

    for name in ("all_reduce", "broadcast", "batch_isend_irecv", "barrier"):
        setattr(dist, name, wrap(name, getattr(dist, name)))
    return loose


def _port_steps(rank, root):
    import torch.distributed as dist

    from repro_torch.configs import registry as treg
    from repro_torch.configs.registry import ShapeCell
    from repro_torch.convert import params_from_reference
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.launch import train
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import adamw

    loose = _require_contiguous(dist)
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), device="cpu")
    model = treg.build_model("gemma-2b", mesh, smoke=True)
    ref = _unflat(dict(np.load(root / "params.npz")))
    ocfg = adamw.AdamWConfig(lr=LR, warmup_steps=1)
    out, meta = {}, {"rank": {"pod": mesh.rank("pod"), "data": mesh.rank("data")}}
    for mode in MODES:
        params = params_from_reference(ref, "cpu")
        opt = adamw.init(params, ocfg)
        step = build_train_step(model, mesh, ocfg, cell=ShapeCell("t", SEQ, BATCH, "train"),
                                sync_mode=mode).fn
        data = TokenPipeline(DataConfig(vocab=model.cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                                        seed=SEED), mesh)
        losses, norms = [], []
        try:
            for i in range(STEPS):
                batch = next(data)
                if mode == "auto":
                    out[f"tokens/{i}"] = batch["tokens"].numpy()
                params, opt, stats = step(params, opt, batch)
                losses.append(float(stats["loss"]))
                norms.append(float(stats["grad_norm"]))
                for key, t in _flat(params).items():
                    out[f"{mode}/{i}/{key}"] = t.numpy().copy()
        finally:
            data.close()
        meta[mode] = {"losses": losses, "grad_norms": norms}
    root_ck = root / "ckpt"
    meta["launch"] = train.main(LAUNCH_ARGS + ["--mesh", "2x2x1", "--sync-mode", "chunked",
                                               "--steps", "5", "--ckpt-dir", str(root_ck),
                                               "--ckpt-every", "3"])["losses"]
    dist.barrier()
    if rank == 0:                      # the resume below writes no checkpoint
        meta["ckpt_steps"] = sorted(p.name for p in root_ck.iterdir())
    meta["resumed"] = train.main(LAUNCH_ARGS + ["--mesh", "2x2x1", "--sync-mode", "chunked",
                                                "--steps", "5", "--ckpt-dir", str(root_ck)])["losses"]
    meta["not_contiguous"] = loose
    np.savez(root / f"port{rank}.npz", **out)
    (root / f"port{rank}.json").write_text(json.dumps(meta))


def _port_elastic(rank, root):
    from repro_torch.launch import train

    losses = train.main(LAUNCH_ARGS + ["--mesh", "1x2x1", "--sync-mode", "chunked",
                                       "--microbatches", "2", "--steps", "5",
                                       "--ckpt-dir", str(root / "ckpt")])["losses"]
    (root / f"elastic{rank}.json").write_text(json.dumps(losses))


@pytest.fixture(scope="module")
def port(root):
    spawn_world(_port_steps, 4, (root,), root, timeout=120)
    arrays = [dict(np.load(root / f"port{r}.npz")) for r in range(4)]
    meta = [json.loads((root / f"port{r}.json").read_text()) for r in range(4)]
    return arrays, meta


@pytest.fixture(scope="module")
def elastic(port, root):
    spawn_world(_port_elastic, 2, (root,), root, timeout=90)
    return [json.loads((root / f"elastic{r}.json").read_text()) for r in range(2)]


# ---------------------------------------------------------------------------
# the reference: build_train_step on a (2, 2, 1) mesh of four fake devices
# ---------------------------------------------------------------------------
REFERENCE = """
import json, sys
import numpy as np, jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.registry import build_model, ShapeCell
from repro.data.pipeline import DataConfig, _batch_at
from repro.distributed.mesh import make_mesh
from repro.launch.steps import build_train_step
from repro.optim import adamw

root, STEPS, LR, SEQ, BATCH, SEED, MODES = ARGS
flat = dict(np.load(root + "/params.npz"))
mesh = make_mesh((2, 2, 1), ("pod", "data", "model"))
ocfg = adamw.AdamWConfig(lr=LR, warmup_steps=1)
meta, out = {}, {}

def unflat(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree

for mode in MODES:
    model = build_model("gemma-2b", mesh, smoke=True)
    b = build_train_step(model, mesh, ocfg, cell=ShapeCell("t", SEQ, BATCH, "train"),
                         sync_mode=mode)
    with mesh:
        step = jax.jit(b.fn, in_shardings=b.in_shardings, out_shardings=b.out_shardings)
        pspecs = model.param_specs(mesh)
        params = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                              unflat(flat), pspecs)
        opt = adamw.init(params, ocfg)
        losses, norms = [], []
        for i in range(STEPS):
            tok = _batch_at(DataConfig(vocab=model.cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                                       seed=SEED), i)
            tok = jax.device_put(tok, NamedSharding(mesh, P(("pod", "data"), None)))
            params, opt, stats = step(params, opt, {"tokens": tok})
            losses.append(float(stats["loss"]))
            norms.append(float(stats["grad_norm"]))
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
                out[f"{mode}/{i}/" + "/".join(p.key for p in path)] = np.asarray(leaf)
    meta[mode] = {"losses": losses, "grad_norms": norms}
np.savez(root + "/ref.npz", **out)
json.dump(meta, open(root + "/ref.json", "w"))
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def reference(root):
    code = REFERENCE.replace(
        "ARGS", repr((str(root), STEPS, LR, SEQ, BATCH, SEED, MODES)))
    assert "REFERENCE_OK" in run_multidevice(code, n_devices=4, timeout=300)
    return dict(np.load(root / "ref.npz")), json.loads((root / "ref.json").read_text())


# ---------------------------------------------------------------------------
# the tests (the port's world first, so no test waits for both worlds)
# ---------------------------------------------------------------------------
def test_rank_blocks_concatenate_to_the_reference_batch(port):
    """Rank (p, d) holds block p * dp + d of the reference's global batch:
    the ranks' blocks, in rank order, are ``repro.data.pipeline``'s batch
    byte for byte, and the mesh lays ranks out row-major."""
    from repro.data.pipeline import DataConfig, _batch_at

    from repro_torch.configs.registry import get_config
    vocab = get_config("gemma-2b", smoke=True).vocab
    arrays, meta = port
    assert [m["rank"] for m in meta] == [{"pod": p, "data": d} for p in (0, 1) for d in (0, 1)]
    for i in range(STEPS):
        blocks = [a[f"tokens/{i}"] for a in arrays]
        assert all(b.shape == (BATCH // 4, SEQ + 1) for b in blocks)
        want = _batch_at(DataConfig(vocab=vocab, seq_len=SEQ, global_batch=BATCH, seed=SEED), i)
        assert np.concatenate(blocks).tobytes() == want.tobytes()


@pytest.mark.parametrize("mode", MODES)
def test_every_rank_ends_with_the_same_params(mode, port):
    arrays, meta = port
    keys = sorted(k for k in arrays[0] if k.startswith(mode + "/"))
    assert keys
    for r in range(1, 4):
        assert meta[r][mode] == meta[0][mode]
        for k in keys:
            assert arrays[r][k].tobytes() == arrays[0][k].tobytes(), (r, k)


@pytest.mark.parametrize("mode", MODES)
def test_train_step_matches_the_reference(mode, port, reference, root):
    """Losses within LOSS_RTOL at every step, step 1's grad norm (same
    params, same batch) within LOSS_RTOL, and the params after each step
    within the module's stated bound, of the reference's step on the same
    mesh shape."""
    arrays, meta = port
    ref_arrays, ref_meta = reference
    np.testing.assert_allclose(meta[0][mode]["losses"], ref_meta[mode]["losses"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(meta[0][mode]["grad_norms"][0], ref_meta[mode]["grad_norms"][0],
                               rtol=LOSS_RTOL)
    init = dict(np.load(root / "params.npz"))
    for i in range(1 if mode == "chunked_bf16" else STEPS):
        keys = sorted(k for k in ref_arrays if k.startswith(f"{mode}/{i}/"))
        assert keys and keys == sorted(k for k in arrays[0] if k.startswith(f"{mode}/{i}/"))
        for k in keys:
            got, want = arrays[0][k].astype(np.float64), ref_arrays[k].astype(np.float64)
            assert got.shape == want.shape, k
            if mode == "chunked_bf16":
                diff = np.abs(got - want)
                assert diff.max() <= 2 * LR and np.mean(diff > 1e-3 * LR) <= 1e-3, k
                continue
            update = np.linalg.norm(want - init[k.split("/", 2)[2]])
            assert update > 0 and np.linalg.norm(got - want) <= UPDATE_RTOL * update, k


def test_every_tensor_sent_is_contiguous(port):
    """What NCCL requires on the cards, held where gloo would let it pass:
    the train steps, the checkpoint barrier and the rings hand
    ``torch.distributed`` contiguous tensors only (autograd leaves the tied
    embedding's gradient transposed)."""
    for meta in port[1]:
        assert meta["not_contiguous"] == []


def test_chunked_sync_matches_auto(port):
    """On the port itself the chunked sync gives auto's losses (the
    reference's ``test_chunked_pod_step_matches_auto``); the bf16-compressed
    one differs by the compression itself (its own trajectory)."""
    meta = port[1][0]
    np.testing.assert_allclose(meta["chunked"]["losses"], meta["auto"]["losses"], rtol=LOSS_RTOL)


def test_launcher_checkpoints_on_rank_zero_and_resumes_on_every_rank(port):
    """``train.main`` on four ranks: rank 0 wrote the step-3 checkpoint, and
    every rank resumed it with the uninterrupted run's losses of steps 4-5."""
    meta = port[1]
    assert meta[0]["ckpt_steps"] == ["step_00000003"]
    for m in meta:
        assert m["launch"] == meta[0]["launch"] and len(m["launch"]) == 5
        assert np.all(np.isfinite(m["launch"]))
        np.testing.assert_allclose(m["resumed"], m["launch"][3:], rtol=LOSS_RTOL)


def test_elastic_resume_on_two_ranks(port, elastic):
    """The port's form of ``tests/test_system.py::test_elastic_restart_smaller_mesh``:
    the root four ranks saved (2x2x1) resumes on two (1x2x1, two
    microbatches a rank), with the four-rank run's losses of steps 4-5."""
    want = port[1][0]["launch"][3:]
    for losses in elastic:
        assert len(losses) == 2
        np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL)
