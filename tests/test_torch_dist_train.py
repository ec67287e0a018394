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
  * every rank ends with the same params, bit for bit: gathered whole, and
    each ZeRO block (every weight's ``d_model`` dim is cut over ``data``)
    on the ranks that hold it.

Every other family trains over pod x data the same way (model = 1): the
smoke configs of qwen3-moe-30b-a3b (each rank routes its own rows, with
the capacity of its own tokens, as the reference's per-shard ``block``),
mamba2-370m, recurrentgemma-2b, whisper-large-v3 (cut to 1+1 layers, ROADMAP
Queue 3 item 3) and internvl2-2b, under "auto" and "chunked", with seeded
frame or patch embeddings where the family takes them: losses of three
steps and step 1's grad norm within ``LOSS_RTOL``, the params after step 1
within ``UPDATE_RTOL`` over the elements whose AdamW denominator is settled
(``SETTLED``: ``test_torch_tp``'s docstring says why), and every rank's
params bit-equal.

Then ``launch.train.main`` itself on the four ranks (``--mesh 2x2x1``,
``--sync-mode chunked``, a checkpoint written by rank 0 at step 3, resumed
by every rank), and the elastic resume of that root on two ranks
(``--mesh 1x2x1``): the resumed losses repeat the uninterrupted run's. JAX
is imported only inside the tests that run the reference.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from conftest import SRC
from test_torch_collectives import spawn_world

LOSS_RTOL = 1e-4
STEPS, LR, SEQ, BATCH, SEED = 3, 1e-2, 32, 8, 3
UPDATE_RTOL = 1e-3
MODES = ("auto", "chunked", "chunked_bf16")
FAMILIES = ("qwen3-moe-30b-a3b", "mamba2-370m", "recurrentgemma-2b", "whisper-large-v3",
            "internvl2-2b")
FAMILY_MODES = ("auto", "chunked")
FAMILY_LAYERS = {"whisper-large-v3": 1}
# AdamW's eps is 1e-8 and b2 0.95: an element whose denominator sqrt(v̂) is
# below 100·eps moves by lr·m̂/(sqrt(v̂) + eps), which a 1e-10 difference of
# summation order can shift by up to lr/100
SETTLED, ADAM_B2 = 100 * 1e-8, 0.95
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
    for arch in FAMILIES:
        jm = _cut(jreg.build_model(arch, smoke=True), FAMILY_LAYERS.get(arch))
        np.savez(path / f"params-{arch}.npz", **_flat(seeded_params(jm, 0)))
        cfg, rng = jm.cfg, np.random.default_rng(11)
        extra = {"encdec": ("audio_embed", cfg.enc_positions),
                 "vlm": ("vis_embed", cfg.n_vis_tokens)}.get(cfg.family)
        inputs = {} if extra is None else {
            extra[0]: rng.standard_normal((BATCH, extra[1], cfg.d_model)).astype(np.float32)}
        np.savez(path / f"inputs-{arch}.npz", **inputs)
    return path


def _cut(jm, n_layers):
    """The reference's model at ``n_layers`` in each stack (its
    ``launch.steps._with_layers``); None keeps it."""
    if n_layers is None:
        return jm
    from repro.launch.steps import _with_layers
    return _with_layers(jm.cfg.name, jm, jm.mesh, n_layers, "train_4k")


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

    for name in ("all_reduce", "all_gather", "all_to_all_single", "broadcast",
                 "batch_isend_irecv", "barrier", "reduce_scatter_tensor",
                 "reduce_scatter_single", "all_gather_into_tensor", "all_gather_single"):
        if hasattr(dist, name):          # the *_single names: torch >= 2.13
            setattr(dist, name, wrap(name, getattr(dist, name)))
    return loose


def cut_of(mesh, specs) -> dict:
    """Each leaf's key -> the mesh axes over 1 that cut it (ZeRO's ``data``,
    tensor parallelism's ``model``)."""
    from repro_torch.distributed.mesh import cut_axes
    return {k: list(cut_axes(mesh, s)) for k, s in _flat(specs).items()}


def assert_blocks_agree(arrays, coords, cut, prefix):
    """Every leaf under ``prefix`` bit-equal across the ranks that hold the
    same block of it: those whose indices on the axes that cut the leaf
    agree (every rank, for a leaf no axis cuts). ``coords`` is each rank's
    {axis: index}, ``cut`` each leaf's axes."""
    n = 0
    for key, axes in cut.items():
        k = f"{prefix}{key}"
        first: dict = {}
        for r, arr in enumerate(arrays):
            if k not in arr:
                continue
            n += 1
            at = tuple(coords[r][a] for a in axes)
            if at in first:
                assert arr[k].tobytes() == arrays[first[at]][k].tobytes(), (r, k)
            else:
                first[at] = r
    assert n, prefix


def _port_steps(rank, root):
    import torch.distributed as dist

    from repro_torch.configs import registry as treg
    from repro_torch.configs.registry import ShapeCell
    from repro_torch.convert import gather_params, params_from_reference
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.launch import train
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import adamw

    loose = _require_contiguous(dist)
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), device="cpu")
    rows = TokenPipeline._rows(BATCH, mesh)
    model = treg.build_model("gemma-2b", mesh, smoke=True)
    specs = model.param_specs(mesh)
    ref = _unflat(dict(np.load(root / "params.npz")))
    ocfg = adamw.AdamWConfig(lr=LR, warmup_steps=1)
    out, meta = {}, {"rank": {"pod": mesh.rank("pod"), "data": mesh.rank("data")},
                     "coords": {a: mesh.rank(a) for a in ("pod", "data", "model")},
                     "cut": {"gemma-2b": cut_of(mesh, specs)}}
    for mode in MODES:
        params = train.shard_state(mesh, params_from_reference(ref, "cpu"), specs)
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
                    out[f"block/{mode}/{i}/{key}"] = t.numpy().copy()
                for key, t in _flat(gather_params(params, mesh, specs)).items():
                    out[f"{mode}/{i}/{key}"] = t.numpy().copy()
        finally:
            data.close()
        meta[mode] = {"losses": losses, "grad_norms": norms}
    for arch in FAMILIES:
        model = train.with_layers(treg.build_model(arch, mesh, smoke=True), FAMILY_LAYERS.get(arch))
        fspecs = model.param_specs(mesh)
        meta["cut"][arch] = cut_of(mesh, fspecs)
        ref = _unflat(dict(np.load(root / f"params-{arch}.npz")))
        inputs = {k: torch.from_numpy(v[rows]) for k, v in
                  np.load(root / f"inputs-{arch}.npz").items()}
        for mode in FAMILY_MODES:
            params = train.shard_state(mesh, params_from_reference(ref, "cpu"), fspecs)
            opt = adamw.init(params, ocfg)
            step = build_train_step(model, mesh, ocfg, cell=ShapeCell("t", SEQ, BATCH, "train"),
                                    sync_mode=mode).fn
            data = TokenPipeline(DataConfig(vocab=model.cfg.vocab, seq_len=SEQ,
                                            global_batch=BATCH, seed=SEED), mesh)
            losses, norms = [], []
            try:
                for i in range(STEPS):
                    params, opt, stats = step(params, opt, {**next(data), **inputs})
                    losses.append(float(stats["loss"]))
                    norms.append(float(stats["grad_norm"]))
                    if i == 0:
                        for key, t in _flat(params).items():
                            out[f"block/{arch}/{mode}/0/{key}"] = t.numpy().copy()
                        for key, t in _flat(gather_params(params, mesh, fspecs)).items():
                            out[f"{arch}/{mode}/0/{key}"] = t.numpy().copy()
            finally:
                data.close()
            meta[f"{arch}/{mode}"] = {"losses": losses, "grad_norms": norms}
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
def port(root, reference_started):
    spawn_world(_port_steps, 4, (root,), root, timeout=240)
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

root, STEPS, LR, SEQ, BATCH, SEED, MODES, FAMILIES, FAMILY_MODES, FAMILY_LAYERS = ARGS
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
from repro.launch.steps import _with_layers
for arch in FAMILIES:
    model = build_model(arch, mesh, smoke=True)
    if arch in FAMILY_LAYERS:
        model = _with_layers(arch, model, mesh, FAMILY_LAYERS[arch], "train_4k")
    inputs = dict(np.load(f"{root}/inputs-{arch}.npz"))
    for mode in FAMILY_MODES:
        b = build_train_step(model, mesh, ocfg, cell=ShapeCell("t", SEQ, BATCH, "train"),
                             sync_mode=mode)
        with mesh:
            step = jax.jit(b.fn, in_shardings=b.in_shardings, out_shardings=b.out_shardings)
            pspecs = model.param_specs(mesh)
            params = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                                  unflat(dict(np.load(f"{root}/params-{arch}.npz"))), pspecs)
            opt = adamw.init(params, ocfg)
            losses, norms = [], []
            for i in range(STEPS):
                tok = _batch_at(DataConfig(vocab=model.cfg.vocab, seq_len=SEQ,
                                           global_batch=BATCH, seed=SEED), i)
                batch = {"tokens": jax.device_put(tok, NamedSharding(mesh, P(("pod", "data"), None)))}
                for k, v in inputs.items():
                    batch[k] = jax.device_put(v, NamedSharding(mesh, P(("pod", "data"), None, None)))
                try:
                    params, opt, stats = step(params, opt, batch)
                except ValueError as e:      # recorded; the test says which case may raise
                    meta[f"{arch}/{mode}"] = {"error": f"{type(e).__name__}: {e}"}
                    break
                losses.append(float(stats["loss"]))
                norms.append(float(stats["grad_norm"]))
                if i == 0:
                    for tag, tree in (("0", params), ("v0", opt.v)):
                        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
                            out[f"{arch}/{mode}/{tag}/" + "/".join(p.key for p in path)] = np.asarray(leaf)
            else:
                meta[f"{arch}/{mode}"] = {"losses": losses, "grad_norms": norms}
np.savez(root + "/ref.npz", **out)
json.dump(meta, open(root + "/ref.json", "w"))
print("REFERENCE_OK")
"""


def start_multidevice(code: str, n_devices: int, log) -> subprocess.Popen:
    """``conftest.run_multidevice``, started in the background: its output
    goes to ``log``."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)], env=env,
                            stdout=log, stderr=subprocess.STDOUT)


def finish_multidevice(proc: subprocess.Popen, log_path, timeout: float, marker: str) -> None:
    try:
        rc = proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = open(log_path).read()
    assert rc == 0 and marker in text, f"reference failed (rc={rc}):\n{text[-4000:]}"


@pytest.fixture(scope="module")
def reference_started(root):
    """The reference's subprocess, started before the port's world so that
    the two overlap."""
    code = REFERENCE.replace(
        "ARGS", repr((str(root), STEPS, LR, SEQ, BATCH, SEED, MODES, FAMILIES, FAMILY_MODES,
                      FAMILY_LAYERS)))
    log = open(root / "ref.log", "w")
    proc = start_multidevice(code, 4, log)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    log.close()


@pytest.fixture(scope="module")
def reference(port, root, reference_started):
    finish_multidevice(reference_started, root / "ref.log", 420, "REFERENCE_OK")
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
    """Every rank's params, gathered whole, bit-equal after every step; each
    rank's own ZeRO blocks bit-equal on the ranks that hold the same block
    (the two pods)."""
    arrays, meta = port
    keys = sorted(k for k in arrays[0] if k.startswith(mode + "/"))
    assert keys
    for r in range(1, 4):
        assert meta[r][mode] == meta[0][mode]
        for k in keys:
            assert arrays[r][k].tobytes() == arrays[0][k].tobytes(), (r, k)
    assert any(meta[0]["cut"]["gemma-2b"].values())          # ZeRO cuts over data
    coords = [m["coords"] for m in meta]
    for i in range(STEPS):
        assert_blocks_agree(arrays, coords, meta[0]["cut"]["gemma-2b"], f"block/{mode}/{i}/")


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


FAMILY_CASES = [f"{arch}/{mode}" for arch in FAMILIES for mode in FAMILY_MODES]


@pytest.mark.parametrize("case", FAMILY_CASES)
def test_every_family_trains_over_pod_x_data(case, port, reference, root):
    """Every family's train step on a (2, 2, 1) mesh, model = 1, against the
    reference's on the same mesh: losses of every step and step 1's grad
    norm within LOSS_RTOL, the params after step 1 within UPDATE_RTOL of
    the norm of the reference's update over the elements whose AdamW
    denominator is settled (the others within 2·lr), and every rank's
    params after step 1 bit-equal, gathered whole and block by block on
    the ranks that share a block.

    The reference's MoE cannot take the chunked step on the installed JAX:
    its ``_mlp`` opens a ``shard_map`` over the whole mesh inside the
    step's pod-manual ``shard_map``, and JAX raises ``ValueError`` (the
    context mesh's pod axis is Manual, the mesh passed in is Auto). That
    case is pinned to raise there, and the port's chunked step is held to
    the reference's auto step, which computes the same mean (the
    reference's ``test_chunked_pod_step_matches_auto``)."""
    arrays, meta = port
    ref_arrays, ref_meta = reference
    want_case = case
    if "error" in ref_meta[case]:
        assert case == "qwen3-moe-30b-a3b/chunked", ref_meta[case]["error"]
        assert ref_meta[case]["error"].startswith("ValueError: The context mesh")
        assert "should match the mesh passed to shard_map" in ref_meta[case]["error"]
        want_case = "qwen3-moe-30b-a3b/auto"
    np.testing.assert_allclose(meta[0][case]["losses"], ref_meta[want_case]["losses"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(meta[0][case]["grad_norms"][0],
                               ref_meta[want_case]["grad_norms"][0], rtol=LOSS_RTOL)
    assert all(np.isfinite(meta[0][case]["losses"]))
    init = dict(np.load(root / f"params-{case.split('/')[0]}.npz"))
    keys = sorted(k for k in ref_arrays if k.startswith(f"{want_case}/0/"))
    assert keys and len(keys) == len([k for k in arrays[0] if k.startswith(f"{case}/0/")])
    for k_want in keys:
        leaf = k_want.split("/", 3)[3]
        k = f"{case}/0/{leaf}"
        got, want = arrays[0][k].astype(np.float64), ref_arrays[k_want].astype(np.float64)
        assert got.shape == want.shape, k
        settled = np.sqrt(ref_arrays[f"{want_case}/v0/{leaf}"] / (1.0 - ADAM_B2)) >= SETTLED
        update = np.linalg.norm((want - init[leaf])[settled])
        assert update > 0 and np.linalg.norm((got - want)[settled]) <= UPDATE_RTOL * update, k
        assert np.all(np.abs(got - want)[~settled] <= 2 * LR), k
        for r in range(1, 4):
            assert arrays[r][k].tobytes() == arrays[0][k].tobytes(), (r, k)
        assert meta[3][case] == meta[0][case]
    assert_blocks_agree(arrays, [m["coords"] for m in meta], meta[0]["cut"][case.split("/")[0]],
                        f"block/{case}/0/")


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
