"""ZeRO-3 over the data axis, the port against the reference, on four CPU
ranks.

Every weight's ``d_model`` dim is cut over ``data`` (the reference's
``param_specs``), AdamW's m and v take the same blocks, each layer's
weights are gathered inside its remat region and their gradients
reduce-scattered. The smoke configs of gemma-2b, internvl2-2b,
qwen3-moe-30b-a3b, mamba2-370m, recurrentgemma-2b and whisper-large-v3
(cut to 1+1 layers, ROADMAP Queue 3 item 3) on (1, 4, 1), (1, 2, 2) and
(2, 2, 1) pod x data x model meshes under "auto", and on (2, 2, 1) under
"chunked" for every family but the MoE (the reference's MoE cannot take
the chunked step, ``test_torch_dist_train``). mistral-nemo-12b, the
largest model the port trains under ZeRO on four cards, on the same
three meshes under "auto": its smoke config, and the same with
``head_dim`` 12 (``VARIANTS``: a query width of 48 against a ``d_model``
of 64, as the full config's 4096 against 5120), each cut to 2 layers
(``LAYERS``: at 3, f32 rounding amplified through the depth moves the
reference's own gradients between two meshes by more than
``GRAD_RTOL``). The port runs in one world of
four gloo ranks (``test_torch_collectives.spawn_world``), each rank on its
blocks of the reference's weights (``test_torch_models.seeded_params``,
crossed over with ``convert.params_from_reference``, then
``launch.train.shard_state``); the reference runs the same cases on four
fake devices in ``REF_PARTS`` subprocesses, started before the port's
world so that they overlap. The sequences are 31 positions long, which a model axis of 2 does
not divide (the MoE's bracket, ``test_torch_ep``). Held, case by case:

  * each rank's block shape of every param and of AdamW's m and v equal to
    the reference's shard on the same device (``addressable_shards``);
  * the logits of each data shard's rows within ``LOGITS_RTOL`` of the
    largest (whisper's encoder output, and its decoder's logits over a
    seeded encoder output, each so: the chain amplifies f32 rounding,
    ``test_torch_tp_families``);
  * step 1's gradients, meaned over pod x data (``steps.batch_mean``) and
    gathered, within ``GRAD_RTOL`` of each leaf's norm;
  * three train steps under ``test_torch_tp``'s rules: losses and step 1's
    grad norm within ``LOSS_RTOL``, the params after step 1 within
    ``UPDATE_RTOL`` of the norm of the reference's update over the elements
    whose AdamW denominator is ``SETTLED``, the others within 2·lr;
  * every leaf bit-equal after every step on the ranks that hold the same
    block of it (on all four ranks for a leaf no axis cuts);
  * every tensor handed to ``torch.distributed`` contiguous.

Then the memory property, on (1, 4, 1): under ``remat="full"``
(``dataclasses.replace`` in the port only) no tensor that autograd saves
for the backward pass has the shape of a whole gathered layer weight
(``saved_tensors_hooks``), where under the smoke configs' ``remat="none"``
some do. And the launcher: ``launch.train.main`` on ``--mesh 1x4x1`` saves
at step 3 and runs to 5; two ranks resume the root on ``1x2x1`` with the
same losses of steps 4-5, and so does the reference's ``train.main``
(its ``restore_checkpoint``) on one device. The root's MANIFEST is a
one-device run's. JAX is imported only in the reference's subprocess and
in the tests that read the root.
"""
import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch

from test_torch_collectives import spawn_world
from test_torch_dist_train import (
    ADAM_B2, SETTLED, _cut, _flat, _require_contiguous, _unflat, assert_blocks_agree, cut_of,
    finish_multidevice, start_multidevice)
from test_torch_tp import GRAD_RTOL, LOGITS_RTOL, LOSS_RTOL, UPDATE_RTOL

STEPS, LR, SEQ, BATCH, SEED, ROWS = 3, 1e-2, 31, 8, 3, 4
AXES = ("pod", "data", "model")
FAMILIES = ("gemma-2b", "internvl2-2b", "qwen3-moe-30b-a3b", "mamba2-370m", "recurrentgemma-2b",
            "whisper-large-v3")
# mistral-nemo-12b's query width n_heads·head_dim (32·128 = 4096) is not its d_model (5120);
# its smoke config's is (4·16 = 64), so a second case sets head_dim 12 in both packages'
# configs (48 against 64) and keeps the full config's mismatch
VARIANTS = {"mistral-nemo-12b-hd12": ("mistral-nemo-12b", {"head_dim": 12})}
NEMO = ("mistral-nemo-12b", "mistral-nemo-12b-hd12")
ARCHS = FAMILIES + NEMO
# whisper 1+1 (ROADMAP Queue 3 item 3); mistral-nemo-12b 2 of its smoke config's 3: at 3
# layers f32 rounding, amplified through the depth at the seeded init, moves step 1's
# gradients by 1.5e-4 of a leaf's norm between the reference's own 1x4x1 and 1x2x2 and its
# third step's loss by 2.2e-3 (gemma-2b's smoke config at 3 layers: 1.1e-4 between the
# packages on one device), over GRAD_RTOL and LOSS_RTOL; at 2, at most 2.6e-5
# (tools/depth_rounding.py)
LAYERS = {"whisper-large-v3": 1, "mistral-nemo-12b": 2, "mistral-nemo-12b-hd12": 2}
MESHES = ((1, 4, 1), (1, 2, 2), (2, 2, 1))
CASES = ([(arch, shape, "auto") for arch in FAMILIES for shape in MESHES]
         + [(arch, (2, 2, 1), "chunked") for arch in FAMILIES if arch != "qwen3-moe-30b-a3b"]
         + [(arch, shape, "auto") for arch in NEMO for shape in MESHES])
LAUNCH_ARGS = ["--arch", "gemma-2b", "--smoke", "--seq-len", "32", "--global-batch", "8",
               "--log-every", "0", "--lr", "3e-3", "--device", "cpu", "--seed", "1"]


def _name(arch, shape, mode):
    return f"{arch}-{'x'.join(map(str, shape))}-{mode}"


def _wkey(arch, shape):
    """A MoE's expert leaves are laid out for the model axis's size."""
    return f"{arch}-tp{shape[2]}" if arch.startswith("qwen3") else arch


NAMES = [_name(*c) for c in CASES]


def _registry_arch(arch):
    """The registry's arch of a case's arch, and the config fields it replaces."""
    return VARIANTS.get(arch, (arch, {}))


def _extra_key(cfg):
    """The stubbed frontend's input a family's batch carries, and its rows."""
    return {"vlm": ("vis_embed", cfg.n_vis_tokens),
            "encdec": ("audio_embed", cfg.enc_positions)}.get(cfg.family)


# ---------------------------------------------------------------------------
# the inputs: seeded reference weights, logit inputs, frontend embeddings
# ---------------------------------------------------------------------------
def _reference_model(arch, mesh=None):
    """The reference's smoke model of a case's arch (over ``mesh``)."""
    from repro.configs import registry as jreg
    from repro.launch.steps import _rebuild

    name, fields = _registry_arch(arch)
    jm = jreg.build_model(name, mesh, smoke=True)
    return _rebuild(jm, mesh, dataclasses.replace(jm.cfg, **fields), None) if fields else jm


def _port_model(arch, mesh):
    """The port's smoke model of a case's arch over ``mesh``."""
    from repro_torch.configs import registry as treg
    from repro_torch.launch import train

    name, fields = _registry_arch(arch)
    model = treg.build_model(name, mesh, smoke=True)
    return train.rebuild(model, dataclasses.replace(model.cfg, **fields)) if fields else model


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    from test_torch_models import seeded_params

    path = tmp_path_factory.mktemp("zero")
    for arch, shape, _m in CASES:
        key = _wkey(arch, shape)
        if (path / f"params-{key}.npz").exists():
            continue
        jm = _cut(_reference_model(arch), LAYERS.get(arch))
        jm.tp = shape[2]
        np.savez(path / f"params-{key}.npz", **_flat(seeded_params(jm, 0)))
    for arch in ARCHS:
        cfg = _reference_model(arch).cfg
        rng = np.random.default_rng(7)
        inputs = {"tokens": rng.integers(0, cfg.vocab, (ROWS, 15)).astype(np.int32)}
        extra = _extra_key(cfg)
        if extra:
            inputs["extra"] = rng.standard_normal((ROWS, extra[1], cfg.d_model)).astype(np.float32)
            inputs["train_extra"] = rng.standard_normal(
                (BATCH, extra[1], cfg.d_model)).astype(np.float32)
        if cfg.family == "encdec":
            inputs["enc"] = rng.standard_normal((ROWS, cfg.enc_positions, cfg.d_model)
                                                ).astype(np.float32)
        np.savez(path / f"inputs-{arch}.npz", **inputs)
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
from repro.launch.steps import _rebuild, _with_layers, build_train_step
from repro.optim import adamw

root, part, CASES, STEPS, LR, SEQ, BATCH, SEED, LAYERS = ARGS
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

def flat(tree):
    return {"/".join(p.key for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}

for arch, base, fields, shape, mode, name, wkey in CASES:
    mesh = make_mesh(tuple(shape), ("pod", "data", "model"), devices=jax.devices()[:4])
    rank_of = {d.id: i for i, d in enumerate(mesh.devices.flat)}
    model = build_model(base, mesh, smoke=True)
    if fields:
        model = _rebuild(model, mesh, dataclasses.replace(model.cfg, **fields), None)
    if arch in LAYERS:
        model = _with_layers(arch, model, mesh, LAYERS[arch], "train_4k")
    fam = model.cfg.family
    inp = dict(np.load(f"{root}/inputs-{arch}.npz"))
    ocfg = adamw.AdamWConfig(lr=LR, warmup_steps=1)
    b = build_train_step(model, mesh, ocfg, cell=ShapeCell("t", SEQ, BATCH, "train"),
                         sync_mode=mode)
    row_sh = lambda a: jax.device_put(a, NamedSharding(mesh, P(("pod", "data"), *([None] * (a.ndim - 1)))))
    with mesh:
        pspecs = model.param_specs(mesh)
        params = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
                              unflat(dict(np.load(f"{root}/params-{wkey}.npz"))), pspecs)
        tok = row_sh(inp["tokens"])
        if fam == "vlm":
            out[f"{name}/logits"] = np.asarray(jax.jit(model.logits_mm)(params, tok, row_sh(inp["extra"])))
        elif fam == "encdec":
            out[f"{name}/enc"] = np.asarray(jax.jit(model.encode)(params, row_sh(inp["extra"])))
            out[f"{name}/logits"] = np.asarray(jax.jit(model.dec_logits)(params, tok, row_sh(inp["enc"])))
        else:
            out[f"{name}/logits"] = np.asarray(jax.jit(model.logits)(params, tok))
        step = jax.jit(b.fn, in_shardings=b.in_shardings, out_shardings=b.out_shardings)
        opt = adamw.init(params, ocfg)
        losses, norms, shards = [], [], {}
        for i in range(STEPS):
            batch = {"tokens": row_sh(_batch_at(DataConfig(
                vocab=model.cfg.vocab, seq_len=SEQ, global_batch=BATCH, seed=SEED), i))}
            if "train_extra" in inp:
                batch["vis_embed" if fam == "vlm" else "audio_embed"] = row_sh(inp["train_extra"])
            if i == 0:
                for k, leaf in flat(jax.jit(jax.grad(model.loss))(params, batch)).items():
                    out[f"{name}/grad/{k}"] = np.asarray(leaf)
            params, opt, stats = step(params, opt, batch)
            losses.append(float(stats["loss"]))
            norms.append(float(stats["grad_norm"]))
            if i == 0:
                for k, leaf in flat(params).items():
                    out[f"{name}/0/{k}"] = np.asarray(leaf)
                for k, leaf in flat(opt.v).items():
                    out[f"{name}/v0/{k}"] = np.asarray(leaf)
                for tag, tree in (("params", params), ("m", opt.m), ("v", opt.v)):
                    for k, leaf in flat(tree).items():
                        got = [None] * 4
                        for s in leaf.addressable_shards:
                            got[rank_of[s.device.id]] = list(s.data.shape)
                        shards[f"{tag}/{k}"] = got
    meta[name] = {"losses": losses, "grad_norms": norms, "shards": shards}
np.savez(f"{root}/ref{part}.npz", **out)
json.dump(meta, open(f"{root}/ref{part}.json", "w"))
print("REFERENCE_OK")
"""
REF_PARTS = 4      # the reference's cases run in this many subprocesses at once (XLA's compiles)


@pytest.fixture(scope="module")
def reference_started(root):
    cases = [(a, *_registry_arch(a), list(s), m, _name(a, s, m), _wkey(a, s))
             for a, s, m in CASES]
    procs = []
    for part in range(REF_PARTS):
        code = REFERENCE.replace("ARGS", repr((str(root), part, cases[part::REF_PARTS], STEPS,
                                               LR, SEQ, BATCH, SEED, LAYERS)))
        log = open(root / f"ref{part}.log", "w")
        procs.append((start_multidevice(code, 4, log), log))
    yield [p for p, _log in procs]
    for proc, log in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


# ---------------------------------------------------------------------------
# the port: four gloo ranks, then two
# ---------------------------------------------------------------------------
def _whole_layer_shapes(model, mesh, specs) -> set:
    """The shapes of this rank's layer weights gathered whole over ``data``:
    each stacked leaf with a ``data`` dim, one layer of its block, that dim
    at its whole size."""
    from repro_torch.distributed.mesh import DATA, axis_size, data_dims, shard
    from repro_torch.launch.steps import _param_shapes

    out = set()
    for key, t in _flat(_param_shapes(model)).items():
        spec = _flat(specs)[key]
        if "/" not in key or not data_dims(spec):
            continue                                     # top-level leaves (embed, ...)
        block = list(shard(mesh, t, spec).shape[1:])
        for d in data_dims(spec):
            block[d - 1] *= axis_size(mesh, DATA)
        out.add(tuple(block))
    return out


def _saved_whole_weights(model, params, batch, wanted: set) -> list:
    """The tensors that autograd saves for the backward pass of
    ``model.loss`` outside a remat region that are whole gathered layer
    weights: a view of a ``_zero_layer`` output's storage (those outputs
    are kept alive for the forward, so no other tensor reuses their
    memory), or a tensor of such a weight's shape that is not a view of
    this rank's params (a remat region keeps its input blocks, and a block
    may have a whole weight's shape). Their shapes."""
    from repro_torch.models import common as cm
    from repro_torch.optim.adamw import tree_leaves, tree_map

    gathered, found = [], []
    real = cm.ShardingMixin._zero_layer

    def spy(self, leaves, specs):
        out = real(self, leaves, specs)
        gathered.extend(o for o, i in zip(out, leaves) if o is not i)
        return out

    def pack(t):
        ptr = t.untyped_storage().data_ptr()
        if ptr in {g.untyped_storage().data_ptr() for g in gathered} or (
                tuple(t.shape) in wanted and ptr not in blocks):
            found.append(tuple(t.shape))
        return t

    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    blocks = {p.untyped_storage().data_ptr() for p in tree_leaves(leaves)}
    cm.ShardingMixin._zero_layer = spy
    try:
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            model.loss(leaves, batch)
    finally:
        cm.ShardingMixin._zero_layer = real
    return sorted(set(found))


def _port_zero(rank, root):
    import torch.distributed as dist

    from repro_torch.configs.registry import ShapeCell
    from repro_torch.convert import gather_params, params_from_reference
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.launch import train
    from repro_torch.launch.steps import (
        _value_and_grad, batch_mean, build_train_step, zero_leaves)
    from repro_torch.optim import adamw

    loose = _require_contiguous(dist)
    out, meta = {}, {"coords": {}}
    for arch, shape, mode in CASES:
        name = _name(arch, shape, mode)
        mesh = make_mesh(shape, AXES, device="cpu")
        meta["coords"][name] = {a: mesh.rank(a) for a in AXES}
        model = train.with_layers(_port_model(arch, mesh), LAYERS.get(arch))
        fam = model.cfg.family
        specs = model.param_specs(mesh)
        inp = {k: torch.from_numpy(v) for k, v in np.load(root / f"inputs-{arch}.npz").items()}
        whole = params_from_reference(
            _unflat(dict(np.load(root / f"params-{_wkey(arch, shape)}.npz"))), "cpu")
        params = train.shard_state(mesh, whole, specs)
        mine = TokenPipeline._rows(ROWS, mesh)           # this data shard's rows
        tok = inp["tokens"][mine]
        with torch.no_grad():
            if fam == "vlm":
                out[f"{name}/logits"] = model.logits_mm(params, tok, inp["extra"][mine]).numpy()
            elif fam == "encdec":
                out[f"{name}/enc"] = model.encode(params, inp["extra"][mine]).numpy()
                out[f"{name}/logits"] = model.dec_logits(params, tok, inp["enc"][mine]).numpy()
            else:
                out[f"{name}/logits"] = model.logits(params, tok).numpy()
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
                if "train_extra" in inp:
                    batch[_extra_key(model.cfg)[0]] = inp["train_extra"][rows]
                if i == 0:
                    loss, grads = _value_and_grad(model, params, batch)
                    grads = batch_mean(loss, grads, mesh, zero_leaves(model, mesh))[1]
                    for key, t in _flat(gather_params(grads, mesh, specs)).items():
                        if rank == 0:
                            out[f"{name}/grad/{key}"] = t.numpy().copy()
                params, opt, stats = step(params, opt, batch)
                losses.append(float(stats["loss"]))
                norms.append(float(stats["grad_norm"]))
                for key, t in _flat(params).items():
                    out[f"block/{name}/{i}/{key}"] = t.numpy().copy()
                if i == 0:
                    full = _flat(gather_params(params, mesh, specs))
                    if rank == 0:
                        for key, t in full.items():
                            out[f"{name}/0/{key}"] = t.numpy().copy()
                    shapes = {f"{tag}/{k}": list(t.shape) for tag, tree in
                              (("params", params), ("m", opt.m), ("v", opt.v))
                              for k, t in _flat(tree).items()}
        finally:
            data.close()
        meta[name] = {"losses": losses, "grad_norms": norms, "shapes": shapes,
                      "cut": cut_of(mesh, specs)}
    # the memory property: no whole gathered layer weight saved across layers
    mesh = make_mesh((1, 4, 1), AXES, device="cpu")
    meta["saved"] = {}
    for arch in ARCHS:
        model = train.with_layers(_port_model(arch, mesh), LAYERS.get(arch))
        specs = model.param_specs(mesh)
        whole = params_from_reference(
            _unflat(dict(np.load(root / f"params-{_wkey(arch, (1, 4, 1))}.npz"))), "cpu")
        params = train.shard_state(mesh, whole, specs)
        inp = dict(np.load(root / f"inputs-{arch}.npz"))
        batch = {"tokens": torch.from_numpy(np.concatenate(
            [inp["tokens"], inp["tokens"][:, :1]], 1)[:1])}
        if "train_extra" in inp:
            batch[_extra_key(model.cfg)[0]] = torch.from_numpy(inp["train_extra"][:1])
        wanted = _whole_layer_shapes(model, mesh, specs)
        got = {}
        for remat in ("none", "full"):
            m = train.rebuild(model, dataclasses.replace(model.cfg, remat=remat))
            got[remat] = _saved_whole_weights(m, params, batch, wanted)
        meta["saved"][arch] = {"wanted": sorted(wanted), **got}
    # the launcher on 1x4x1, saved at step 3
    meta["launch"] = train.main(LAUNCH_ARGS + ["--mesh", "1x4x1", "--steps", "5",
                                               "--ckpt-dir", str(root / "launch"),
                                               "--ckpt-every", "3"])["losses"]
    meta["not_contiguous"] = loose
    np.savez(root / f"port{rank}.npz", **out)
    (root / f"port{rank}.json").write_text(json.dumps(meta))


def _port_elastic(rank, root):
    from repro_torch.launch import train

    losses = train.main(LAUNCH_ARGS + ["--mesh", "1x2x1", "--steps", "5",
                                       "--ckpt-dir", str(root / "elastic")])["losses"]
    (root / f"elastic{rank}.json").write_text(json.dumps(losses))


@pytest.fixture(scope="module")
def port(root, reference_started):
    spawn_world(_port_zero, 4, (root,), root, timeout=300)
    arrays = [dict(np.load(root / f"port{r}.npz")) for r in range(4)]
    meta = [json.loads((root / f"port{r}.json").read_text()) for r in range(4)]
    return arrays, meta


@pytest.fixture(scope="module")
def elastic(port, root):
    shutil.copytree(root / "launch", root / "elastic")
    spawn_world(_port_elastic, 2, (root,), root, timeout=90)
    return [json.loads((root / f"elastic{r}.json").read_text()) for r in range(2)]


@pytest.fixture(scope="module")
def reference(port, root, reference_started):
    arrays, meta = {}, {}
    for part, proc in enumerate(reference_started):
        finish_multidevice(proc, root / f"ref{part}.log", 420, "REFERENCE_OK")
        arrays.update(np.load(root / f"ref{part}.npz"))
        meta.update(json.loads((root / f"ref{part}.json").read_text()))
    return arrays, meta


def _port_rows(port, name, key):
    """Each data shard's rows of ``key`` (model rank 0's), in shard order."""
    arrays, meta = port
    shards = sorted(((c["pod"], c["data"]), r) for r, c in
                    ((r, m["coords"][name]) for r, m in enumerate(meta)) if c["model"] == 0)
    return np.concatenate([arrays[r][f"{name}/{key}"] for _s, r in shards])


# ---------------------------------------------------------------------------
# the tests (the port's world first, so no test waits for both)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NAMES)
def test_blocks_are_the_references_device_shards(name, port, reference):
    """Each rank's block of every param and of AdamW's m and v has the shape
    of the reference's shard on the same device: ``d_model`` cut over
    ``data``, the model axis's dims over ``model``."""
    want = reference[1][name]["shards"]
    assert sorted(want) == sorted(port[1][0][name]["shapes"])
    for r, meta in enumerate(port[1]):
        for key, shapes in want.items():
            assert meta[name]["shapes"][key] == shapes[r], (r, key)
    cut = port[1][0][name]["cut"]
    assert any("data" in axes for axes in cut.values())


@pytest.mark.parametrize("name", NAMES)
def test_logits_match_the_reference(name, port, reference):
    for key in ("logits", "enc"):
        if f"{name}/{key}" not in reference[0]:
            continue
        got, want = _port_rows(port, name, key), reference[0][f"{name}/{key}"]
        assert got.shape == want.shape, key
        assert np.abs(got - want).max() <= LOGITS_RTOL * np.abs(want).max(), key


@pytest.mark.parametrize("name", NAMES)
def test_step1_gradients_match_the_reference(name, port, reference):
    """Step 1's gradients: each ZeRO block reduce-scattered over ``data`` in
    the backward pass, then meaned over the pods, gathered whole, within
    GRAD_RTOL of the norm of the reference's leaf."""
    got = {k: v for k, v in port[0][0].items() if k.startswith(f"{name}/grad/")}
    want = {k: v for k, v in reference[0].items() if k.startswith(f"{name}/grad/")}
    assert got and sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        assert np.linalg.norm(got[k] - w) <= GRAD_RTOL * np.linalg.norm(w), k


@pytest.mark.parametrize("name", NAMES)
def test_train_steps_match_the_reference(name, port, reference, root):
    arrays, meta = port
    ref_arrays, ref_meta = reference
    np.testing.assert_allclose(meta[0][name]["losses"], ref_meta[name]["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(meta[0][name]["grad_norms"][0], ref_meta[name]["grad_norms"][0],
                               rtol=LOSS_RTOL)
    arch, shape, _m = CASES[NAMES.index(name)]
    init = dict(np.load(root / f"params-{_wkey(arch, shape)}.npz"))
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
def test_ranks_that_share_a_block_hold_it_bit_for_bit(name, port):
    """Every rank reports the same losses and grad norms; every leaf no axis
    cuts is bit-equal on all four ranks after every step, and every cut
    leaf on the ranks that hold the same block of it."""
    arrays, meta = port
    coords = [m["coords"][name] for m in meta]
    for r in range(1, 4):
        assert meta[r][name]["losses"] == meta[0][name]["losses"]
        assert meta[r][name]["grad_norms"] == meta[0][name]["grad_norms"]
    assert any(not axes for axes in meta[0][name]["cut"].values())
    for i in range(STEPS):
        assert_blocks_agree(arrays, coords, meta[0][name]["cut"], f"block/{name}/{i}/")


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_full_saves_no_whole_layer_weight(arch, port):
    """Under ``remat="full"`` each layer's gather runs inside its remat
    region, so autograd saves no whole gathered layer weight across layers;
    under ``remat="none"`` it does (the check can see them)."""
    saved = port[1][0]["saved"][arch]
    assert saved["wanted"] and saved["none"]
    assert saved["full"] == []


def test_every_tensor_sent_is_contiguous(port):
    for meta in port[1]:
        assert meta["not_contiguous"] == []


def test_a_zero_root_resumes_elastically_and_in_the_reference(port, elastic, root, tmp_path):
    """``--mesh 1x4x1`` saves at step 3 and runs to 5; ``1x2x1`` on two
    ranks resumes step 3 with the same losses of steps 4-5, and so does the
    reference's ``train.main`` on one device. The root's MANIFEST names the
    leaves, shapes, dtypes and chunks of a one-device run's, and step 1's
    loss is the one-device run's."""
    from repro.launch import train as jtrain

    from repro_torch.launch import train

    launch = port[1][0]["launch"]
    for meta in port[1]:
        assert meta["launch"] == launch and len(launch) == 5 and np.all(np.isfinite(launch))
    for losses in elastic:
        assert len(losses) == 2
        np.testing.assert_allclose(losses, launch[3:], rtol=LOSS_RTOL)
    shutil.copytree(root / "launch", tmp_path / "ref")
    ref_args = [a for a in LAUNCH_ARGS if a not in ("--device", "cpu")]
    ref = jtrain.main(ref_args + ["--mesh", "1x1", "--steps", "5",
                                  "--ckpt-dir", str(tmp_path / "ref")])["losses"]
    np.testing.assert_allclose(ref, launch[3:], rtol=LOSS_RTOL)
    one = train.main(LAUNCH_ARGS + ["--mesh", "1x1", "--steps", "3", "--ckpt-dir",
                                    str(tmp_path / "one"), "--ckpt-every", "3"])["losses"]
    np.testing.assert_allclose(launch[0], one[0], rtol=LOSS_RTOL)

    def layout(path):
        with open(path / "step_00000003" / "MANIFEST.json") as fh:
            leaves = json.load(fh)["leaves"]
        return {k: ({f: e[f] for f in ("shape", "dtype", "nbytes", "file", "chunk_bytes")},
                    [(c["offset"], c["length"]) for c in e["chunks"]]) for k, e in leaves.items()}

    assert layout(root / "launch") == layout(tmp_path / "one")


def test_adamw_updates_a_large_leaf_in_slices_bit_for_bit(monkeypatch):
    """A leaf over ``UPDATE_SLICE_ELEMENTS`` is updated a slice of its
    leading dim at a time: the same elementwise arithmetic, so params and
    both moments equal the whole-leaf update's bit for bit."""
    from repro_torch.optim import adamw

    gen = torch.Generator().manual_seed(5)
    params = {"w": torch.randn((6, 5, 7), generator=gen).to(torch.bfloat16),
              "b": torch.randn((7,), generator=gen)}
    grads = {k: torch.randn(v.shape, generator=gen).to(v.dtype) for k, v in params.items()}
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1)
    state = adamw.init(params, cfg)
    state = adamw.OptState(state.step, {k: torch.rand(v.shape, generator=gen)
                                        for k, v in state.m.items()},
                           {k: torch.rand(v.shape, generator=gen) for k, v in state.v.items()})
    whole = adamw.apply(params, grads, state, cfg)
    monkeypatch.setattr(adamw, "UPDATE_SLICE_ELEMENTS", 2 * 5 * 7)   # slices of 2 rows
    sliced = adamw.apply(params, grads, state, cfg)
    for a, b in ((whole[0], sliced[0]), (whole[1].m, sliced[1].m), (whole[1].v, sliced[1].v)):
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    assert not torch.equal(whole[0]["w"], params["w"])


def test_restore_keeps_each_leaf_as_it_is_verified(tmp_path):
    """``restore_checkpoint(keep=)`` hands each whole, verified leaf to
    ``keep`` in MANIFEST order, one at a time, and returns what it kept."""
    from repro_torch.ckpt.checkpoint import restore_checkpoint, save_checkpoint

    tree = {"a": torch.arange(24, dtype=torch.float32).reshape(4, 6),
            "b": {"c": torch.arange(10, dtype=torch.int32)}}
    save_checkpoint(tmp_path, 1, tree, device="cpu")
    seen = []

    def keep(key, t):
        seen.append((key, tuple(t.shape)))
        return t[:1].clone()

    got, step = restore_checkpoint(tmp_path / "step_00000001", device="cpu", keep=keep)
    with open(tmp_path / "step_00000001" / "MANIFEST.json") as fh:
        order = list(json.load(fh)["leaves"])
    assert step == 1 and [k for k, _s in seen] == order
    assert dict(seen) == {"a": (4, 6), "b/c": (10,)}
    assert torch.equal(got["a"], tree["a"][:1]) and torch.equal(got["b"]["c"], tree["b"]["c"][:1])
