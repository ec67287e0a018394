"""The port's model axis for the ssm, hybrid and encdec families against the
reference's, on four CPU ranks.

The smoke configs of mamba2-370m, recurrentgemma-2b and whisper-large-v3
on (1, 2, 2) and (1, 1, 4) pod x data x model meshes, plus two cases that
the full widths meet (``dataclasses.replace`` in both packages):
recurrentgemma with six heads, whole on four ranks (recurrentgemma-2b's 10
heads are), whisper with a vocab of 130 on (1, 1, 4), whole on four ranks
(whisper-large-v3's 51866 is; its split on two is the smoke vocab's case
on (1, 2, 2)), and mamba2 with two heads of 32 on (1, 1, 4), whose heads
stay whole while ``d_inner`` splits (every rank runs every head and keeps
its channels at the norm). The port runs in one world of four
gloo ranks (``test_torch_collectives.spawn_world``), each rank on its
blocks of the reference's weights (``test_torch_models.seeded_params``,
crossed over with ``convert.params_from_reference``, then
``launch.train.shard_state``); the reference runs the same cases on four
fake devices in one subprocess, started before the port's world so the two
overlap. Held, case by case:

  * ``param_specs`` equal to the reference's, entry for entry;
  * the logits, gathered over ``model``, within ``LOGITS_RTOL`` of the
    largest logit; whisper's stages each on the same inputs (the encoder
    output of seeded frames, and ``dec_logits`` of a seeded encoder
    output), as ``test_torch_encdec`` holds them;
  * step 1's gradients, gathered, within ``GRAD_RTOL`` (1e-4) of each
    leaf's norm: AdamW's first moment after step 1, (1 - b1) times the
    gradient meaned over pod x data and clipped, in both packages (the
    reference then compiles one function a case, its train step);
  * three train steps as ``test_torch_tp`` holds them;
  * whisper only: its init amplifies f32 rounding (ROADMAP Queue 3 item
    3), so it is held to the reference on the same mesh within the two
    packages' difference on one device plus twice the reference's own
    1-versus-4-device spread, each measured in the test
    (``_whisper_bounds``). On (1, 1, 4) the reference's own spread
    reaches 1.3e-4 of a leaf's gradient norm and the packages differ by
    2.4e-4 on one device: a bound of 5.0e-4 against the port's 2.6e-4;
    the spread is asserted under ``WHISPER_SPREAD_MAX``;
  * every leaf that is not cut over ``model`` bit-equal on every rank
    after every step, and every tensor handed to ``torch.distributed``
    contiguous.

Also the two operators the families add to ``ShardingMixin``, each on four
ranks against a one-rank computation of the same function (the gather whose
backward is a reduce-scatter, and a statistic summed over ``model``); each
family under ``remat="full"`` on (1, 1, 4) against the port's one-device
step (the recompute reruns the forward's collectives in the same order on
every rank); and ``launch.train.main`` on recurrentgemma-2b's smoke config
over ``--mesh 2x2`` (data x model), saved at step 3 and resumed by a world
of two on ``1x2``. JAX is imported only in the reference's subprocess and
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
WHISPER_SPREAD_MAX = 1e-3          # the reference's own 1-vs-4-device gradient spread, ceiling
STEPS, LR, SEQ, BATCH, SEED = 3, 1e-2, 32, 8, 3
AXES = ("pod", "data", "model")
ARCHS = ("mamba2-370m", "recurrentgemma-2b", "whisper-large-v3")
CASES = ([(arch, shape, ()) for arch in ARCHS for shape in ((1, 2, 2), (1, 1, 4))]
         + [("recurrentgemma-2b", (1, 1, 4), (("n_heads", 6),)),
            ("whisper-large-v3", (1, 1, 4), (("vocab", 130),)),
            ("mamba2-370m", (1, 1, 4), (("ssm_head_dim", 32),))])
REMAT_SEQ = 40
ELASTIC_ARGS = ["--arch", "recurrentgemma-2b", "--smoke", "--seq-len", "32", "--global-batch",
                "4", "--log-every", "0", "--lr", "3e-3", "--device", "cpu", "--seed", "1"]


def _tag(override):
    return "".join(f"-{k}{v}" for k, v in override)


def _name(arch, shape, override):
    return f"{arch}-{'x'.join(map(str, shape))}{_tag(override)}"


NAMES = [_name(*c) for c in CASES]


def _weights_key(arch, override):
    return arch + _tag(override)


def _whisper(arch):
    return arch.startswith("whisper")


# ---------------------------------------------------------------------------
# the inputs: seeded reference weights, logit inputs, frame embeddings
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def root(tmp_path_factory):
    from repro.configs import registry as jreg
    from test_torch_models import seeded_params

    path = tmp_path_factory.mktemp("tp_families")
    for arch, override in {(a, o) for a, _s, o in CASES}:
        jm = jreg.build_model(arch, smoke=True)
        if override:
            jm = type(jm)(dataclasses.replace(jm.cfg, **dict(override)), None)
        key = _weights_key(arch, override)
        np.savez(path / f"params-{key}.npz", **_flat(seeded_params(jm, 0)))
        cfg = jm.cfg
        rng = np.random.default_rng(7)
        frames = (cfg.enc_positions or 1, cfg.d_model)
        np.savez(path / f"inputs-{key}.npz",
                 tokens=rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32),
                 audio=rng.standard_normal((2, *frames)).astype(np.float32),
                 enc=rng.standard_normal((2, *frames)).astype(np.float32),
                 train_audio=rng.standard_normal((BATCH, *frames)).astype(np.float32))
    return path


# ---------------------------------------------------------------------------
# the reference: the same cases on four fake devices, in the background
# ---------------------------------------------------------------------------
REFERENCE = """
import dataclasses
import json
import numpy as np, jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.registry import build_model, ShapeCell
from repro.data.pipeline import DataConfig, _batch_at
from repro.distributed.mesh import make_mesh
from repro.launch.steps import build_train_step
from repro.optim import adamw

root, CASES, STEPS, LR, SEQ, BATCH, SEED = ARGS
out, meta = {}, {}
ones, ONE = {}, ("enc1", "logits1", "grad1")     # weights key -> the case that ran them on one device

def unflat(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree

def put(x, mesh, spec):
    return jax.device_put(x, NamedSharding(mesh, spec))

def batch_at(model, mesh, inp, i):
    tok = _batch_at(DataConfig(vocab=model.cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                               seed=SEED), i)
    batch = {"tokens": put(tok, mesh, P(("pod", "data"), None))}
    if model.cfg.family == "encdec":
        batch["audio_embed"] = put(inp["train_audio"], mesh, P(("pod", "data"), None, None))
    return batch

def save(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(p.key for p in path)] = np.asarray(leaf)

for arch, shape, override, name, wkey in CASES:
    mesh = make_mesh(tuple(shape), ("pod", "data", "model"), devices=jax.devices()[:4])
    model = build_model(arch, mesh, smoke=True)
    if override:
        model = type(model)(dataclasses.replace(model.cfg, **dict(override)), mesh)
    inp = dict(np.load(f"{root}/inputs-{wkey}.npz"))
    flat = dict(np.load(f"{root}/params-{wkey}.npz"))
    ocfg = adamw.AdamWConfig(lr=LR, warmup_steps=1)
    b = build_train_step(model, mesh, ocfg, cell=ShapeCell("t", SEQ, BATCH, "train"))
    with mesh:
        params = jax.tree.map(lambda x, s: put(x, mesh, s), unflat(flat), model.param_specs(mesh))
        if model.cfg.family == "encdec":
            out[f"{name}/enc"] = np.asarray(jax.jit(model.encode)(params, inp["audio"]))
            lg = jax.jit(model.dec_logits)(params, inp["tokens"], inp["enc"])
        else:
            lg = jax.jit(model.logits)(params, inp["tokens"])
        out[f"{name}/logits"] = np.asarray(lg)
        step = jax.jit(b.fn, in_shardings=b.in_shardings, out_shardings=b.out_shardings)
        # the state on the step's own shardings: one compile for every step
        opt = jax.device_put(adamw.init(params, ocfg), b.in_shardings[1])
        losses, norms = [], []
        for i in range(STEPS):
            params, opt, stats = step(params, opt, batch_at(model, mesh, inp, i))
            losses.append(float(stats["loss"]))
            norms.append(float(stats["grad_norm"]))
            save(f"{name}/{i}/", params)
            if i == 0:
                save(f"{name}/grad/", opt.m)
                save(f"{name}/v0/", opt.v)
    meta[name] = {"losses": losses, "grad_norms": norms}
    if model.cfg.family == "encdec" and wkey in ones:       # these weights ran on one device
        done = ones[wkey]
        for k in [k for k in out if k.startswith(done + "/") and k.split("/")[1] in ONE]:
            out[name + k[len(done):]] = out[k]
        meta[name]["losses1"] = meta[done]["losses1"]
    elif model.cfg.family == "encdec":
        # the reference's own spread: the same case on one device
        ones[wkey] = name
        mesh = make_mesh((1, 1, 1), ("pod", "data", "model"), devices=jax.devices()[:1])
        one = type(model)(model.cfg, mesh)
        b = build_train_step(one, mesh, ocfg, cell=ShapeCell("t", SEQ, BATCH, "train"))
        with mesh:
            params = unflat(flat)
            out[f"{name}/enc1"] = np.asarray(jax.jit(one.encode)(params, inp["audio"]))
            out[f"{name}/logits1"] = np.asarray(
                jax.jit(one.dec_logits)(params, inp["tokens"], inp["enc"]))
            step = jax.jit(b.fn, in_shardings=b.in_shardings, out_shardings=b.out_shardings)
            params = jax.device_put(params, b.in_shardings[0])
            opt = jax.device_put(adamw.init(params, ocfg), b.in_shardings[1])
            losses = []
            for i in range(STEPS):
                params, opt, stats = step(params, opt, batch_at(one, mesh, inp, i))
                losses.append(float(stats["loss"]))
                if i == 0:
                    save(f"{name}/grad1/", opt.m)
        meta[name]["losses1"] = losses
np.savez(root + "/ref.npz", **out)
json.dump(meta, open(root + "/ref.json", "w"))
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def reference_started(root):
    cases = [(a, list(s), [list(kv) for kv in o], _name(a, s, o), _weights_key(a, o))
             for a, s, o in CASES]
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
def _operators(rank, out):
    """The two operators on (1, 1, 4): this rank's block of a seeded X, and
    the same function of the whole X on one rank."""
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.models.common import ShardingMixin

    op = ShardingMixin()
    op.mesh = make_mesh((1, 1, 4), AXES, device="cpu")
    gen = np.random.default_rng(5)
    X = torch.from_numpy(gen.standard_normal((2, 3, 8)).astype(np.float32))
    W = torch.from_numpy(gen.standard_normal((4, 2, 3, 8)).astype(np.float32))
    C = torch.from_numpy(gen.standard_normal((2, 3, 8)).astype(np.float32))
    blk = slice(2 * rank, 2 * rank + 2)

    # the gather: every rank feeds the whole X into its own output (weights W[r])
    x = X[..., blk].clone().requires_grad_()
    y = op._gather_in(x)
    (y * W[rank]).sum().backward()
    out["op/gather/y"] = y.detach().numpy()
    out["op/gather/grad"] = x.grad.numpy()
    whole = X.clone().requires_grad_()
    sum((whole * W[r]).sum() for r in range(4)).backward()
    out["op/gather/want_grad"] = whole.grad[..., blk].numpy()

    # the statistic: each rank normalizes its block by the sum of squares of all
    x = X[..., blk].clone().requires_grad_()
    s = op._sum_stat(torch.sum(torch.square(x), dim=-1, keepdim=True))
    (x * torch.rsqrt(s) * C[..., blk]).sum().backward()
    out["op/stat/s"] = s.detach().numpy()
    out["op/stat/grad"] = x.grad.numpy()
    whole = X.clone().requires_grad_()
    sw = torch.sum(torch.square(whole), dim=-1, keepdim=True)
    (whole * torch.rsqrt(sw) * C).sum().backward()
    out["op/stat/want_s"] = sw.detach().numpy()
    out["op/stat/want_grad"] = whole.grad[..., blk].numpy()


def _port_tp(rank, root):
    import torch.distributed as dist

    from repro_torch.configs import registry as treg
    from repro_torch.configs.registry import ShapeCell
    from repro_torch.convert import gather_params, params_from_reference
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.distributed.mesh import make_mesh, model_dims
    from repro_torch.launch import train
    from repro_torch.launch.steps import _value_and_grad, build_train_step
    from repro_torch.optim import adamw

    loose = _require_contiguous(dist)
    out, meta = {}, {}
    _operators(rank, out)
    for arch, shape, override in CASES:
        name = _name(arch, shape, override)
        wkey = _weights_key(arch, override)
        mesh = make_mesh(shape, AXES, device="cpu")
        model = treg.build_model(arch, mesh, smoke=True)
        if override:
            model = train.rebuild(model, dataclasses.replace(model.cfg, **dict(override)))
        specs = model.param_specs(mesh)
        inp = {k: torch.from_numpy(v) for k, v in np.load(root / f"inputs-{wkey}.npz").items()}
        whole = params_from_reference(_unflat(dict(np.load(root / f"params-{wkey}.npz"))), "cpu")
        params = train.shard_state(mesh, whole, specs)
        with torch.no_grad():
            if _whisper(arch):
                enc = model.encode(params, inp["audio"])
                lg = model.dec_logits(params, inp["tokens"], inp["enc"])
            else:
                lg = model.logits(params, inp["tokens"])
        if rank == 0:
            out[f"{name}/logits"] = lg.numpy()
            if _whisper(arch):
                out[f"{name}/enc"] = enc.numpy()
        ocfg = adamw.AdamWConfig(lr=LR, warmup_steps=1)
        opt = adamw.init(params, ocfg)
        step = build_train_step(model, mesh, ocfg, cell=ShapeCell("t", SEQ, BATCH, "train")).fn
        data = TokenPipeline(DataConfig(vocab=model.cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                                        seed=SEED), mesh)
        rows = TokenPipeline._rows(BATCH, mesh)
        flat_specs = _flat(specs)
        losses, norms = [], []
        try:
            for i in range(STEPS):
                batch = next(data)
                if _whisper(arch):
                    batch["audio_embed"] = inp["train_audio"][rows]
                params, opt, stats = step(params, opt, batch)
                losses.append(float(stats["loss"]))
                norms.append(float(stats["grad_norm"]))
                if i == 0:      # step 1's first moment: its meaned, clipped gradient x (1 - b1)
                    for key, t in _flat(gather_params(opt.m, mesh, specs)).items():
                        if rank == 0:
                            out[f"{name}/grad/{key}"] = t.numpy().copy()
                full = _flat(gather_params(params, mesh, specs)) if i == 0 else {}
                for key, t in _flat(params).items():
                    out[f"block/{name}/{i}/{key}"] = t.numpy().copy()    # every rank's own
                    if rank == 0 and i == 0:
                        out[f"{name}/{i}/{key}"] = full[key].numpy().copy()
        finally:
            data.close()
        meta[name] = {"losses": losses, "grad_norms": norms,
                      "coords": {a: mesh.rank(a) for a in AXES}, "axes": cut_of(mesh, specs),
                      "whole": sorted(k for k, s in flat_specs.items() if not model_dims(s)),
                      "cut": sorted(k for k, s in flat_specs.items() if model_dims(s))}
    # each family under remat="full" on (1, 1, 4): the recompute's collectives
    mesh = make_mesh((1, 1, 4), AXES, device="cpu")
    for arch in ARCHS:
        model = treg.build_model(arch, mesh, smoke=True)
        model = train.rebuild(model, dataclasses.replace(model.cfg, remat="full"))
        whole = params_from_reference(_unflat(dict(np.load(root / f"params-{arch}.npz"))), "cpu")
        specs = model.param_specs(mesh)
        batch = _remat_batch(root, arch)
        loss, grads = _value_and_grad(model, train.shard_state(mesh, whole, specs), batch)
        meta[f"remat/{arch}"] = float(loss)
        for key, t in _flat(gather_params(grads, mesh, specs)).items():  # every rank gathers
            if rank == 0:
                out[f"remat/{arch}/{key}"] = t.numpy()
        serving = _serve_steps(root, arch, mesh)          # every rank decodes
        if rank == 0:
            out.update(serving)
    ck = root / "elastic"
    meta["launch"] = train.main(ELASTIC_ARGS + ["--mesh", "2x2", "--steps", "5",
                                                "--ckpt-dir", str(ck), "--ckpt-every", "3"])["losses"]
    meta["not_contiguous"] = loose
    np.savez(root / f"port{rank}.npz", **out)
    (root / f"port{rank}.json").write_text(json.dumps(meta))


SERVE_STEPS = 3                    # decode steps of the serving check


def _serve_steps(root, arch, mesh) -> dict:
    """``SERVE_STEPS`` decode steps of ``arch``'s smoke config over
    ``mesh`` (whisper's after ``prefill_cross``), on this rank's blocks of
    the weights and of a cache cut by ``cache_specs``; the gathered logits
    and the one-device decode's of the same weights and tokens."""
    from repro_torch.configs import registry as treg
    from repro_torch.convert import params_from_reference
    from repro_torch.distributed.mesh import P, gather
    from repro_torch.launch import train
    from repro_torch.models.common import cache_batch_spec

    inp = {k: torch.from_numpy(v) for k, v in np.load(root / f"inputs-{arch}.npz").items()}
    whole = params_from_reference(_unflat(dict(np.load(root / f"params-{arch}.npz"))), "cpu")
    tok, audio = inp["tokens"], inp["audio"]
    B, T = tok.shape[0], 8
    out = {}
    for where in (None, mesh):
        model = treg.build_model(arch, where, smoke=True)
        params, cache, kw = whole, model.init_cache(B, T, device="cpu"), {}
        if where is not None:
            specs = model.cache_specs(mesh, B, T)
            params = train.shard_state(mesh, whole, model.param_specs(mesh))
            cache, kw = train.shard_state(mesh, cache, specs), {"cache_specs": specs}
        lgs = []
        with torch.no_grad():
            if _whisper(arch):
                cache = model.prefill_cross(params, cache, audio, **kw)
            for t in range(SERVE_STEPS):
                lg, cache = model.decode_step(params, cache, tok[:, t:t + 1],
                                              torch.full((B,), t, dtype=torch.int32), **kw)
                lgs.append(lg)
        lg = torch.cat(lgs, dim=1)
        if where is not None:
            lg = gather(mesh, lg, P(cache_batch_spec(mesh, B), None, None))
        out[f"serve/{arch}/{'mesh' if where is not None else 'one'}"] = lg.numpy()
    return out


def _remat_batch(root, arch):
    """Two sequences of ``REMAT_SEQ`` + 1 seeded tokens (and frames)."""
    inp = np.load(root / f"inputs-{arch}.npz")
    rng = np.random.default_rng(8)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, 128, (2, REMAT_SEQ + 1)).astype(np.int32))}
    if _whisper(arch):
        batch["audio_embed"] = torch.from_numpy(inp["audio"])
    return batch


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


@pytest.fixture(scope="module")
def port_one(root):
    """The port's whisper cases on one device (the spread terms of
    ``_whisper_bounds``): encoder output, logits, step 1's gradients and
    the three steps' losses."""
    from repro_torch.configs import registry as treg
    from repro_torch.configs.registry import ShapeCell
    from repro_torch.convert import params_from_reference
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.launch import train
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import adamw

    out = {}
    mesh = make_mesh((1, 1, 1), AXES, device="cpu")
    for arch, override in {(a, o) for a, _s, o in CASES if _whisper(a)}:
        wkey = _weights_key(arch, override)
        model = treg.build_model(arch, mesh, smoke=True)
        if override:
            model = train.rebuild(model, dataclasses.replace(model.cfg, **dict(override)))
        inp = {k: torch.from_numpy(v) for k, v in np.load(root / f"inputs-{wkey}.npz").items()}
        params = params_from_reference(_unflat(dict(np.load(root / f"params-{wkey}.npz"))), "cpu")
        with torch.no_grad():
            res = {"enc": model.encode(params, inp["audio"]).numpy(),
                   "logits": model.dec_logits(params, inp["tokens"], inp["enc"]).numpy()}
        ocfg = adamw.AdamWConfig(lr=LR, warmup_steps=1)
        opt = adamw.init(params, ocfg)
        step = build_train_step(model, mesh, ocfg, cell=ShapeCell("t", SEQ, BATCH, "train")).fn
        data = TokenPipeline(DataConfig(vocab=model.cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                                        seed=SEED), mesh)
        res["losses"] = []
        try:
            for i in range(STEPS):
                batch = {**next(data), "audio_embed": inp["train_audio"]}
                params, opt, stats = step(params, opt, batch)
                res["losses"].append(float(stats["loss"]))
                if i == 0:
                    res["grad"] = {k: t.numpy().copy() for k, t in _flat(opt.m).items()}
        finally:
            data.close()
        out[wkey] = res
    return out


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def _leaf_rel(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _whisper_bounds(name, reference, port_one):
    """Whisper's bounds against the reference on the same mesh: the two
    packages' difference on one device (at least the other families'
    bound) plus twice the reference's own 1-versus-4-device spread (once
    for the reference's mesh, once for the port's), all measured here. Its
    init amplifies f32 rounding (ROADMAP Queue 3 item 3); an operator at
    fault (a gradient summed tp times, a bias added tp times) moves these
    by O(1). Returns ({stage: bound}, the reference's largest gradient
    spread over a leaf's norm)."""
    arch, _s, override = CASES[NAMES.index(name)]
    one, ref = port_one[_weights_key(arch, override)], reference[0]
    bounds = {stage: max(LOGITS_RTOL, _rel(one[stage], ref[f"{name}/{stage}1"]))
              + 2 * _rel(ref[f"{name}/{stage}1"], ref[f"{name}/{stage}"])
              for stage in ("enc", "logits")}
    keys = list(one["grad"])
    spread = max(_leaf_rel(ref[f"{name}/grad1/{k}"], ref[f"{name}/grad/{k}"]) for k in keys)
    bounds["grad"] = max(GRAD_RTOL, max(_leaf_rel(one["grad"][k], ref[f"{name}/grad1/{k}"])
                                        for k in keys)) + 2 * spread
    r4, r1 = np.array(reference[1][name]["losses"]), np.array(reference[1][name]["losses1"])
    bounds["losses"] = np.maximum(LOSS_RTOL, np.abs(np.array(one["losses"]) - r1) / np.abs(r4)) \
        + 2 * np.abs(r1 - r4) / np.abs(r4)
    return bounds, spread


# ---------------------------------------------------------------------------
# the tests (the port's world first, so no test waits for both)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,override", [(a, ()) for a in ARCHS]
                         + [("recurrentgemma-2b", (("n_heads", 6),)),
                            ("whisper-large-v3", (("vocab", 130),)),
                            ("mamba2-370m", (("vocab", 130),)),
                            ("mamba2-370m", (("ssm_head_dim", 32),))])
@pytest.mark.parametrize("shape", [(1, 2, 2), (1, 1, 4)])
@pytest.mark.parametrize("full", [False, True])
def test_param_specs_equal_the_reference(arch, override, shape, full):
    """``param_specs`` names the reference's mesh axes for every dim of every
    leaf, at the smoke widths and the full ones (a dim that ``model`` does
    not divide stays whole in both)."""
    from repro.configs import registry as jreg

    from repro_torch.configs import registry as treg
    from repro_torch.distributed.mesh import Mesh

    port_mesh = Mesh(dict(zip(AXES, shape)), (torch.device("cpu"),))
    ref_mesh = types.SimpleNamespace(shape=dict(zip(AXES, shape)), axis_names=AXES)
    tm, jm = treg.build_model(arch, smoke=not full), jreg.build_model(arch, smoke=not full)
    if override:
        tm = type(tm)(dataclasses.replace(tm.cfg, **dict(override)))
        jm = type(jm)(dataclasses.replace(jm.cfg, **dict(override)), None)
    got, want = _flat(tm.param_specs(port_mesh)), _flat(jm.param_specs(ref_mesh))
    assert sorted(got) == sorted(want)
    for key in want:
        assert tuple(got[key]) == tuple(want[key]), key


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_over_the_model_axis_raises(arch, port):
    """Once a refusal (ROADMAP Queue 1 item 6c), now run: ``decode_step``
    over (1, 1, 4) on the smoke config (whisper's after ``prefill_cross``),
    on this rank's blocks of the weights and of a cache cut by
    ``cache_specs``, gives the one-device decode's logits within
    ``LOGITS_RTOL`` of the largest (``test_torch_serve_tp_families`` holds
    it to the reference)."""
    got, want = port[0][0][f"serve/{arch}/mesh"], port[0][0][f"serve/{arch}/one"]
    assert got.shape == want.shape == (2, SERVE_STEPS, 128) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= LOGITS_RTOL * np.abs(want).max()


@pytest.mark.parametrize("what", ["gather", "stat"])
def test_operators_match_one_rank(what, port):
    """``_gather_in``: forward the whole X on every rank, backward the sum of
    every rank's gradient, this rank's block (a reduce-scatter).
    ``_sum_stat``: forward the sum of the blocks' statistics, backward
    summed over ``model``. Each against the same function of the whole X
    on one rank."""
    for arrays in port[0]:
        if what == "gather":
            x = np.random.default_rng(5).standard_normal((2, 3, 8)).astype(np.float32)
            assert arrays["op/gather/y"].tobytes() == x.tobytes()
        else:
            np.testing.assert_allclose(arrays["op/stat/s"], arrays["op/stat/want_s"], rtol=1e-6)
        np.testing.assert_allclose(arrays[f"op/{what}/grad"], arrays[f"op/{what}/want_grad"],
                                   rtol=1e-5, atol=1e-6)


def _bounds(name, reference, port_one):
    if name.startswith("whisper"):
        return _whisper_bounds(name, reference, port_one)[0]
    return {"logits": LOGITS_RTOL, "grad": GRAD_RTOL, "losses": LOSS_RTOL}


@pytest.mark.parametrize("name", NAMES)
def test_logits_match_the_reference(name, port, reference, port_one):
    """Gathered logits within LOGITS_RTOL of the largest; whisper's encoder
    output and ``dec_logits`` each on the same inputs, within
    ``_whisper_bounds``."""
    bounds = _bounds(name, reference, port_one)
    for stage in ("enc", "logits") if name.startswith("whisper") else ("logits",):
        got, want = port[0][0][f"{name}/{stage}"], reference[0][f"{name}/{stage}"]
        assert got.shape == want.shape
        assert _rel(got, want) <= bounds[stage], stage


@pytest.mark.parametrize("name", [n for n in NAMES if n.startswith("whisper")])
def test_whisper_bounds_stay_small(name, reference, port_one):
    """The measured terms of whisper's bounds: the reference's own
    1-versus-4-device gradient spread under WHISPER_SPREAD_MAX, and every
    bound far below what a wrong operator gives (a gradient summed tp
    times, a bias added tp times: O(1))."""
    bounds, spread = _whisper_bounds(name, reference, port_one)
    assert 0 < spread <= WHISPER_SPREAD_MAX
    assert bounds["grad"] <= 2 * WHISPER_SPREAD_MAX
    assert max(bounds["enc"], bounds["logits"]) <= 5 * LOGITS_RTOL
    assert bounds["losses"][0] <= 2 * LOSS_RTOL and np.all(bounds["losses"] <= 1e-2)


@pytest.mark.parametrize("name", NAMES)
def test_step1_gradients_match_the_reference(name, port, reference, port_one):
    """Step 1's gradients (AdamW's first moment after step 1: meaned over
    pod x data and clipped), gathered over ``model``, leaf by leaf within
    GRAD_RTOL of the norm of the reference's on the same mesh; whisper's
    within ``_whisper_bounds``."""
    bound = _bounds(name, reference, port_one)["grad"]
    got = {k: v for k, v in port[0][0].items() if k.startswith(f"{name}/grad/")}
    want = {k: v for k, v in reference[0].items() if k.startswith(f"{name}/grad/")}
    assert got and sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        assert np.linalg.norm(got[k] - w) <= bound * np.linalg.norm(w), k


@pytest.mark.parametrize("name", NAMES)
def test_train_steps_match_the_reference(name, port, reference, root, port_one):
    """Losses of every step and step 1's grad norm within LOSS_RTOL; the
    whole params after step 1 within UPDATE_RTOL of the norm of the
    reference's update over the elements whose AdamW denominator is
    settled, and the others within 2·lr (``test_torch_tp``'s bounds).
    Whisper's later losses follow a trajectory that its init bends by
    rounding: each step's within ``_whisper_bounds``."""
    arrays, meta = port
    ref_arrays, ref_meta = reference
    got, want = np.array(meta[0][name]["losses"]), np.array(ref_meta[name]["losses"])
    assert np.all(np.abs(got - want) <= _bounds(name, reference, port_one)["losses"] * np.abs(want))
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(meta[0][name]["grad_norms"][0], ref_meta[name]["grad_norms"][0],
                               rtol=LOSS_RTOL)
    arch, _s, override = CASES[NAMES.index(name)]
    init = dict(np.load(root / f"params-{_weights_key(arch, override)}.npz"))
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


# the leaves each case must cut over ``model`` and keep whole (a subset of each)
CUT = {"mamba2-370m": {"blocks/norm_scale", "blocks/w_out", "embed"},
       "recurrentgemma-2b": {"rec0/wx", "rec0/wa", "rec0/wxg", "rec0/conv_w", "rec0/lam",
                             "rec0/wo", "rec1/mo", "attn/mi", "embed"},
       "whisper-large-v3": {"enc/self/wq", "dec/cross/wk", "dec/mlp/w1", "dec/mlp/b1",
                            "enc/mlp/w2"}}
WHOLE = {"mamba2-370m": {"blocks/w_in", "blocks/conv_w", "blocks/A_log", "blocks/D",
                         "blocks/dt_bias", "blocks/ln", "final_norm"},
         "recurrentgemma-2b": {"rec0/ln", "attn/wk", "attn/wv", "final_norm"},
         "whisper-large-v3": {"pos_dec", "dec/mlp/b2", "enc/self/ln_s", "dec_norm_b"}}


@pytest.mark.parametrize("name", NAMES)
def test_every_model_rank_has_the_same_losses_and_whole_leaves(name, port):
    """Every rank reports the same losses and grad norms, and every leaf is
    bit-equal after every step on the ranks that hold the same block of it:
    all four ranks for a leaf no axis cuts, and over a ``data`` axis the
    ranks of one ZeRO block (every weight's ``d_model`` dim). The leaves
    whole over ``model`` are mamba2's ``w_in``, ``conv_w`` and per-head
    leaves, which each rank uses for its own heads, recurrentgemma's one kv
    head, and the whole heads and vocabs of the override cases."""
    arrays, meta = port
    arch, shape, override = CASES[NAMES.index(name)]
    whole, cut = set(meta[0][name]["whole"]), set(meta[0][name]["cut"])
    assert WHOLE[arch] <= whole
    if override == (("n_heads", 6),):
        assert {"attn/wq", "attn/wo"} <= whole and "attn/mi" in cut
    elif override == (("ssm_head_dim", 32),):
        assert {"blocks/norm_scale", "blocks/w_out"} <= cut
    elif override == (("vocab", 130),):
        assert ("embed" in whole) == (shape[2] == 4)
        assert CUT[arch] <= cut
    else:
        assert CUT[arch] <= cut
    for r in range(1, 4):
        assert meta[r][name]["losses"] == meta[0][name]["losses"]
        assert meta[r][name]["grad_norms"] == meta[0][name]["grad_norms"]
    coords = [m[name]["coords"] for m in meta]
    for i in range(STEPS):
        assert_blocks_agree(arrays, coords, meta[0][name]["axes"], f"block/{name}/{i}/")


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_full_over_the_model_axis_matches_one_device(arch, port, root):
    """Each family's smoke config under ``remat="full"`` on (1, 1, 4): the
    loss within LOSS_RTOL and each gathered gradient within GRAD_RTOL of
    the port's one-device step on the same weights (itself held to the
    reference in ``test_torch_{ssm,hybrid,encdec}``)."""
    from repro_torch.configs import registry as treg
    from repro_torch.convert import params_from_reference
    from repro_torch.launch import train
    from repro_torch.launch.steps import _value_and_grad

    model = treg.build_model(arch, smoke=True)
    model = train.rebuild(model, dataclasses.replace(model.cfg, remat="full"))
    whole = params_from_reference(_unflat(dict(np.load(root / f"params-{arch}.npz"))), "cpu")
    loss, grads = _value_and_grad(model, whole, _remat_batch(root, arch))
    arrays, meta = port
    for m in meta:
        np.testing.assert_allclose(m[f"remat/{arch}"], float(loss), rtol=LOSS_RTOL)
    for key, g in _flat(grads).items():
        got = arrays[0][f"remat/{arch}/{key}"]
        assert got.shape == tuple(g.shape), key
        assert np.linalg.norm(got - g.numpy()) <= GRAD_RTOL * np.linalg.norm(g.numpy()), key


def test_every_tensor_sent_is_contiguous(port):
    for meta in port[1]:
        assert meta["not_contiguous"] == []


def test_elastic_resume_over_data_x_model(port, elastic, root, tmp_path):
    """recurrentgemma-2b's smoke config on ``--mesh 2x2`` saves at step 3 and
    runs to 5; ``1x2`` on two ranks resumes step 3 with the same losses of
    steps 4-5. The root's MANIFEST names the leaves, shapes, dtypes and
    chunks of a one-device run's, and step 1's loss is the one-device
    run's."""
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
