"""The port's decode and prefill over the model axis against the reference's,
on four CPU ranks.

The dense family's smoke configs: gemma-2b (one kv head, tied, head_dim
16), yi-34b (six heads, whole on four ranks under the train specs; two kv
heads; head_dim 8) and internvl2-2b (untied unembedding), each on
(1, 1, 4) and (1, 2, 2) pod x data x model meshes, under the train specs
(``param_specs``; over ``data`` their ``d_model`` dims are cut and
gathered a layer at a time) and under the weight-stationary serve specs
(``param_specs(serve=True)``: head_dim, ffn and vocab over ``model``). The
cache of ``T`` = 16 positions is cut by ``cache_specs`` (batch over pod x
data, time over ``model``), and a seeded 12-token sequence is fed through
decode token by token (teacher-forced, so no argmax tie forks the runs):
the early steps leave whole time blocks empty on some ranks. The port runs
in one world of four gloo ranks (``test_torch_collectives.spawn_world``),
each rank on its blocks of the reference's weights
(``test_torch_models.seeded_params``, crossed over with
``convert.params_from_reference``, then ``launch.train.shard_state`` by the
specs of ``build_serve_step``'s bundle); the reference decodes the same
cases on four fake devices in one subprocess, placed by its
``param_specs(mesh, serve=...)`` and ``cache_specs``, started before the
port's world so the two overlap. Held, case by case:

  * every step's f32 logits, gathered, within ``LOGITS_RTOL`` of the
    largest logit, against the reference on the same mesh and layout and
    against the port's one-device decode;
  * each rank's block of the position cache ``p`` bit-equal to its block
    of the one-device ``p``;
  * prefill's last-position logits over ``model`` (``build_prefill_step``,
    train specs) against the reference's on the same mesh, within
    ``LOGITS_RTOL``;
  * every tensor handed to ``torch.distributed`` contiguous.

Then ``launch.serve.main --mesh 1x1x4 --device cpu --smoke`` in the same
world: its sample equals the one-device run's; and qwen3-moe's decode,
serve step and prefill step over (1, 1, 4) return the reference's shapes
(the other families are held to the reference in
``test_torch_serve_tp_families``). Without a world: the serve specs,
``kv_cache_spec`` and every family's ``cache_specs`` equal the
reference's entry for entry; the MoE's serve specs are its train specs
(the reference's ``param_specs`` takes no ``serve``). In the same world, a
decode whose cache time is cut over ``data`` or ``pod`` (B = 1, once a
refusal) equals the one-device decode: gemma-2b on (1, 2, 2), (2, 1, 2)
and (1, 4, 1), recurrentgemma-2b and whisper-large-v3 on (1, 2, 2)
(``test_torch_serve_time_cut`` holds every family to the reference
there). JAX is imported only in the reference's subprocess and in the
spec tests.
"""
import contextlib
import io
import json
import types

import numpy as np
import pytest
import torch

from test_torch_collectives import spawn_world
from test_torch_dist_train import (
    _flat, _require_contiguous, _unflat, finish_multidevice, start_multidevice)

LOGITS_RTOL = 2e-5                 # of the largest logit: f32, summation order only
AXES = ("pod", "data", "model")
ARCHS = ("gemma-2b", "yi-34b", "internvl2-2b")
SHAPES = ((1, 1, 4), (1, 2, 2))
B, T, S = 4, 16, 12                # batch, cache positions, tokens fed
CASES = [(arch, shape, serve) for arch in ARCHS for shape in SHAPES for serve in (False, True)]
PREFILLS = [(arch, shape) for arch in ARCHS for shape in SHAPES]
SERVE_ARGS = ["--arch", "gemma-2b", "--smoke", "--device", "cpu", "--batch", "4",
              "--prompt-len", "6", "--gen", "8", "--seed", "2"]
MOE_ARCH = "qwen3-moe-30b-a3b"
BATCH_ONE = [("gemma-2b", shape) for shape in ((1, 2, 2), (2, 1, 2), (1, 4, 1))] + \
    [(arch, (1, 2, 2)) for arch in ("recurrentgemma-2b", "whisper-large-v3")]


def _name(arch, shape, serve):
    return f"{arch}-{'x'.join(map(str, shape))}-{'serve' if serve else 'train'}"


NAMES = [_name(*c) for c in CASES]
PREFILL_NAMES = [_name(a, s, False) for a, s in PREFILLS]


# ---------------------------------------------------------------------------
# the inputs: seeded reference weights, tokens, visual embeddings
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def root(tmp_path_factory):
    from repro.configs import registry as jreg
    from test_torch_models import seeded_params

    path = tmp_path_factory.mktemp("serve_tp")
    for arch in ARCHS:
        jm = jreg.build_model(arch, smoke=True)
        np.savez(path / f"params-{arch}.npz", **_flat(seeded_params(jm, 0)))
        cfg = jm.cfg
        rng = np.random.default_rng(17)
        np.savez(path / f"inputs-{arch}.npz",
                 tokens=rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
                 vis=rng.standard_normal((B, max(cfg.n_vis_tokens, 1), cfg.d_model))
                 .astype(np.float32))
    return path


# ---------------------------------------------------------------------------
# the reference: the same cases on four fake devices, in the background
# ---------------------------------------------------------------------------
REFERENCE = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.configs.registry import build_model, ShapeCell
from repro.distributed.mesh import make_mesh
from repro.launch.steps import build_prefill_step

root, CASES, PREFILLS, B, T, S = ARGS
out = {}

def unflat(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree

def put(tree, specs, mesh):
    return jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree, specs)

for arch, shape, serve, name in CASES:
    mesh = make_mesh(tuple(shape), ("pod", "data", "model"), devices=jax.devices()[:4])
    model = build_model(arch, mesh, smoke=True)
    tok = np.load(f"{root}/inputs-{arch}.npz")["tokens"]
    with mesh:
        params = put(unflat(dict(np.load(f"{root}/params-{arch}.npz"))),
                     model.param_specs(mesh, serve=serve), mesh)
        cache = put(model.init_cache(B, T), model.cache_specs(mesh, B, T), mesh)
        step = jax.jit(model.decode_step)
        lgs = []
        for t in range(S):
            lg, cache = step(params, cache, jnp.asarray(tok[:, t:t + 1]),
                             jnp.full((B,), t, jnp.int32))
            lgs.append(np.asarray(lg, np.float32))
    out[f"{name}/decode"] = np.concatenate(lgs, axis=1)

for arch, shape, name in PREFILLS:
    mesh = make_mesh(tuple(shape), ("pod", "data", "model"), devices=jax.devices()[:4])
    model = build_model(arch, mesh, smoke=True)
    inp = np.load(f"{root}/inputs-{arch}.npz")
    b = build_prefill_step(model, mesh, cell=ShapeCell("p", S, B, "prefill"))
    batch = {"tokens": inp["tokens"][:, :b.in_shapes[1]["tokens"].shape[1]]}
    if "vis_embed" in b.in_shapes[1]:
        batch["vis_embed"] = inp["vis"]
    with mesh:
        params = put(unflat(dict(np.load(f"{root}/params-{arch}.npz"))),
                     model.param_specs(mesh), mesh)
        fn = jax.jit(b.fn, in_shardings=b.in_shardings, out_shardings=b.out_shardings)
        out[f"{name}/prefill"] = np.asarray(fn(params, batch), np.float32)
np.savez(root + "/ref.npz", **out)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def reference_started(root):
    cases = [(a, list(s), v, _name(a, s, v)) for a, s, v in CASES]
    prefills = [(a, list(s), _name(a, s, False)) for a, s in PREFILLS]
    code = REFERENCE.replace("ARGS", repr((str(root), cases, prefills, B, T, S)))
    log = open(root / "ref.log", "w")
    proc = start_multidevice(code, 4, log)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    log.close()


# ---------------------------------------------------------------------------
# the port: four gloo ranks
# ---------------------------------------------------------------------------
def _port_serve(rank, root):
    import torch.distributed as dist

    from repro_torch.configs import registry as treg
    from repro_torch.configs.registry import ShapeCell
    from repro_torch.convert import params_from_reference
    from repro_torch.distributed.mesh import P, gather, make_mesh, shard
    from repro_torch.launch import serve, train
    from repro_torch.launch.steps import build_prefill_step, build_serve_step

    loose = _require_contiguous(dist)
    out, meta = {}, {}
    whole, one = {}, {}
    for arch in ARCHS:            # the one-device decode, on every rank
        whole[arch] = params_from_reference(
            _unflat(dict(np.load(root / f"params-{arch}.npz"))), "cpu")
        model = treg.build_model(arch, smoke=True)
        tok = torch.from_numpy(np.load(root / f"inputs-{arch}.npz")["tokens"])
        cache = model.init_cache(B, T, device="cpu")
        lgs = []
        with torch.no_grad():
            for t in range(S):
                lg, cache = model.decode_step(whole[arch], cache, tok[:, t:t + 1],
                                              torch.full((B,), t, dtype=torch.int32))
                lgs.append(lg)
        one[arch] = cache
        if rank == 0:
            out[f"{arch}/one"] = torch.cat(lgs, dim=1).numpy()
    for arch, shape, serve_specs in CASES:
        name = _name(arch, shape, serve_specs)
        mesh = make_mesh(shape, AXES, device="cpu")
        model = treg.build_model(arch, mesh, smoke=True)
        bundle = build_serve_step(model, mesh, cell=ShapeCell("d", T, B, "decode"),
                                  weight_stationary=serve_specs)
        pspecs, cspecs = bundle.specs
        params = train.shard_state(mesh, whole[arch], pspecs)
        cache = train.shard_state(mesh, model.init_cache(B, T, device="cpu"), cspecs)
        rows = P(cspecs["p0"][1], None)
        tok = shard(mesh, torch.from_numpy(np.load(root / f"inputs-{arch}.npz")["tokens"]), rows)
        lgs = []
        with torch.no_grad():
            for t in range(S):
                pos = torch.full((tok.shape[0],), t, dtype=torch.int32)
                lg, cache = model.decode_step(params, cache, tok[:, t:t + 1], pos,
                                              cache_specs=cspecs)
                lgs.append(lg)
            # the bundle's step: the argmax of the same first step's logits
            fresh = train.shard_state(mesh, model.init_cache(B, T, device="cpu"), cspecs)
            nxt, _c, pos1 = bundle.fn(params, fresh, tok[:, :1],
                                      torch.zeros((tok.shape[0],), dtype=torch.int32))
        meta[name] = {"step_argmax": bool(torch.equal(nxt[:, 0], lgs[0][:, 0].argmax(-1).int()))
                      and bool((pos1 == 1).all())}
        lg = gather(mesh, torch.cat(lgs, dim=1), P(cspecs["p0"][1], None, None))
        if rank == 0:
            out[f"{name}/decode"] = lg.numpy()
        out[f"{name}/p"] = cache["p0"].numpy().copy()
        out[f"{name}/p_want"] = shard(mesh, one[arch]["p0"], cspecs["p0"]).numpy().copy()
    for arch, shape in PREFILLS:
        name = _name(arch, shape, False)
        mesh = make_mesh(shape, AXES, device="cpu")
        model = treg.build_model(arch, mesh, smoke=True)
        inp = np.load(root / f"inputs-{arch}.npz")
        step = build_prefill_step(model, mesh, cell=ShapeCell("p", S, B, "prefill"))
        shapes = step.in_shapes[1]
        rows = P(("pod", "data"), None)
        batch = {"tokens": shard(mesh, torch.from_numpy(
            inp["tokens"][:, :shapes["tokens"].shape[1]]), rows)}
        if "vis_embed" in shapes:
            batch["vis_embed"] = shard(mesh, torch.from_numpy(inp["vis"]), P(("pod", "data"),
                                                                           None, None))
        lg = step.fn(train.shard_state(mesh, whole[arch], model.param_specs(mesh)), batch)
        lg = gather(mesh, lg, P(("pod", "data"), None, None))
        if rank == 0:
            out[f"{name}/prefill"] = lg.numpy()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = serve.main(SERVE_ARGS + ["--mesh", "1x1x4"])
    meta["serve_main"] = {"rows": rows.tolist(), "stdout": buf.getvalue()}
    mesh = make_mesh((1, 1, 4), AXES, device="cpu")
    meta["moe"] = _moe_steps(mesh, treg.build_model(MOE_ARCH, mesh, smoke=True))
    meta["batch_one"] = {f"{arch}-{'x'.join(map(str, shape))}": _batch_one(treg, arch, shape)
                         for arch, shape in BATCH_ONE}
    meta["not_contiguous"] = loose
    np.savez(root / f"port{rank}.npz", **out)
    (root / f"port{rank}.json").write_text(json.dumps(meta))


def _batch_one(treg, arch, shape) -> dict:
    """``arch``'s decode at B = 1 over ``shape`` (its cache time cut over
    ``data`` or ``pod`` too) against the one-device decode of the same
    seeded weights and tokens (whisper's after ``prefill_cross`` of seeded
    frames): the largest logit difference over the largest logit."""
    from repro_torch.configs.registry import ShapeCell
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.launch import train
    from repro_torch.launch.steps import build_serve_step

    one = treg.build_model(arch, smoke=True)
    whole = one.init_params(0, "cpu")
    gen = torch.Generator().manual_seed(5)
    tok = torch.randint(0, one.cfg.vocab, (1, S), generator=gen, dtype=torch.int32)
    audio = torch.randn((1, one.cfg.enc_positions, one.cfg.d_model), generator=gen)
    mesh = make_mesh(shape, AXES, device="cpu")
    model = treg.build_model(arch, mesh, smoke=True)
    pspecs, cspecs = build_serve_step(model, mesh, cell=ShapeCell("d", T, 1, "decode")).specs
    lgs = {}
    with torch.no_grad():
        for tag, m, params, kw in (
                ("one", one, whole, {}),
                ("mesh", model, train.shard_state(mesh, whole, pspecs), {"cache_specs": cspecs})):
            cache = m.init_cache(1, T, device="cpu")
            if kw:
                cache = train.shard_state(mesh, cache, cspecs)
            if arch.startswith("whisper"):
                cache = m.prefill_cross(params, cache, audio, **kw)
            lgs[tag] = torch.cat([m.decode_step(params, cache, tok[:, t:t + 1],
                                                torch.full((1,), t, dtype=torch.int32), **kw)[0]
                                  for t in range(S)], dim=1)
    err = (lgs["mesh"] - lgs["one"]).abs().max() / lgs["one"].abs().max()
    return {"rel": float(err), "time_axes": list(model._time_cut(cspecs[next(
        k for k in cspecs if k.startswith(("p", "ap")))]))}


def _moe_steps(mesh, model) -> dict:
    """qwen3-moe's decode, serve step and prefill step over ``mesh``, on
    this rank's blocks of seeded weights: the shapes each returns (this
    rank's blocks of the cache), and whether the bundle's specs are
    ``(param_specs(mesh), cache_specs(mesh, B, T))``."""
    from repro_torch.configs.registry import ShapeCell
    from repro_torch.launch import train
    from repro_torch.launch.steps import build_prefill_step, build_serve_step

    def shapes(tree):
        return {k: list(t.shape) for k, t in tree.items()}

    bundle = build_serve_step(model, mesh, cell=ShapeCell("d", T, B, "decode"))
    pspecs, cspecs = bundle.specs
    params = train.shard_state(mesh, model.init_params(0, "cpu"), pspecs)
    tok, pos = torch.ones((B, 1), dtype=torch.int32), torch.zeros((B,), dtype=torch.int32)

    def fresh():
        return train.shard_state(mesh, model.init_cache(B, T, device="cpu"), cspecs)

    with torch.no_grad():
        lg, cache = model.decode_step(params, fresh(), tok, pos, cache_specs=cspecs)
        nxt, cache2, pos1 = bundle.fn(params, fresh(), tok, pos)
        prefill = build_prefill_step(model, mesh, cell=ShapeCell("p", S, B, "prefill"))
        plg = prefill.fn(params, {"tokens": torch.ones((B, S), dtype=torch.int32)})
    return {"decode": [list(lg.shape), shapes(cache)],
            "serve_step": [list(nxt.shape), shapes(cache2), list(pos1.shape)],
            "prefill_step": [list(plg.shape)],
            "finite": bool(torch.isfinite(lg).all() and torch.isfinite(plg).all()),
            "specs_equal": [_flat(pspecs) == _flat(model.param_specs(mesh)),
                            cspecs == model.cache_specs(mesh, B, T)]}


@pytest.fixture(scope="module")
def port(root, reference_started):
    spawn_world(_port_serve, 4, (root,), root, timeout=240)
    arrays = [dict(np.load(root / f"port{r}.npz")) for r in range(4)]
    meta = [json.loads((root / f"port{r}.json").read_text()) for r in range(4)]
    return arrays, meta


@pytest.fixture(scope="module")
def reference(port, root, reference_started):
    finish_multidevice(reference_started, root / "ref.log", 420, "REFERENCE_OK")
    return dict(np.load(root / "ref.npz"))


# ---------------------------------------------------------------------------
# the tests on four ranks (the port's world first, so no test waits for both)
# ---------------------------------------------------------------------------
def _within(got, want):
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= LOGITS_RTOL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_one_device(name, port):
    """Every step's gathered logits against the port's one-device decode of
    the same weights and tokens, and the bundle's step picks their argmax."""
    arrays, meta = port
    arch = CASES[NAMES.index(name)][0]
    _within(arrays[0][f"{name}/decode"], arrays[0][f"{arch}/one"])
    assert all(m[name]["step_argmax"] for m in meta)


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_the_reference(name, port, reference):
    """Every step's gathered logits against the reference's decode on the
    same mesh, under the same param and cache specs."""
    _within(port[0][0][f"{name}/decode"], reference[f"{name}/decode"])


@pytest.mark.parametrize("name", NAMES)
def test_each_ranks_position_block_is_the_one_device_block(name, port):
    """Each rank's block of the position cache equals, bit for bit, its
    block of the one-device cache: only the rank that holds slot pos % T
    wrote it, and slots 12-15 stayed empty (-1) on the rank that holds
    them."""
    for arrays in port[0]:
        got, want = arrays[f"{name}/p"], arrays[f"{name}/p_want"]
        assert got.shape == want.shape and got.tobytes() == want.tobytes()
    if name.split("-")[-2] == "1x1x4":             # time over 4 ranks: slots 12-15 on rank 3
        assert (port[0][3][f"{name}/p"] == -1).all()


@pytest.mark.parametrize("name", PREFILL_NAMES)
def test_prefill_matches_the_reference(name, port, reference):
    """The last position's logits of ``build_prefill_step`` over ``model``
    (train specs; vocab-parallel unembedding, gathered) against the
    reference's on the same mesh."""
    _within(port[0][0][f"{name}/prefill"], reference[f"{name}/prefill"])


def test_serve_main_over_the_model_axis_matches_one_device(port):
    """``launch.serve.main --mesh 1x1x4`` on four ranks: every rank decodes
    the whole batch (one pod, one data rank), rank 0 alone prints, and the
    sample is the one-device run's."""
    from repro_torch.launch import serve

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        want = serve.main(SERVE_ARGS)
    meta = port[1]
    for m in meta:
        assert m["serve_main"]["rows"] == want.tolist()
    assert "sample: " + str(want[0].tolist()) in meta[0]["serve_main"]["stdout"]
    assert all(m["serve_main"]["stdout"] == "" for m in meta[1:])
    assert buf.getvalue().splitlines()[-1] == "sample: " + str(want[0].tolist())


def test_every_tensor_sent_is_contiguous(port):
    for meta in port[1]:
        assert meta["not_contiguous"] == []


# ---------------------------------------------------------------------------
# specs and refusals, without a world
# ---------------------------------------------------------------------------
SPEC_MESHES = ((1, 1, 4), (1, 2, 2), (2, 2, 1), (1, 4, 1), (2, 1, 2), (4,), (2, 2))


def _meshes(shape):
    from repro_torch.distributed.mesh import Mesh

    axes = {3: AXES, 2: ("data", "model"), 1: ("model",)}[len(shape)]
    return (Mesh(dict(zip(axes, shape)), (torch.device("cpu"),)),
            types.SimpleNamespace(shape=dict(zip(axes, shape)), axis_names=axes))


@pytest.mark.parametrize("shape", SPEC_MESHES)
@pytest.mark.parametrize("batch", [1, 2, 4, 6])
def test_kv_cache_spec_equals_the_reference(shape, batch):
    from repro.models import common as jcm

    from repro_torch.models import common as tcm
    port_mesh, ref_mesh = _meshes(shape)
    for time in (8, 12, 16):
        for extra in ((), (None, None)):
            assert tuple(tcm.kv_cache_spec(port_mesh, batch, time, extra)) == \
                tuple(jcm.kv_cache_spec(ref_mesh, batch, time, extra)), (batch, time)


@pytest.mark.parametrize("arch", ["gemma-2b", "gemma2-2b", "yi-34b", "internvl2-2b"])
@pytest.mark.parametrize("shape", SPEC_MESHES)
def test_cache_specs_equal_the_reference(arch, shape):
    """``cache_specs`` of every kind's cache (gemma2-2b's local layers hold
    a ring of ``window`` = 8 slots in its smoke config)."""
    from repro.configs import registry as jreg

    from repro_torch.configs import registry as treg
    port_mesh, ref_mesh = _meshes(shape)
    tm, jm = treg.build_model(arch, smoke=True), jreg.build_model(arch, smoke=True)
    for batch in (1, 2, 4, 6):
        for time in (8, 12, 16):
            got, want = tm.cache_specs(port_mesh, batch, time), jm.cache_specs(ref_mesh, batch, time)
            assert sorted(got) == sorted(want)
            for key in want:
                assert tuple(got[key]) == tuple(want[key]), (key, batch, time)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "grok-1-314b"])
@pytest.mark.parametrize("shape", [(1, 2, 2), (1, 1, 4)])
def test_moe_serve_specs_are_the_reference_train_specs(arch, shape):
    """The reference's ``MoELM.param_specs`` takes no ``serve``, so its
    ``build_serve_step`` falls back to the train specs: the port's
    ``param_specs(serve=True)`` returns those, entry for entry."""
    from repro.configs import registry as jreg

    from repro_torch.configs import registry as treg
    port_mesh, ref_mesh = _meshes(shape)
    got = _flat(treg.build_model(arch, smoke=True).param_specs(port_mesh, serve=True))
    want = _flat(jreg.build_model(arch, smoke=True).param_specs(ref_mesh))
    assert sorted(got) == sorted(want)
    for key in want:
        assert tuple(got[key]) == tuple(want[key]), key


@pytest.mark.parametrize("what", ["decode", "serve_step", "prefill_step"])
def test_moe_decode_over_the_model_axis_raises(what, port):
    """Once a refusal (ROADMAP Queue 1 item 6b), now run: qwen3-moe's
    decode, the serve step and the prefill step over (1, 1, 4), in the
    port's world, return the reference's shapes (this rank's blocks of its
    cache, cut by ``cache_specs``; finite logits), and the bundle's specs
    are ``(param_specs(mesh), cache_specs(mesh, B, T))``."""
    import jax
    import jax.numpy as jnp
    from repro.configs import registry as jreg

    jm = jreg.build_model(MOE_ARCH, smoke=True)
    tok, pos = jnp.zeros((B, 1), jnp.int32), jnp.zeros((B,), jnp.int32)
    logits, cache = jax.eval_shape(
        lambda: jm.decode_step(jm.init_params(0), jm.init_cache(B, T), tok, pos))
    specs = jm.cache_specs(types.SimpleNamespace(shape=dict(zip(AXES, (1, 1, 4))),
                                                 axis_names=AXES), B, T)
    blocks = {k: [n // (4 if spec[d] == "model" else 1) for d, n in enumerate(c.shape)]
              for (k, c), spec in ((kv, specs[kv[0]]) for kv in cache.items())}
    want = {"decode": [list(logits.shape), blocks],
            "serve_step": [[B, 1], blocks, [B]],
            "prefill_step": [list(logits.shape)]}[what]
    for meta in port[1]:
        assert meta["moe"][what] == want
        assert meta["moe"]["finite"] and meta["moe"]["specs_equal"] == [True, True]


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-2b", "whisper-large-v3"])
def test_other_families_serving_steps_over_the_model_axis_raise(arch, port):
    """Once a refusal (ROADMAP Queue 1 item 6c), now the cut the serving
    steps run on: each family's ``cache_specs`` equals the reference's
    entry for entry, over the spec meshes, batches and times. Once a
    refusal too (item 6d), now run in the port's world: at B = 1 on
    (1, 2, 2) the families whose cache has a time dim cut it over
    ``model`` and ``data``, and their decode equals the one-device
    decode."""
    from repro.configs import registry as jreg

    from repro_torch.configs import registry as treg
    tm, jm = treg.build_model(arch, smoke=True), jreg.build_model(arch, smoke=True)
    for shape in SPEC_MESHES:
        port_mesh, ref_mesh = _meshes(shape)
        for batch in (1, 2, 4, 6):
            for time in (8, 12, 16):
                got = tm.cache_specs(port_mesh, batch, time)
                want = jm.cache_specs(ref_mesh, batch, time)
                assert sorted(got) == sorted(want)
                for key in want:
                    assert tuple(got[key]) == tuple(want[key]), (shape, key, batch, time)
    mesh = _meshes((1, 2, 2))[0]
    specs = treg.build_model(arch, mesh, smoke=True).cache_specs(mesh, 1, 16)
    if arch == "mamba2-370m":           # no time dim: every rank holds the row
        assert specs["ssm"][1] is None and specs["conv"][1] is None
        return
    for meta in port[1]:
        got = meta["batch_one"][f"{arch}-1x2x2"]
        assert got["time_axes"] == ["model", "data"] and got["rel"] <= LOGITS_RTOL, got


@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 1, 2), (1, 4, 1)])
def test_time_cut_over_data_or_pod_raises(shape, port):
    """Once a refusal (ROADMAP Queue 1 item 6d), now run: at B = 1 on a
    mesh with pod x data over 1, ``kv_cache_spec`` cuts the time dim over
    ``data`` or ``pod`` too (long-context decode), and gemma-2b's decode
    over that cache, in the port's world, equals the one-device decode on
    every rank."""
    from repro_torch.configs import registry as treg

    mesh = _meshes(shape)[0]
    specs = treg.build_model("gemma-2b", mesh, smoke=True).cache_specs(mesh, 1, 16)
    assert set(specs["p0"][2]) & {"data", "pod"}
    for meta in port[1]:
        got = meta["batch_one"][f"gemma-2b-{'x'.join(map(str, shape))}"]
        cut = [a for a in specs["p0"][2] if shape[AXES.index(a)] > 1]
        assert got["time_axes"] == cut and got["rel"] <= LOGITS_RTOL, got
