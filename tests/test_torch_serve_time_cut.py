"""The port's decode at a batch that pod x data does not divide (B = 1), whose
cache time is cut over ``data`` and ``pod`` as well as ``model``, against
the reference's, on four CPU ranks.

At B = 1 the reference's ``kv_cache_spec`` leaves the batch whole and cuts
the time dim over every axis that divides it, in the order model, data,
pod (long-context decode: what makes its ``long_500k`` cells fit). The
smoke configs of gemma-2b (one kv head; under the train specs and under
the weight-stationary serve specs), gemma2-2b (local and global layers,
soft-caps), qwen3-moe-30b-a3b (one token over the expert columns, the rest
padding), recurrentgemma-2b (a ring of 8 slots over 12 tokens: it wraps),
whisper-large-v3 (``prefill_cross`` from seeded frames, then decode) and
mamba2-370m (no time dim: every rank holds the row), each on (1, 2, 2),
(2, 1, 2) and (1, 4, 1) pod x data x model meshes, decode a seeded
12-token sequence token by token (teacher-forced) over a cache of ``T`` =
16 positions cut by ``cache_specs``: blocks of 4 (gemma2-2b's and
recurrentgemma-2b's rings: of 2), so the steps cross time-block
boundaries. The port runs in one world of four gloo ranks
(``test_torch_collectives.spawn_world``), each rank on its blocks of the
reference's weights (``test_torch_models.seeded_params``, crossed over
with ``convert.params_from_reference``, then ``launch.train.shard_state``
by the specs of ``build_serve_step``'s bundle); the reference decodes the
same cases on four fake devices in one subprocess, started first so the
two overlap. Held, case by case:

  * every step's f32 logits within ``LOGITS_RTOL`` of the largest logit,
    against the reference on the same mesh and layout and against the
    port's one-device decode of the same weights (whisper against the
    reference within the bound this test measures, as
    ``test_torch_serve_tp_families`` holds it); every rank's logits equal
    rank 0's bit for bit. The reference's MoE block is a ``shard_map``
    whose rows split over pod x data, so it refuses a batch of 1 on these
    meshes: the port's MoE is held to its one-device decode and routes;
  * each rank's blocks of every cache leaf against its blocks of the
    one-device cache: the positions bit for bit (only the rank that holds
    slot pos % T wrote it), the float blocks within ``LOGITS_RTOL`` of
    the block's largest value (after the first layer the ranks' partial
    softmaxes are summed in another order than one device's softmax);
  * the MoE's top-k choices at every step equal to the one-device run's;
  * every tensor handed to ``torch.distributed`` contiguous.

Then ``launch.serve.main --mesh 1x2x2 --batch 1 --device cpu --smoke`` in
the same world: every rank decodes the one row, rank 0 alone prints, and
the sample is the one-device run's. JAX is imported only in the
reference's subprocess.
"""
import contextlib
import io
import json

import numpy as np
import pytest
import torch

from test_torch_collectives import spawn_world
from test_torch_dist_train import (
    _flat, _require_contiguous, _unflat, finish_multidevice, start_multidevice)
from test_torch_serve_tp_families import _model, _moe, _one_device, _route_flips, _whisper

LOGITS_RTOL = 2e-5                 # of the largest logit: f32, summation order only
AXES = ("pod", "data", "model")
SHAPES = ((1, 2, 2), (2, 1, 2), (1, 4, 1))
ARCHS = (("gemma-2b", False), ("gemma-2b", True), ("gemma2-2b", False),
         ("qwen3-moe-30b-a3b", False), ("recurrentgemma-2b", False),
         ("whisper-large-v3", False), ("mamba2-370m", False))
B, T, S = 1, 16, 12                # batch, cache positions, tokens fed
CASES = [(arch, shape, serve) for arch, serve in ARCHS for shape in SHAPES]
SERVE_ARCHS = ("gemma-2b", "gemma2-2b", "recurrentgemma-2b")
SERVE_ARGS = ["--smoke", "--device", "cpu", "--batch", "1", "--prompt-len", "6",
              "--gen", "8", "--seed", "2"]


def _name(arch, shape, serve):
    return f"{arch}-{'x'.join(map(str, shape))}" + ("-serve" if serve else "")


def _weights_key(arch, tp):
    """A MoE's expert leaves are laid out for the model axis's size."""
    return arch + (f"-tp{tp}" if _moe(arch) else "")


NAMES = [_name(*c) for c in CASES]
WHISPER_NAMES = [n for n in NAMES if _whisper(n)]
REF_NAMES = [n for n in NAMES if not _moe(n)]      # the reference's MoE refuses B = 1 here
CUT_NAMES = [n for n in NAMES if not n.startswith("mamba2")]


# ---------------------------------------------------------------------------
# the inputs: seeded reference weights, tokens, frames
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def root(tmp_path_factory):
    from repro.configs import registry as jreg
    from test_torch_models import seeded_params

    path = tmp_path_factory.mktemp("serve_time_cut")
    for arch, shape, _serve in CASES:
        key = _weights_key(arch, shape[2])
        if (path / f"params-{key}.npz").exists():
            continue
        jm = jreg.build_model(arch, smoke=True)
        jm.tp = shape[2] if _moe(arch) else 1
        np.savez(path / f"params-{key}.npz", **_flat(seeded_params(jm, 0)))
    for arch, _serve in ARCHS:
        cfg = jreg.build_model(arch, smoke=True).cfg
        rng = np.random.default_rng(23)
        np.savez(path / f"inputs-{arch}.npz",
                 tokens=rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
                 audio=rng.standard_normal((B, cfg.enc_positions, cfg.d_model))
                 .astype(np.float32))
    return path


# ---------------------------------------------------------------------------
# the reference: the same cases on four fake devices, in the background
# ---------------------------------------------------------------------------
REFERENCE = """
import math
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.configs.registry import build_model
from repro.distributed.mesh import make_mesh

root, CASES, B, T, S = ARGS
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

for arch, shape, serve, name, wkey, one in CASES:
    inp = np.load(f"{root}/inputs-{arch}.npz")
    # whisper also on one device: the reference's own spread bounds the comparison
    for tag, where in [("", shape)] + ([("1", (1, 1, 1))] if one else []):
        mesh = make_mesh(tuple(where), ("pod", "data", "model"),
                         devices=jax.devices()[:math.prod(where)])
        model = build_model(arch, mesh, smoke=True)
        specs = model.param_specs(mesh, serve=True) if serve else model.param_specs(mesh)
        with mesh:
            params = put(unflat(dict(np.load(f"{root}/params-{wkey}.npz"))), specs, mesh)
            cspecs = model.cache_specs(mesh, B, T)
            cache = put(model.init_cache(B, T), cspecs, mesh)
            if arch.startswith("whisper"):
                cache = put(jax.jit(model.prefill_cross)(params, cache,
                                                         jnp.asarray(inp["audio"])),
                            cspecs, mesh)
            step = jax.jit(model.decode_step)
            lgs = []
            for t in range(S):
                lg, cache = step(params, cache, jnp.asarray(inp["tokens"][:, t:t + 1]),
                                 jnp.full((B,), t, jnp.int32))
                lgs.append(np.asarray(lg, np.float32))
        out[f"{name}/decode{tag}"] = np.concatenate(lgs, axis=1)
np.savez(root + "/ref.npz", **out)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def reference_started(root):
    cases = [(a, list(s), v, _name(a, s, v), _weights_key(a, s[2]), _whisper(a))
             for a, s, v in CASES if _name(a, s, v) in REF_NAMES]
    code = REFERENCE.replace("ARGS", repr((str(root), cases, B, T, S)))
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
def _port_time_cut(rank, root):
    import torch.distributed as dist

    from repro_torch.configs import registry as treg
    from repro_torch.configs.registry import ShapeCell
    from repro_torch.convert import params_from_reference
    from repro_torch.distributed.mesh import MODEL, P, make_mesh, shard
    from repro_torch.launch import serve, train
    from repro_torch.launch.steps import build_serve_step

    loose = _require_contiguous(dist)
    out, meta = {}, {}
    for arch, shape, serve_specs in CASES:
        name = _name(arch, shape, serve_specs)
        flat = dict(np.load(root / f"params-{_weights_key(arch, shape[2])}.npz"))
        inp = dict(np.load(root / f"inputs-{arch}.npz"))
        one_lg, one_cache, one_routes = _one_device(treg, arch, (), shape[2], flat, inp, B)
        mesh = make_mesh(shape, AXES, device="cpu")
        model = _model(treg, arch, mesh)
        bundle = build_serve_step(model, mesh, cell=ShapeCell("d", T, B, "decode"),
                                  weight_stationary=serve_specs)
        pspecs, cspecs = bundle.specs
        params = train.shard_state(mesh, params_from_reference(_unflat(flat), "cpu"), pspecs)
        tok = torch.from_numpy(inp["tokens"])
        audio = torch.from_numpy(inp["audio"])

        def fresh():
            cache = train.shard_state(mesh, model.init_cache(B, T, device="cpu"), cspecs)
            if _whisper(arch):
                cache = model.prefill_cross(params, cache, audio, cache_specs=cspecs)
            return cache

        lgs = []
        with torch.no_grad():
            cache = fresh()
            if _moe(arch):
                model.route_log = []
            for t in range(S):
                lg, cache = model.decode_step(params, cache, tok[:, t:t + 1],
                                              torch.full((B,), t, dtype=torch.int32),
                                              cache_specs=cspecs)
                lgs.append(lg)
            routes = None
            if _moe(arch):
                routes, model.route_log = model.route_log, None
            # the bundle's step: the argmax of the same first step's logits
            nxt, _c, pos1 = bundle.fn(params, fresh(), tok[:, :1],
                                      torch.zeros((B,), dtype=torch.int32))
        lg = torch.cat(lgs, dim=1)
        meta[name] = {"step_argmax": bool(torch.equal(nxt[:, 0], lgs[0][:, 0].argmax(-1).int()))
                      and bool((pos1 == 1).all()),
                      "specs_equal": [cspecs == model.cache_specs(mesh, B, T),
                                      cspecs[next(iter(cspecs))][1] is None]}
        if routes is not None:
            meta[name]["routes"] = _route_flips(routes, one_routes, torch.arange(B), shape[2],
                                                mesh.rank(MODEL), model.cfg.top_k)
        out[f"{name}/decode"] = lg.numpy()
        if rank == 0:
            out[f"{name}/one"] = one_lg.numpy()
        for key, spec in cspecs.items():
            out[f"{name}/cache/{key}"] = cache[key].numpy().copy()
            out[f"{name}/want/{key}"] = shard(mesh, one_cache[key], spec).numpy().copy()
    meta["serve_main"] = {}
    for arch in SERVE_ARCHS:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            got = serve.main(["--arch", arch] + SERVE_ARGS + ["--mesh", "1x2x2"])
        meta["serve_main"][arch] = {"rows": got.tolist(), "stdout": buf.getvalue()}
    meta["not_contiguous"] = loose
    np.savez(root / f"port{rank}.npz", **out)
    (root / f"port{rank}.json").write_text(json.dumps(meta))


@pytest.fixture(scope="module")
def port(root, reference_started):
    spawn_world(_port_time_cut, 4, (root,), root, timeout=300)
    arrays = [dict(np.load(root / f"port{r}.npz")) for r in range(4)]
    meta = [json.loads((root / f"port{r}.json").read_text()) for r in range(4)]
    return arrays, meta


@pytest.fixture(scope="module")
def reference(port, root, reference_started):
    finish_multidevice(reference_started, root / "ref.log", 600, "REFERENCE_OK")
    return dict(np.load(root / "ref.npz"))


# ---------------------------------------------------------------------------
# the tests on four ranks (the port's world first, so no test waits for both)
# ---------------------------------------------------------------------------
def _rel(got, want):
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _bound(name, port_one, reference):
    """Whisper's bound against the reference on the same mesh: the two
    packages' difference on one device (at least ``LOGITS_RTOL``) plus
    twice the reference's own 1-versus-4-device spread, all measured here.
    The other families': ``LOGITS_RTOL``."""
    if not _whisper(name):
        return LOGITS_RTOL
    ref1 = reference[f"{name}/decode1"]
    return max(LOGITS_RTOL, _rel(port_one, ref1)) + 2 * _rel(ref1, reference[f"{name}/decode"])


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_one_device(name, port):
    """Every step's logits against the port's one-device decode of the same
    weights and tokens, bit-equal on every rank; the bundle's step picks
    their argmax, and its cache specs are ``cache_specs(mesh, 1, T)``,
    which leave the batch whole."""
    arrays, meta = port
    assert _rel(arrays[0][f"{name}/decode"], arrays[0][f"{name}/one"]) <= LOGITS_RTOL
    for a in arrays[1:]:
        assert a[f"{name}/decode"].tobytes() == arrays[0][f"{name}/decode"].tobytes()
    assert all(m[name]["step_argmax"] and m[name]["specs_equal"] == [True, True] for m in meta)


@pytest.mark.parametrize("name", REF_NAMES)
def test_decode_matches_the_reference(name, port, reference):
    """Every step's logits against the reference's decode on the same mesh,
    under the same param and cache specs."""
    got, want = port[0][0][f"{name}/decode"], reference[f"{name}/decode"]
    assert _rel(got, want) <= _bound(name, port[0][0][f"{name}/one"], reference)


@pytest.mark.parametrize("name", WHISPER_NAMES)
def test_whispers_bound_is_near_the_others(name, port, reference):
    """Whisper's measured bound stays within 10x the other families'."""
    assert _bound(name, port[0][0][f"{name}/one"], reference) <= 10 * LOGITS_RTOL


@pytest.mark.parametrize("name", NAMES)
def test_each_ranks_cache_blocks_are_the_one_device_blocks(name, port):
    """Each rank's blocks of every cache leaf against its blocks of the
    one-device cache: positions bit for bit, the float blocks within
    ``LOGITS_RTOL`` of the block's largest value."""
    keys = [k.split("/cache/")[1] for k in port[0][0] if k.startswith(f"{name}/cache/")]
    assert keys
    for arrays in port[0]:
        for key in keys:
            got, want = arrays[f"{name}/cache/{key}"], arrays[f"{name}/want/{key}"]
            assert got.shape == want.shape, key
            if got.dtype.kind == "i":
                assert got.tobytes() == want.tobytes(), key
            elif np.abs(want).max() > 0:
                assert _rel(got, want) <= LOGITS_RTOL, key
            else:
                assert not np.abs(got).any(), key


@pytest.mark.parametrize("name", CUT_NAMES)
def test_the_steps_cross_time_blocks(name, port):
    """The time dim is cut four ways on every mesh here: each rank holds a
    quarter of every position cache, and the 12 steps wrote slots on at
    least three ranks (the owner moved across block boundaries; a ring of
    8 wrapped, so every rank holds written slots)."""
    keys = [k.split("/cache/")[1] for k in port[0][0]
            if k.startswith(f"{name}/cache/") and port[0][0][k].dtype.kind == "i"]
    assert keys
    for key in keys:
        blocks = [a[f"{name}/cache/{key}"] for a in port[0]]
        whole = port[0][0][f"{name}/want/{key}"].shape[-1] * 4
        wrote = sum(bool((b >= 0).any()) for b in blocks)
        assert wrote >= 3 and (whole > 8 or wrote == 4), (key, wrote)
        assert max(int(b.max()) for b in blocks) == S - 1


@pytest.mark.parametrize("name", [n for n in NAMES if _moe(n)])
def test_the_moe_routes_as_one_device(name, port):
    """Each column's top-k choices at every step and layer equal the
    one-device run's for the one row (rows within ``TOPK_GAP`` of a tie
    are not held, and there are none); over two columns the second routes
    padding only."""
    for m in port[1]:
        r = m[name]["routes"]
        assert r["flips"] == 0 and r["too_close"] == 0, r
    counts = [m[name]["routes"]["compared"] for m in port[1]]
    assert counts[0] > 0
    if name.endswith("1x4x1"):
        assert all(c == counts[0] for c in counts)
    else:
        shape = tuple(int(c) for c in name.split("-")[-1].split("x"))
        assert all(c == 0 for r, c in enumerate(counts) if r % shape[2])


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_main_at_batch_one_over_a_mesh_matches_one_device(arch, port):
    """``launch.serve.main --mesh 1x2x2 --batch 1``: every rank decodes the
    one row over its block of the cache's time, rank 0 alone prints, and
    the sample is the one-device run's."""
    from repro_torch.launch import serve

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        want = serve.main(["--arch", arch] + SERVE_ARGS)
    meta = port[1]
    for m in meta:
        assert m["serve_main"][arch]["rows"] == want.tolist()
    assert "sample: " + str(want[0].tolist()) in meta[0]["serve_main"][arch]["stdout"]
    assert all(m["serve_main"][arch]["stdout"] == "" for m in meta[1:])


def test_every_tensor_sent_is_contiguous(port):
    for meta in port[1]:
        assert meta["not_contiguous"] == []


# ---------------------------------------------------------------------------
# eight ranks: a time cut over two of three axes over 1
# ---------------------------------------------------------------------------
def _eight_ranks(rank, root):
    import torch.distributed as dist

    from repro_torch.configs import registry as treg
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.launch import train

    T8 = 12                # model and data divide it, pod does not: time over model x data
    mesh = make_mesh((2, 2, 2), AXES, device="cpu")
    group = mesh.group_over(("model", "data"))
    ranks = torch.zeros(dist.get_world_size(), dtype=torch.int32)
    ranks[rank] = 1
    dist.all_reduce(ranks, group=group)
    one = treg.build_model("gemma-2b", smoke=True)
    model = treg.build_model("gemma-2b", mesh, smoke=True)
    params = one.init_params(0, "cpu")
    specs = model.cache_specs(mesh, 1, T8)
    tok = torch.from_numpy(np.random.default_rng(3).integers(0, one.cfg.vocab, (1, S))
                           .astype(np.int32))
    lgs = {}
    with torch.no_grad():
        for tag, m, p, kw in (("one", one, params, {}),
                              ("mesh", model, train.shard_state(mesh, params,
                                                                model.param_specs(mesh)),
                               {"cache_specs": specs})):
            cache = m.init_cache(1, T8, device="cpu")
            cache = train.shard_state(mesh, cache, specs) if kw else cache
            lgs[tag] = torch.cat([m.decode_step(p, cache, tok[:, t:t + 1],
                                                torch.full((1,), t, dtype=torch.int32), **kw)[0]
                                  for t in range(S)], dim=1)
    (root / f"eight{rank}.json").write_text(json.dumps({
        "group": ranks.nonzero().flatten().tolist(),
        "time_axes": list(model._time_cut(specs["p0"])),
        "rel": float((lgs["mesh"] - lgs["one"]).abs().max() / lgs["one"].abs().max())}))


def test_a_time_cut_over_two_of_three_axes_on_eight_ranks(tmp_path):
    """gemma-2b at B = 1 on a (2, 2, 2) mesh of eight gloo ranks with 12
    cache positions: the time is cut over model x data (pod does not divide
    what is left), so the combine runs over a group that ``make_mesh``
    created for those two axes: the four ranks that share this rank's pod.
    Every step's logits equal the one-device decode within
    ``LOGITS_RTOL``."""
    spawn_world(_eight_ranks, 8, (tmp_path,), tmp_path, timeout=120)
    for r in range(8):
        got = json.loads((tmp_path / f"eight{r}.json").read_text())
        assert got["group"] == list(range(4 * (r // 4), 4 * (r // 4) + 4))
        assert got["time_axes"] == ["model", "data"] and got["rel"] <= LOGITS_RTOL, got
