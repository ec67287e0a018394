"""The port's decode and prefill over the model axis for the MoE, ssm, hybrid
and encdec families against the reference's, on four CPU ranks.

The smoke configs of qwen3-moe-30b-a3b (8 experts, 2 a column on four
ranks), grok-1-314b (2 experts: SPLIT 2 on four ranks, each column an F/2
slice of one), mamba2-370m, recurrentgemma-2b (a window of 8 slots over 12
tokens: the ring wraps) and whisper-large-v3 (24 encoder positions), each
on (1, 1, 4) and (1, 2, 2) pod x data x model meshes, under the train specs
(the reference serves these families with them; over ``data`` every
weight's ``d_model`` dim is cut and gathered a layer at a time). Three more
cases on (1, 1, 4): recurrentgemma with six heads, whole on four ranks (as
recurrentgemma-2b's 10 are) against a time-cut ring; mamba2 with two heads
of 32, whole on four ranks while ``d_inner`` and the conv window split;
qwen3-moe with a batch of 2, so two columns route only the rows that pad
the batch to four. The cache of ``T`` = 16 positions is cut by
``cache_specs`` (the reference's: time over ``model`` for the attention
caches and whisper's cross K/V, heads for the SSM state, channels for the
conv and recurrent windows), whisper's cross K/V filled by
``prefill_cross`` from seeded frames, and a seeded 12-token sequence is fed
through decode token by token (teacher-forced). The port runs in one world
of four gloo ranks (``test_torch_collectives.spawn_world``), each rank on
its blocks of the reference's weights (``test_torch_models.seeded_params``
at the model axis's size, crossed over with
``convert.params_from_reference``, then ``launch.train.shard_state`` by the
specs of ``build_serve_step``'s bundle); the reference decodes the same
cases on four fake devices in one subprocess, placed by its
``param_specs`` and ``cache_specs``, started before the port's world so
the two overlap. Held, case by case:

  * every step's f32 logits, gathered, within ``LOGITS_RTOL`` of the
    largest logit, against the reference on the same mesh and against the
    port's one-device decode of the same weights (a MoE's laid out for one
    column, ``test_torch_ep.to_one_column``); whisper against the
    reference within the bound this test measures (the two packages'
    difference on one device plus twice the reference's own 1-versus-4
    device spread, as ``test_torch_tp_families`` holds it);
  * each rank's cache blocks against its blocks of the one-device cache:
    the positions bit for bit, the float blocks (attention K/V, the SSM
    state, the conv and recurrent windows, whisper's cross K/V) within
    ``LOGITS_RTOL`` of the block's largest value (the order of f32 sums
    differs);
  * the MoE's top-k choices at every decode step equal to the one-device
    run's (``route_log``), where no choice lies within ``TOPK_GAP`` of the
    next;
  * prefill's last-position logits over ``model`` (``build_prefill_step``)
    against the reference's on the same mesh; the MoE at capacity factor
    ``NO_DROP_CF``, where neither package's columns drop an assignment (the
    reference's sequence-sharded fast path gives each column other tokens,
    ``test_torch_ep``), which is asserted;
  * every tensor handed to ``torch.distributed`` contiguous.

Then ``launch.serve.main --mesh 1x1x4 --device cpu --smoke`` for
qwen3-moe, mamba2 and recurrentgemma in the same world: each sample equals
the one-device run's of the same weights. JAX is imported only in the
reference's subprocess.
"""
import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from test_torch_collectives import spawn_world
from test_torch_dist_train import (
    _flat, _require_contiguous, _unflat, finish_multidevice, start_multidevice)
from test_torch_ep import to_one_column

LOGITS_RTOL = 2e-5                 # of the largest logit: f32, summation order only
TOPK_GAP = 1e-4                    # a top-k choice this close to the next is not held
NO_DROP_CF = 4.0                   # a column's capacity is its token count: no drop
AXES = ("pod", "data", "model")
ARCHS = ("qwen3-moe-30b-a3b", "grok-1-314b", "mamba2-370m", "recurrentgemma-2b",
         "whisper-large-v3")
SHAPES = ((1, 1, 4), (1, 2, 2))
B, T, S = 4, 16, 12                # batch, cache positions, tokens fed
CASES = ([(arch, shape, (), B) for arch in ARCHS for shape in SHAPES]
         + [("recurrentgemma-2b", (1, 1, 4), (("n_heads", 6),), B),
            ("mamba2-370m", (1, 1, 4), (("ssm_head_dim", 32),), B),
            ("qwen3-moe-30b-a3b", (1, 1, 4), (), 2)])
PREFILLS = [(arch, shape) for arch in ARCHS for shape in SHAPES]
SERVE_ARCHS = ("qwen3-moe-30b-a3b", "mamba2-370m", "recurrentgemma-2b")
SERVE_ARGS = ["--smoke", "--device", "cpu", "--batch", "4", "--prompt-len", "6",
              "--gen", "8", "--seed", "2"]


def _moe(arch):
    return arch.startswith(("qwen3-moe", "grok-1"))


def _whisper(arch):
    return arch.startswith("whisper")


def _name(arch, shape, override=(), batch=B):
    tag = "".join(f"-{k}{v}" for k, v in override)
    return f"{arch}-{'x'.join(map(str, shape))}{tag}" + (f"-b{batch}" if batch != B else "")


def _weights_key(arch, override, tp):
    """The weights of ``arch``: a MoE's expert leaves are laid out for the
    model axis's size."""
    return arch + "".join(f"-{k}{v}" for k, v in override) + (f"-tp{tp}" if _moe(arch) else "")


NAMES = [_name(*c) for c in CASES]
PREFILL_NAMES = [_name(a, s) for a, s in PREFILLS]
WHISPER_NAMES = [n for n in NAMES if _whisper(n)]


# ---------------------------------------------------------------------------
# the inputs: seeded reference weights, tokens, frames
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def root(tmp_path_factory):
    from repro.configs import registry as jreg
    from test_torch_models import seeded_params

    path = tmp_path_factory.mktemp("serve_tp_families")
    for arch, shape, override, _b in CASES:
        jm = jreg.build_model(arch, smoke=True)
        if override:
            jm = type(jm)(dataclasses.replace(jm.cfg, **dict(override)), None)
        jm.tp = shape[2] if _moe(arch) else 1
        np.savez(path / f"params-{_weights_key(arch, override, shape[2])}.npz",
                 **_flat(seeded_params(jm, 0)))
    for arch in ARCHS:
        cfg = jreg.build_model(arch, smoke=True).cfg
        rng = np.random.default_rng(17)
        np.savez(path / f"inputs-{arch}.npz",
                 tokens=rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
                 audio=rng.standard_normal((B, cfg.enc_positions, cfg.d_model))
                 .astype(np.float32))
    return path


# ---------------------------------------------------------------------------
# the reference: the same cases on four fake devices, in the background
# ---------------------------------------------------------------------------
REFERENCE = """
import dataclasses, math
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding
from repro.configs.registry import build_model, ShapeCell
from repro.distributed.mesh import make_mesh
from repro.launch.steps import build_prefill_step

root, CASES, PREFILLS, T, S, CF = ARGS
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

def model_on(arch, shape, override, **kw):
    mesh = make_mesh(tuple(shape), ("pod", "data", "model"),
                     devices=jax.devices()[:math.prod(shape)])
    model = build_model(arch, mesh, smoke=True, **kw)
    if override:
        model = type(model)(dataclasses.replace(model.cfg, **dict(override)), mesh, **kw)
    return mesh, model

for arch, shape, override, batch, name, wkey, one in CASES:
    inp = np.load(f"{root}/inputs-{arch}.npz")
    tok = inp["tokens"][:batch]
    # whisper also on one device: the reference's own spread bounds the comparison
    for tag, where in [("", shape)] + ([("1", (1, 1, 1))] if one else []):
        mesh, model = model_on(arch, where, override)
        with mesh:
            params = put(unflat(dict(np.load(f"{root}/params-{wkey}.npz"))),
                         model.param_specs(mesh), mesh)
            specs = model.cache_specs(mesh, batch, T)
            cache = put(model.init_cache(batch, T), specs, mesh)
            if arch.startswith("whisper"):
                cache = put(jax.jit(model.prefill_cross)(params, cache,
                                                         jnp.asarray(inp["audio"][:batch])),
                            specs, mesh)
            step = jax.jit(model.decode_step)
            lgs = []
            for t in range(S):
                lg, cache = step(params, cache, jnp.asarray(tok[:, t:t + 1]),
                                 jnp.full((batch,), t, jnp.int32))
                lgs.append(np.asarray(lg, np.float32))
        out[f"{name}/decode{tag}"] = np.concatenate(lgs, axis=1)

for arch, shape, name, wkey, one, moe in PREFILLS:
    inp = np.load(f"{root}/inputs-{arch}.npz")
    for tag, where in [("", shape)] + ([("1", (1, 1, 1))] if one else []):
        mesh, model = model_on(arch, where, (), **({"cf": CF} if moe else {}))
        b = build_prefill_step(model, mesh, cell=ShapeCell("p", S, len(inp["tokens"]), "prefill"))
        batch = {"tokens": inp["tokens"][:, :b.in_shapes[1]["tokens"].shape[1]]}
        if "audio_embed" in b.in_shapes[1]:
            batch["audio_embed"] = inp["audio"]
        with mesh:
            params = put(unflat(dict(np.load(f"{root}/params-{wkey}.npz"))),
                         model.param_specs(mesh), mesh)
            fn = jax.jit(b.fn, in_shardings=b.in_shardings, out_shardings=b.out_shardings)
            out[f"{name}/prefill{tag}"] = np.asarray(fn(params, batch), np.float32)
np.savez(root + "/ref.npz", **out)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def reference_started(root):
    cases = [(a, list(s), [list(o) for o in ov], b, _name(a, s, ov, b),
              _weights_key(a, ov, s[2]), _whisper(a)) for a, s, ov, b in CASES]
    prefills = [(a, list(s), _name(a, s), _weights_key(a, (), s[2]), _whisper(a), _moe(a))
                for a, s in PREFILLS]
    code = REFERENCE.replace("ARGS", repr((str(root), cases, prefills, T, S, NO_DROP_CF)))
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
def _model(treg, arch, mesh, override=(), **kw):
    from repro_torch.launch.train import rebuild

    model = treg.build_model(arch, mesh, smoke=True, **kw)
    return rebuild(model, dataclasses.replace(model.cfg, **dict(override))) if override else model


def _topk(p, k):
    return torch.topk(p.float(), k, dim=-1).indices.sort(-1).values


def _route_flips(mine: list, one: list, ids: torch.Tensor, tp: int, col: int, k: int) -> dict:
    """This column's top-k choices at each logged step and layer against the
    one-device run's for the same rows: column ``col`` logs rows j ≡ col
    (mod tp) of its rows ``ids`` (global row ids; rows past them pad the
    batch to a multiple of tp). A row whose k-th choice lies within
    ``TOPK_GAP`` of the next on one device is not held."""
    compared = flips = close = 0
    local = torch.arange(ids.numel())[col::tp]
    for p, q in zip(mine, one, strict=True):
        want = q[ids[local]].float()
        held = torch.ones(local.numel(), dtype=torch.bool)
        if k < want.shape[-1]:                 # else every expert is chosen
            top = torch.topk(want, k + 1, dim=-1).values
            held = (top[:, k - 1] - top[:, k]) > TOPK_GAP
        diff = (_topk(p[:local.numel()], k) != _topk(want, k)).any(-1)
        compared += int(held.sum())
        flips += int((diff & held).sum())
        close += int((~held).sum())
    return {"compared": compared, "flips": flips, "too_close": close}


def _drops(probs: torch.Tensor, columns: list, cfg, tp: int, cf: float) -> int:
    """Assignments that columns holding the token rows ``columns`` (lists of
    indices into ``probs``) would drop at capacity factor ``cf``: per column
    and expert, those past the column's capacity."""
    from repro_torch.models.moe import capacity

    top = _topk(probs, cfg.top_k)
    out = 0
    for rows in columns:
        C = capacity(len(rows), cfg, tp, cf)
        counts = torch.bincount(top[rows].reshape(-1), minlength=cfg.n_experts)
        out += int((counts - C).clamp(min=0).sum())
    return out


def _one_device(treg, arch, override, tp, flat, inp, batch):
    """The port's one-device decode of the case's weights (a MoE's laid out
    for one column): (logits, cache, route_log)."""
    from repro_torch.convert import params_from_reference

    model = _model(treg, arch, None, override)
    if _moe(arch):
        flat = to_one_column(flat, model.cfg, tp)
        model.route_log = []
    params = params_from_reference(_unflat(flat), "cpu")
    tok = torch.from_numpy(inp["tokens"][:batch])
    cache = model.init_cache(batch, T, device="cpu")
    lgs = []
    with torch.no_grad():
        if _whisper(arch):
            cache = model.prefill_cross(params, cache, torch.from_numpy(inp["audio"][:batch]))
        for t in range(S):
            lg, cache = model.decode_step(params, cache, tok[:, t:t + 1],
                                          torch.full((batch,), t, dtype=torch.int32))
            lgs.append(lg)
    return torch.cat(lgs, dim=1), cache, model.route_log if _moe(arch) else None


def _port_serve_families(rank, root):
    import torch.distributed as dist

    from repro_torch.configs import registry as treg
    from repro_torch.configs.registry import ShapeCell
    from repro_torch.convert import params_from_reference
    from repro_torch.distributed.mesh import MODEL, P, gather, make_mesh, shard
    from repro_torch.launch import serve, train
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.models.common import cache_batch_spec

    loose = _require_contiguous(dist)
    out, meta = {}, {}
    for arch, shape, override, batch in CASES:
        name = _name(arch, shape, override, batch)
        flat = dict(np.load(root / f"params-{_weights_key(arch, override, shape[2])}.npz"))
        inp = dict(np.load(root / f"inputs-{arch}.npz"))
        one_lg, one_cache, one_routes = _one_device(treg, arch, override, shape[2], flat, inp,
                                                    batch)
        mesh = make_mesh(shape, AXES, device="cpu")
        model = _model(treg, arch, mesh, override)
        bundle = build_serve_step(model, mesh, cell=ShapeCell("d", T, batch, "decode"))
        pspecs, cspecs = bundle.specs
        params = train.shard_state(mesh, params_from_reference(_unflat(flat), "cpu"), pspecs)
        rows = cache_batch_spec(mesh, batch)
        tok = shard(mesh, torch.from_numpy(inp["tokens"][:batch]), P(rows, None))
        audio = shard(mesh, torch.from_numpy(inp["audio"][:batch]), P(rows, None, None))

        def fresh():
            cache = train.shard_state(mesh, model.init_cache(batch, T, device="cpu"), cspecs)
            if _whisper(arch):
                cache = model.prefill_cross(params, cache, audio, cache_specs=cspecs)
            return cache

        lgs = []
        with torch.no_grad():
            cache = fresh()
            if _moe(arch):
                model.route_log = []
            for t in range(S):
                pos = torch.full((tok.shape[0],), t, dtype=torch.int32)
                lg, cache = model.decode_step(params, cache, tok[:, t:t + 1], pos,
                                              cache_specs=cspecs)
                lgs.append(lg)
            routes = None
            if _moe(arch):
                routes, model.route_log = model.route_log, None
            # the bundle's step: the argmax of the same first step's logits
            nxt, _c, pos1 = bundle.fn(params, fresh(), tok[:, :1],
                                      torch.zeros((tok.shape[0],), dtype=torch.int32))
        meta[name] = {"step_argmax": bool(torch.equal(nxt[:, 0], lgs[0][:, 0].argmax(-1).int()))
                      and bool((pos1 == 1).all()),
                      "specs_equal": [_flat(pspecs) == _flat(model.param_specs(mesh)),
                                      cspecs == model.cache_specs(mesh, batch, T)]}
        if routes is not None:
            ids = shard(mesh, torch.arange(batch), P(rows))
            meta[name]["routes"] = _route_flips(routes, one_routes, ids, shape[2],
                                                mesh.rank(MODEL), model.cfg.top_k)
        lg = gather(mesh, torch.cat(lgs, dim=1), P(rows, None, None))
        if rank == 0:
            out[f"{name}/decode"] = lg.numpy()
            out[f"{name}/one"] = one_lg.numpy()
        for key, spec in cspecs.items():
            out[f"{name}/cache/{key}"] = cache[key].numpy().copy()
            out[f"{name}/want/{key}"] = shard(mesh, one_cache[key], spec).numpy().copy()
    for arch, shape in PREFILLS:
        name = _name(arch, shape)
        mesh = make_mesh(shape, AXES, device="cpu")
        model = _model(treg, arch, mesh, **({"cf": NO_DROP_CF} if _moe(arch) else {}))
        inp = np.load(root / f"inputs-{arch}.npz")
        step = build_prefill_step(model, mesh, cell=ShapeCell("p", S, B, "prefill"))
        shapes = step.in_shapes[1]
        rows = P(("pod", "data"), None)
        tokens = inp["tokens"][:, :shapes["tokens"].shape[1]]
        batch = {"tokens": shard(mesh, torch.from_numpy(tokens), rows)}
        if "audio_embed" in shapes:
            batch["audio_embed"] = shard(mesh, torch.from_numpy(inp["audio"]),
                                         P(("pod", "data"), None, None))
        flat = dict(np.load(root / f"params-{_weights_key(arch, (), shape[2])}.npz"))
        params = train.shard_state(mesh, params_from_reference(_unflat(flat), "cpu"),
                                   model.param_specs(mesh))
        if _moe(arch):
            model.route_log = []
        lg = gather(mesh, step.fn(params, batch), P(("pod", "data"), None, None))
        if _moe(arch):
            tp, col = shape[2], mesh.rank(MODEL)
            n_loc, n_tok = batch["tokens"].shape
            flat_ids = torch.arange(n_loc * n_tok)
            mine = flat_ids[col::tp]               # the port's slice of the data shard's rows
            block = n_tok // tp                    # the reference's: a block of positions
            theirs = [flat_ids.reshape(n_loc, n_tok)[:, c * block:(c + 1) * block].reshape(-1)
                      for c in range(tp)]
            dropped = [0, 0]                       # the port's columns, the reference's
            for p in model.route_log:              # this column's rows' probabilities
                whole = [torch.empty_like(p) for _ in range(tp)]
                dist.all_gather(whole, p.contiguous(), group=mesh.group(MODEL))
                probs = torch.stack(whole, 1).reshape(-1, p.shape[-1])   # the shard's rows
                dropped[0] += _drops(probs, [mine.tolist()], model.cfg, tp, NO_DROP_CF)
                dropped[1] += _drops(probs, [r.tolist() for r in theirs], model.cfg, tp,
                                     NO_DROP_CF)
            meta[f"{name}/dropped"] = dropped
            model.route_log = None
        if rank == 0:
            out[f"{name}/prefill"] = lg.numpy()
    meta["serve_main"] = {}
    for arch in SERVE_ARCHS:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            got = serve.main(["--arch", arch] + SERVE_ARGS + ["--mesh", "1x1x4"])
        meta["serve_main"][arch] = {"rows": got.tolist(), "stdout": buf.getvalue()}
    meta["not_contiguous"] = loose
    np.savez(root / f"port{rank}.npz", **out)
    (root / f"port{rank}.json").write_text(json.dumps(meta))


@pytest.fixture(scope="module")
def port(root, reference_started):
    spawn_world(_port_serve_families, 4, (root,), root, timeout=300)
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


def _bound(name, stage, port_one, reference):
    """Whisper's bound against the reference on the same mesh: the two
    packages' difference on one device (at least ``LOGITS_RTOL``) plus
    twice the reference's own 1-versus-4-device spread, all measured here.
    The other families': ``LOGITS_RTOL``."""
    if not _whisper(name):
        return LOGITS_RTOL
    ref1 = reference[f"{name}/{stage}1"]
    return (max(LOGITS_RTOL, _rel(port_one, ref1))
            + 2 * _rel(ref1, reference[f"{name}/{stage}"]))


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_one_device(name, port):
    """Every step's gathered logits against the port's one-device decode of
    the same weights and tokens, and the bundle's step picks their argmax;
    its specs are ``(param_specs(mesh), cache_specs(mesh, B, T))``."""
    arrays, meta = port
    assert _rel(arrays[0][f"{name}/decode"], arrays[0][f"{name}/one"]) <= LOGITS_RTOL
    assert all(m[name]["step_argmax"] and m[name]["specs_equal"] == [True, True] for m in meta)


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_the_reference(name, port, reference):
    """Every step's gathered logits against the reference's decode on the
    same mesh, under the same param and cache specs."""
    got, want = port[0][0][f"{name}/decode"], reference[f"{name}/decode"]
    assert _rel(got, want) <= _bound(name, "decode", port[0][0][f"{name}/one"], reference)


@pytest.mark.parametrize("name", WHISPER_NAMES)
def test_whispers_bound_is_near_the_others(name, port, reference):
    """Whisper's measured bound stays within 10x the other families' (its
    init amplifies f32 rounding; an operator at fault moves it by O(1))."""
    assert _bound(name, "decode", port[0][0][f"{name}/one"], reference) <= 10 * LOGITS_RTOL


@pytest.mark.parametrize("name", NAMES)
def test_each_ranks_cache_blocks_are_the_one_device_blocks(name, port):
    """Each rank's cache blocks against its blocks of the one-device cache:
    positions bit for bit (only the rank that holds slot pos % T wrote
    it), the float blocks within ``LOGITS_RTOL`` of the block's largest
    value."""
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


def test_a_wrapped_ring_and_empty_time_blocks(port):
    """recurrentgemma's ring of 8 slots wrapped (12 tokens): on (1, 1, 4)
    each rank holds 2 slots, all written, the newest position 11; whisper's
    self-attention cache of 16 on (1, 1, 4) left rank 3's 4 slots empty."""
    name = _name("recurrentgemma-2b", (1, 1, 4))
    ap = np.stack([a[f"{name}/cache/ap"] for a in port[0]])
    assert ap.shape[-1] == 2 and (ap >= 4).all() and ap.max() == S - 1
    name = _name("whisper-large-v3", (1, 1, 4))
    assert (port[0][3][f"{name}/cache/p"] == -1).all()


@pytest.mark.parametrize("name", [n for n in NAMES if _moe(n)])
def test_the_moe_routes_as_one_device(name, port):
    """Each column's top-k choices at every decode step and layer equal the
    one-device run's for the same rows (rows within ``TOPK_GAP`` of a tie
    are not held, and there are none); with a batch of 2 on four columns
    columns 2 and 3 route padding only and hold no row."""
    for m in port[1]:
        r = m[name]["routes"]
        assert r["flips"] == 0 and r["too_close"] == 0, r
    counts = [m[name]["routes"]["compared"] for m in port[1]]
    if name.endswith("-b2"):
        assert counts[2] == counts[3] == 0 and counts[0] > 0 and counts[1] > 0
    else:
        assert all(c > 0 for c in counts)


@pytest.mark.parametrize("name", PREFILL_NAMES)
def test_prefill_matches_the_reference(name, port, reference):
    """The last position's logits of ``build_prefill_step`` over ``model``
    (train specs; vocab-parallel unembedding, gathered) against the
    reference's on the same mesh; a MoE's where neither package's columns
    drop an assignment, which is asserted."""
    if _moe(name):
        assert all(m[f"{name}/dropped"] == [0, 0] for m in port[1])
    got = port[0][0][f"{name}/prefill"]
    want = reference[f"{name}/prefill"]
    bound = LOGITS_RTOL
    if _whisper(name):
        ref1 = reference[f"{name}/prefill1"]
        bound = max(LOGITS_RTOL, _rel(got, ref1)) + 2 * _rel(ref1, want)
        assert bound <= 10 * LOGITS_RTOL
    assert _rel(got, want) <= bound


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_main_over_the_model_axis_matches_one_device(arch, port):
    """``launch.serve.main --mesh 1x1x4`` on four ranks: every rank decodes
    the whole batch, rank 0 alone prints, and the sample is the one-device
    run's of the same weights (a MoE's drawn laid out for four columns,
    decoded on one device laid out for one)."""
    from repro_torch.configs import registry as treg
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.launch import serve

    args = ["--arch", arch] + SERVE_ARGS
    if _moe(arch):
        four = treg.build_model(arch, Mesh(dict(zip(AXES, (1, 1, 4))), (torch.device("cpu"),)),
                                smoke=True)
        one = treg.build_model(arch, smoke=True)
        flat = {k: v.numpy() for k, v in _flat(four.init_params(2, "cpu")).items()}
        params = _unflat({k: torch.from_numpy(v)
                          for k, v in to_one_column(flat, one.cfg, 4).items()})
        prompts = serve.prompts_for(2, 4, 6, one.cfg.vocab, "cpu")
        want = serve.generate(one, params, prompts, 8, 14).numpy()
    else:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            want = serve.main(args)
    meta = port[1]
    for m in meta:
        assert m["serve_main"][arch]["rows"] == want.tolist()
    assert "sample: " + str(want[0].tolist()) in meta[0]["serve_main"][arch]["stdout"]
    assert all(m["serve_main"][arch]["stdout"] == "" for m in meta[1:])


def test_every_tensor_sent_is_contiguous(port):
    for meta in port[1]:
        assert meta["not_contiguous"] == []
