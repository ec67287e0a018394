"""The port's chunked collectives against the reference's, on four CPU ranks.

``repro_torch.distributed.{chunked,fsdp}`` run in one world of four gloo
ranks a module (``spawn_world``: ``torch.multiprocessing.spawn``, a
``file://`` store in ``tmp_path``, a join timeout); ``repro.distributed``
runs under ``shard_map`` in one subprocess with four fake devices
(``conftest.run_multidevice``). Both read the same seeded numpy inputs,
one block of a leading rank dimension a rank, and their outputs are held
case by case:

  * gathers, f32 and bf16: byte for byte;
  * the f32 and bf16 rings (reduce-scatter, all-reduce, ``cross_pod_mean``):
    exactly, because the port adds in the reference's order (the received
    partial plus the rank's own block, a step at a time) and each addition
    is one correctly rounded IEEE add in both;
  * ``ag_matmul`` and ``matmul_rs``: each package sums the same A block
    products of K/A terms each, then A-1 partial sums in the same order, so
    each lies within (K/A + A - 1)·2^-24·(|x|@|w|) of the exact product in
    f32 and the two within twice that of each other; in bf16 each block
    product and each running sum is rounded once more (half an ulp,
    2^-8 relative, of at most (|x|@|w|)), adding 2·(2A-1)·2^-8·(|x|@|w|).

Axis sizes 4 (the world) and 2 (the pod axis of a (2, 2) pod x data mesh),
``n_chunks`` 1, 2 and 4, and shards that do not divide (the one-chunk
fallback). Message counts are the port's form of the reference's
``test_chunking_visible_in_hlo``: ``dist.batch_isend_irecv`` is wrapped in
a rank and must carry ``n_chunks·(A-1)`` sends of ``s/n_chunks`` rows.
JAX is imported only inside the reference's subprocess and the test of
``default_n_chunks``.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

from conftest import run_multidevice

WORLD = 4
DTYPES = ("f32", "bf16")


# ---------------------------------------------------------------------------
# a world of ranks on the CPU
# ---------------------------------------------------------------------------
def _world_entry(rank, fn, n, store, device, args):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank))
    if device == "cpu":
        torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.distributed.mesh import init_world
    init_world(device, f"file://{store}")
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn_world(fn, n, args, tmp, timeout=90.0, device="cpu"):
    """Run ``fn(rank, *args)`` on ``n`` ranks of one world, gloo on the host
    or NCCL on the cards (a ``file://`` store under ``tmp``); raise if a
    rank fails or the world outlives ``timeout`` seconds."""
    store = tmp / f"store-{time.monotonic_ns()}"
    ctx = torch.multiprocessing.spawn(_world_entry, args=(fn, n, str(store), device, args),
                                      nprocs=n, join=False)
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"a world of {n} ranks outlived {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(5)


def to_torch(a: np.ndarray, dtype: str) -> torch.Tensor:
    """An input array as a tensor: bf16 travels as its uint16 bits."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.view(torch.int16).view(torch.bfloat16) if dtype == "bf16" else t


def to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def as_f64(a: np.ndarray, dtype: str) -> np.ndarray:
    if dtype == "bf16":
        return (a.astype(np.uint32) << 16).view(np.float32).astype(np.float64)
    return a.astype(np.float64)


# ---------------------------------------------------------------------------
# the cases and their seeded inputs
# ---------------------------------------------------------------------------
K, N, B = 16, 12, 8


def _cases() -> list[dict]:
    cases = []
    for dt in DTYPES:
        for A in (4, 2):
            for nc in (1, 2, 4):
                for kind in ("ag", "rs", "ar"):
                    cases.append(dict(kind=kind, A=A, nc=nc, dtype=dt, s=4))
                for kind in ("ag", "rs"):       # 3 rows: nc 2 and 4 fall back to 1
                    if nc > 1:
                        cases.append(dict(kind=kind, A=A, nc=nc, dtype=dt, s=3))
                if nc < 4:
                    cases.append(dict(kind="mmrs", A=A, nc=nc, dtype=dt, s=B // A))
            cases.append(dict(kind="agmm", A=A, nc=1, dtype=dt, s=0))
        for nc in (2, 4):
            cases.append(dict(kind="xpod", A=2, nc=nc, dtype=dt, s=0))
    for c in cases:
        c["name"] = f"{c['kind']}-A{c['A']}-nc{c['nc']}-s{c['s']}-{c['dtype']}"
    return cases


CASES = _cases()


def _round(x: np.ndarray, dtype: str) -> np.ndarray:
    if dtype == "f32":
        return x.astype(np.float32)
    import ml_dtypes
    return x.astype(np.float32).astype(ml_dtypes.bfloat16).view(np.uint16)


def _inputs(case: dict, rng) -> dict:
    """Per-rank inputs, a leading dimension of WORLD ranks. A rank's axis
    group is the world (A 4) or its pod axis (A 2: ranks {d, 2 + d}), so an
    input replicated on the axis depends on d only."""
    A, s, dt = case["A"], case["s"], case["dtype"]
    normal = lambda *shape: rng.standard_normal(shape)          # noqa: E731
    if case["kind"] == "ag":
        return {"x": _round(normal(WORLD, s, 6), dt)}
    if case["kind"] == "rs":
        return {"x": _round(normal(WORLD, A * s, 6), dt)}
    if case["kind"] == "ar":
        return {"x": _round(normal(WORLD, 5, 7), dt)}
    if case["kind"] == "agmm":
        x = normal(WORLD // A if A == 2 else 1, B, K)
        x = np.stack([x[r % 2] if A == 2 else x[0] for r in range(WORLD)])
        return {"x": _round(x, dt), "w": _round(normal(WORLD, K // A, N) * 0.5, dt)}
    if case["kind"] == "mmrs":
        return {"x": _round(normal(WORLD, B, K // A), dt),
                "w": _round(normal(WORLD, K // A, N) * 0.5, dt)}
    # xpod: one tree a pod; the big leaf gets default_n_chunks 4 and padding
    return {"a": _round(normal(2, 2, 4), dt), "b": _round(normal(2, 1023, 1025), dt),
            "c": _round(normal(2, 33), dt)}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("collectives")
    rng = np.random.default_rng(20)
    arrays = {}
    for case in CASES:
        for key, a in _inputs(case, rng).items():
            arrays[f"{case['name']}/{key}"] = a
    np.savez(root / "in.npz", **arrays)
    (root / "cases.json").write_text(json.dumps(CASES))
    return root, arrays


# ---------------------------------------------------------------------------
# the reference: shard_map over four fake devices
# ---------------------------------------------------------------------------
REFERENCE = """
import json, sys, functools
import numpy as np, jax, jax.numpy as jnp, ml_dtypes
from jax.sharding import PartitionSpec as P
from repro.distributed import chunked as C
from repro.distributed.fsdp import cross_pod_mean
from repro.distributed.mesh import make_mesh, shard_map

root = sys.argv[1]
cases = json.load(open(root + "/cases.json"))
inp = np.load(root + "/in.npz")
mesh4 = make_mesh((4,), ("x",))
mesh22 = make_mesh((2, 2), ("pod", "data"))
out = {}

def arr(a, dt):
    return jnp.asarray(a.view(ml_dtypes.bfloat16) if dt == "bf16" else a)

def bits(y, dt):
    y = np.asarray(y)
    return y.view(np.uint16) if dt == "bf16" else y

def per_rank(fn, A, *arrays):
    mesh, axes = (mesh4, "x") if A == 4 else (mesh22, ("pod", "data"))
    spec = P(axes)
    g = jax.jit(shard_map(lambda *a: fn(*[t[0] for t in a])[None], mesh=mesh,
                          in_specs=tuple(spec for _ in arrays), out_specs=spec,
                          check_vma=False))
    return g(*arrays)

for c in cases:
    name, A, nc, dt = c["name"], c["A"], c["nc"], c["dtype"]
    ax = "x" if A == 4 else "pod"
    get = lambda k: arr(inp[name + "/" + k], dt)
    if c["kind"] == "ag":
        y = per_rank(lambda x: C.chunked_all_gather(x, ax, A, n_chunks=nc), A, get("x"))
    elif c["kind"] == "rs":
        y = per_rank(lambda x: C.chunked_reduce_scatter(x, ax, A, n_chunks=nc), A, get("x"))
    elif c["kind"] == "ar":
        y = per_rank(lambda x: C.chunked_all_reduce(x, ax, A, n_chunks=nc), A, get("x"))
    elif c["kind"] == "agmm":
        y = per_rank(lambda x, w: C.ag_matmul(x, w, ax, A), A, get("x"), get("w"))
    elif c["kind"] == "mmrs":
        y = per_rank(lambda x, w: C.matmul_rs(x, w, ax, A, n_chunks=nc), A, get("x"), get("w"))
    else:
        tree = {k: get(k) for k in ("a", "b", "c")}
        f = jax.jit(shard_map(
            lambda t: jax.tree.map(lambda v: v[None],
                                   cross_pod_mean(jax.tree.map(lambda v: v[0], t), 2, n_chunks=nc)),
            mesh=mesh22, in_specs=P("pod"), out_specs=P("pod"), axis_names={"pod"},
            check_vma=False))
        for k, v in f(tree).items():
            out[name + "/" + k] = bits(v, dt)
        continue
    out[name] = bits(y, dt)
np.savez(root + "/ref.npz", **out)
print("REFERENCE_OK", len(out))
"""


@pytest.fixture(scope="module")
def reference(inputs):
    root, _ = inputs
    code = REFERENCE.replace("sys.argv[1]", repr(str(root)))
    assert "REFERENCE_OK" in run_multidevice(code, n_devices=WORLD, timeout=300)
    return dict(np.load(root / "ref.npz"))


# ---------------------------------------------------------------------------
# the port: four gloo ranks
# ---------------------------------------------------------------------------
def _time_cut_over_data_decode() -> float:
    """gemma-2b's decode at B = 1 over a (1, 2, 2) mesh, whose cache's time
    ``kv_cache_spec`` cuts over ``data`` as well as ``model`` (once a
    refusal, ROADMAP Queue 1 item 6d), against the one-device decode
    (``test_torch_serve_tp._batch_one``): the largest logit difference over
    the largest logit."""
    from repro_torch.configs import registry as treg
    from test_torch_serve_tp import _batch_one

    return _batch_one(treg, "gemma-2b", (1, 2, 2))["rel"]


def _port_collectives(rank, root):
    import torch.distributed as dist

    from repro_torch.distributed import chunked as C
    from repro_torch.distributed.fsdp import cross_pod_mean
    from repro_torch.distributed.mesh import DATA, POD, make_mesh

    cases = json.loads((root / "cases.json").read_text())
    inp = np.load(root / "in.npz")
    world = make_mesh((WORLD,), (DATA,), device="cpu")
    pods = make_mesh((2, 2, 1), (POD, DATA, "model"), device="cpu")
    out = {}
    for c in cases:
        name, A, nc, dt = c["name"], c["A"], c["nc"], c["dtype"]
        group = world.group(DATA) if A == 4 else pods.group(POD)

        def get(k, row=rank):
            return to_torch(inp[f"{name}/{k}"][row], dt)

        if c["kind"] == "ag":
            y = C.chunked_all_gather(get("x"), group, n_chunks=nc)
        elif c["kind"] == "rs":
            y = C.chunked_reduce_scatter(get("x"), group, n_chunks=nc)
        elif c["kind"] == "ar":
            y = C.chunked_all_reduce(get("x"), group, n_chunks=nc)
        elif c["kind"] == "agmm":
            y = C.ag_matmul(get("x"), get("w"), group)
        elif c["kind"] == "mmrs":
            y = C.matmul_rs(get("x"), get("w"), group, n_chunks=nc)
        else:
            pod = pods.rank(POD)
            tree = cross_pod_mean({k: get(k, pod) for k in ("a", "b", "c")}, group,
                                  n_chunks=nc)
            for k, v in tree.items():
                out[f"{name}/{k}"] = to_numpy(v)
            continue
        out[name] = to_numpy(y)

    # message counts: every batch of one ring step, wrapped
    real, sends = dist.batch_isend_irecv, []

    def counting(ops):
        sends.append([tuple(op.tensor.shape) for op in ops if op.op is dist.isend])
        return real(ops)

    dist.batch_isend_irecv = counting
    try:
        counts = {}
        for kind, fn, x in (("ag", C.chunked_all_gather, torch.zeros(8, 3)),
                            ("rs", C.chunked_reduce_scatter, torch.zeros(WORLD * 8, 3))):
            for nc in (1, 2, 4):
                sends.clear()
                fn(x, world.group(DATA), n_chunks=nc)
                counts[f"{kind}-nc{nc}"] = [list(s) for s in sends]
    finally:
        dist.batch_isend_irecv = real

    # refusals inside a world of four
    time_cut = _time_cut_over_data_decode()
    refusals = {}
    for what, call in (
            ("mesh_over_world", lambda: make_mesh((2, 2, 2), (POD, DATA, "model"),
                                                  device="cpu")),
            ("mesh_under_world", lambda: make_mesh((2,), (DATA,), device="cpu")),
            ("rs_rows", lambda: C.chunked_reduce_scatter(torch.zeros(6, 2), world.group(DATA))),
            ("agmm_shapes", lambda: C.ag_matmul(torch.zeros(2, 8), torch.zeros(3, 4),
                                                world.group(DATA))),
            ("mmrs_rows", lambda: C.matmul_rs(torch.zeros(6, 2), torch.zeros(2, 3),
                                              world.group(DATA)))):
        try:
            call()
            refusals[what] = None
        except (RuntimeError, ValueError, NotImplementedError) as e:
            refusals[what] = f"{type(e).__name__}: {e}"
    np.savez(root / f"port{rank}.npz", **out)
    (root / f"port{rank}.json").write_text(json.dumps({"sends": counts, "refusals": refusals,
                                                       "time_cut": time_cut}))


@pytest.fixture(scope="module")
def port(inputs):
    root, _ = inputs
    spawn_world(_port_collectives, WORLD, (root,), root)
    ranks = [dict(np.load(root / f"port{r}.npz")) for r in range(WORLD)]
    meta = [json.loads((root / f"port{r}.json").read_text()) for r in range(WORLD)]
    return ranks, meta


def _port_stacked(port, key):
    return np.stack([r[key] for r in port[0]])


def _case(name):
    return next(c for c in CASES if c["name"] == name)


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------
RINGS = [c["name"] for c in CASES if c["kind"] in ("ag", "rs", "ar")]


@pytest.mark.parametrize("name", RINGS)
def test_rings_equal_the_reference_exactly(name, port, reference):
    """Gathers byte for byte; reduce-scatter and all-reduce exactly (the
    reference's order of additions), in f32 and bf16, every rank."""
    got, want = _port_stacked(port, name), reference[name]
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("name", [c["name"] for c in CASES if c["kind"] == "ag"])
def test_gather_is_the_concatenation_of_the_shards(name, port, inputs):
    """The chunked all-gather equals the monolithic one: the shards of the
    rank's axis group, concatenated in group order."""
    c, arrays = _case(name), inputs[1]
    x = arrays[f"{name}/x"]
    got = _port_stacked(port, name)
    for r in range(WORLD):
        members = range(WORLD) if c["A"] == 4 else (r % 2, 2 + r % 2)
        assert got[r].tobytes() == np.concatenate([x[m] for m in members]).tobytes()


@pytest.mark.parametrize("name", [c["name"] for c in CASES if c["kind"] in ("rs", "ar")
                                  and c["dtype"] == "f32"])
def test_f32_rings_within_the_sum_bound(name, port, inputs):
    """Against the float64 sum: within (A-1)·2^-24·Σ|x| (A-1 rounded
    additions of partial sums of at most Σ|x|)."""
    c, arrays = _case(name), inputs[1]
    x, A, s = arrays[f"{name}/x"].astype(np.float64), c["A"], c["s"]
    got = _port_stacked(port, name).astype(np.float64)
    for r in range(WORLD):
        members = list(range(WORLD)) if A == 4 else [r % 2, 2 + r % 2]
        idx = members.index(r)
        tot, mag = sum(x[m] for m in members), sum(abs(x[m]) for m in members)
        if c["kind"] == "rs":
            tot, mag = tot[idx * s:(idx + 1) * s], mag[idx * s:(idx + 1) * s]
        assert np.all(np.abs(got[r] - tot) <= (A - 1) * 2.0 ** -24 * mag)


MATMULS = [c["name"] for c in CASES if c["kind"] in ("agmm", "mmrs")]


@pytest.mark.parametrize("name", MATMULS)
def test_collective_matmuls_within_their_bound(name, port, reference, inputs):
    """``ag_matmul`` and ``matmul_rs`` against the reference's, within the
    bound derived in the module docstring, and against float64 within half
    of it; every rank's shape and dtype the reference's."""
    c, arrays = _case(name), inputs[1]
    A, dt = c["A"], c["dtype"]
    x, w = (as_f64(arrays[f"{name}/{k}"], dt) for k in ("x", "w"))
    got, want = as_f64(_port_stacked(port, name), dt), as_f64(reference[name], dt)
    assert got.shape == want.shape
    per = (K // A + A - 1) * 2.0 ** -24 + ((2 * A - 1) * 2.0 ** -8 if dt == "bf16" else 0.0)
    for r in range(WORLD):
        members = list(range(WORLD)) if A == 4 else [r % 2, 2 + r % 2]
        if c["kind"] == "agmm":
            wf = np.concatenate([w[m] for m in members])
            exact, mag = x[r] @ wf, np.abs(x[r]) @ np.abs(wf)
        else:
            idx, rows = members.index(r), B // A
            exact = sum(x[m] @ w[m] for m in members)[idx * rows:(idx + 1) * rows]
            mag = sum(np.abs(x[m]) @ np.abs(w[m]) for m in members)[idx * rows:(idx + 1) * rows]
        assert np.all(np.abs(got[r] - want[r]) <= 2 * per * mag), name
        assert np.all(np.abs(got[r] - exact) <= per * mag), name


@pytest.mark.parametrize("name", [c["name"] for c in CASES if c["kind"] == "xpod"])
def test_cross_pod_mean_equals_the_reference(name, port, reference, inputs):
    """``cross_pod_mean`` over the pod axis of a (2, 2) pod x data mesh (the
    reference's ``tests/test_chunked_collectives.py::test_cross_pod_mean``):
    every rank of pod p holds the reference's result of pod p, bit for bit,
    and it is the mean of the two pods' trees within one rounding of the
    sum (then halved exactly)."""
    c, arrays = _case(name), inputs[1]
    for k in ("a", "b", "c"):
        got, want = _port_stacked(port, f"{name}/{k}"), reference[f"{name}/{k}"]
        for r in range(WORLD):
            assert got[r].tobytes() == want[r // 2].tobytes(), (k, r)
        x = as_f64(arrays[f"{name}/{k}"], c["dtype"])
        u = 2.0 ** -8 if c["dtype"] == "bf16" else 2.0 ** -24     # unit roundoff
        assert np.all(np.abs(as_f64(got[0], c["dtype"]) - x.mean(0))
                      <= u * np.abs(x).sum(0) / 2)


@pytest.mark.parametrize("kind", ["ag", "rs"])
@pytest.mark.parametrize("nc", [1, 2, 4])
def test_each_ring_step_carries_n_chunks_messages(kind, nc, port):
    """The port's form of ``test_chunking_visible_in_hlo``: over an axis of
    4, A-1 batches of ``n_chunks`` sends, each of ``8 / n_chunks`` rows, so
    n_chunks·(A-1) messages in all, more and finer as n_chunks grows."""
    for meta in port[1]:
        sends = meta["sends"][f"{kind}-nc{nc}"]
        assert len(sends) == WORLD - 1
        assert all(len(step) == nc for step in sends)
        assert all(shape == [8 // nc, 3] for step in sends for shape in step)
        assert sum(len(step) for step in sends) == nc * (WORLD - 1)


@pytest.mark.parametrize("what,error,text", [
    ("mesh_over_world", "RuntimeError", "needs 8 devices, have 4"),
    ("mesh_under_world", "RuntimeError", "in a world of 4"),
    ("rs_rows", "ValueError", "6 rows do not split over an axis of 4"),
    ("agmm_shapes", "ValueError", "do not fit an axis of 4"),
    ("mmrs_rows", "ValueError", "6 rows do not split over an axis of 4"),
])
def test_refusals_inside_a_world_of_four(what, error, text, port):
    """A mesh that is not the world and shapes the reference asserts on all
    raise, on every rank."""
    for meta in port[1]:
        msg = meta["refusals"][what]
        assert msg is not None and msg.startswith(error + ":") and text in msg, msg


def test_a_time_cut_over_data_decodes_inside_a_world_of_four(port):
    """Once a refusal (ROADMAP Queue 1 item 6d): gemma-2b's decode at B = 1
    on a (1, 2, 2) mesh that ``make_mesh`` builds, its cache time cut over
    ``model`` and ``data``, equals the one-device decode within 2e-5 of the
    largest logit on every rank."""
    for meta in port[1]:
        assert meta["time_cut"] <= 2e-5


@pytest.mark.parametrize("depth", [1, 4, 8])
def test_default_n_chunks_equals_the_reference(depth):
    from repro.distributed import chunked as jchunked

    from repro_torch.distributed import chunked as tchunked
    for nbytes in (0, 1, 1 << 20, (1 << 20) + 1, 2 << 20, 3 << 20, 5 << 20, 256 << 20,
                   4096 * 1025 * 4, 1 << 40):
        for min_chunk in (1 << 10, 1 << 20):
            kw = dict(pipeline_depth=depth, min_chunk_bytes=min_chunk)
            assert tchunked.default_n_chunks(nbytes, **kw) == jchunked.default_n_chunks(nbytes, **kw)


def test_a_world_needs_its_ranks_and_its_card(monkeypatch):
    """Outside a world a mesh of four raises (too few ranks), and a world
    on the card without one raises before joining anything."""
    from repro_torch.distributed.mesh import init_world, make_mesh
    from repro_torch.launch.mesh import make_host_mesh

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="needs 4 devices, have 1"):
        make_mesh((2, 2, 1), ("pod", "data", "model"), device="cpu")
    with pytest.raises(RuntimeError, match="need 4 devices, have 1"):
        make_host_mesh((2, 2, 1), ("pod", "data", "model"), device="cpu")
    if torch.cuda.is_available():
        return
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "4")
    for call in (lambda: init_world("cuda"),
                 lambda: make_mesh((2, 2, 1), ("pod", "data", "model"), device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# ---------------------------------------------------------------------------
# on four cards
# ---------------------------------------------------------------------------
def _card_collectives(rank, root):
    import torch.distributed as dist

    from repro_torch.distributed import chunked as C
    from repro_torch.distributed.mesh import DATA, make_mesh

    mesh = make_mesh((WORLD,), (DATA,), device="cuda")
    g = mesh.group(DATA)
    gen = torch.Generator(device=mesh.device).manual_seed(rank)
    x = torch.randn(4096, 256, generator=gen, device=mesh.device)
    want = torch.empty((WORLD * 4096, 256), device=mesh.device)
    dist.all_gather_into_tensor(want, x, group=g)
    ok = {"ag": all(torch.equal(C.chunked_all_gather(x, g, n_chunks=nc), want)
                    for nc in (1, 4))}
    tot = x.clone()
    dist.all_reduce(tot, group=g)
    bound = (WORLD - 1) * 2.0 ** -24 * want.abs().reshape((WORLD,) + tuple(x.shape)).sum(0)
    ok["ar"] = bool(((C.chunked_all_reduce(x, g) - tot).abs() <= 2 * bound).all())
    (root / f"card{rank}.json").write_text(json.dumps(ok))


@pytest.mark.gpu
def test_chunked_collectives_on_four_cards(tmp_path):
    """On four cards over NCCL: the chunked all-gather byte-equal to
    ``all_gather_into_tensor``, the chunked all-reduce within twice
    (A-1)·2^-24·Σ|x| of ``all_reduce`` (each within it of the exact sum)."""
    if torch.cuda.device_count() < WORLD:
        pytest.skip(f"needs {WORLD} cards, {torch.cuda.device_count()} visible")
    spawn_world(_card_collectives, WORLD, (tmp_path,), tmp_path, timeout=300, device="cuda")
    for r in range(WORLD):
        assert json.loads((tmp_path / f"card{r}.json").read_text()) == {"ag": True, "ar": True}
