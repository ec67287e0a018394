"""The port's dry run on the reference's production meshes (16x16 and 2x16x16).

One process stands in for rank 0 of a world of 256 or 512 ranks
(``launch.mesh.fake_world``: torch's fake process group, whose collectives
move nothing). On the CPU:

  (a) every production cell's ``StepBundle.in_shapes`` are this rank's
      blocks: leaf by leaf, in the reference's order, the shapes and dtypes
      of the reference's ``in_shardings[i].shard_shape(...)``, at full
      config (the reference runs once, in a subprocess with 512 host
      devices, and writes them as JSON);
  (b) the walk in a fake world of four ranks counts what rank 0 of a real
      world of four gloo ranks counts on real tensors, for the same bundle
      at the SMOKE widths: FLOPs, argument and output bytes and the
      collective records exactly, the temp bytes within ``PEAK_REL``;
  (c) one cell a family at full width on a production mesh: the walk
      records collectives, and the probes extrapolate every kind of them,
      as they do FLOPs and bytes, to a walk at a depth they do not reach;
  (d) no world is left after a cell, even one that raised, and a real
      world refuses a fake one.

The reference is imported inside the tests, so the card's machine, which
has no JAX, can collect the file.
"""
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from conftest import run_multidevice
from test_torch_collectives import spawn_world
from repro_torch.configs import registry as treg
from repro_torch.launch import dryrun as tdr
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps

LINEAR_REL = 1e-9        # probes extrapolated to the full depth, relative
PEAK_REL = 0.10          # the fake walk's temp bytes against the real run's
WORLDS = {"single": 256, "multi": 512}
PROD_CELLS = [(a, s, mk) for mk in WORLDS for a, s, _ in treg.cells()]


def _leaves(tree):
    """The leaves of a tree in the reference's order (``jax.tree.leaves``
    sorts a dict's keys)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# (a) in_shapes: this rank's blocks, against the reference's shard shapes
# ---------------------------------------------------------------------------
REF_SHARD_SHAPES = """
import json, jax
from repro.configs.registry import cells
from repro.launch.mesh import make_production_mesh
from repro.launch.steps import build_cell

out = {}
for mk in ("single", "multi"):
    mesh = make_production_mesh(multi_pod=mk == "multi")
    for arch, shape, _ in cells():
        b = build_cell(arch, shape, mesh)
        leaves, shardings = jax.tree.leaves(b.in_shapes), jax.tree.leaves(b.in_shardings)
        assert len(leaves) == len(shardings)
        out[f"{arch}|{shape}|{mk}"] = [[list(sh.shard_shape(x.shape)), str(x.dtype)]
                                       for x, sh in zip(leaves, shardings)]
print("SHAPES " + json.dumps(out))
"""


@pytest.fixture(scope="session")
def ref_shard_shapes():
    out = run_multidevice(REF_SHARD_SHAPES, n_devices=512, timeout=300)
    line = next(ln for ln in out.splitlines() if ln.startswith("SHAPES "))
    return json.loads(line[len("SHAPES "):])


@pytest.mark.parametrize("arch,shape,mesh_kind", PROD_CELLS)
def test_in_shapes_are_this_ranks_blocks(arch, shape, mesh_kind, ref_shard_shapes):
    """At full config: the params (and AdamW state) under the step's specs,
    a decode cache under its ``cache_specs``, the batch's rows over pod x
    data, a decode step's tokens and positions cut only where pod x data
    divides the batch."""
    want = ref_shard_shapes[f"{arch}|{shape}|{mesh_kind}"]
    with tmesh.fake_world(WORLDS[mesh_kind], "cpu"):
        mesh = tmesh.make_production_mesh(multi_pod=mesh_kind == "multi", device="cpu")
        bundle = tsteps.build_cell(arch, shape, mesh)
    leaves = list(_leaves(bundle.in_shapes))
    got = [[list(t.shape), str(t.dtype).replace("torch.", "")] for t in leaves]
    assert got == want
    nbytes = {"bfloat16": 2, "float32": 4, "int32": 4}
    assert sum(t.nbytes for t in leaves) == sum(
        int(np.prod(s)) * nbytes[d] for s, d in want)
    assert all(t.device.type == "meta" for t in leaves)


def test_gemma2_long_context_arguments_are_a_rank_s_share():
    """gemma2-2b's long_500k decode on 2x16x16: 0.119 GB of arguments a
    rank, the whole params and cache no longer."""
    with tmesh.fake_world(512, "cpu"):
        mesh = tmesh.make_production_mesh(multi_pod=True, device="cpu")
        bundle = tsteps.build_cell("gemma2-2b", "long_500k", mesh)
    got = sum(t.nbytes for t in _leaves(bundle.in_shapes))
    assert got == 119042984
    whole = tsteps.build_cell("gemma2-2b", "long_500k")
    assert sum(t.nbytes for t in _leaves(whole.in_shapes)) > 100 * got


# ---------------------------------------------------------------------------
# (b) the fake walk against a real world of four gloo ranks
# ---------------------------------------------------------------------------
AXES = ("pod", "data", "model")
MESHES = ((1, 2, 2), (2, 1, 2), (1, 4, 1))
STEPS = [("gemma-2b", "train-auto"), ("gemma-2b", "train-chunked"), ("gemma-2b", "prefill"),
         ("gemma-2b", "decode-b4"), ("gemma-2b", "decode-b1"),
         ("qwen3-moe-30b-a3b", "train-auto"), ("qwen3-moe-30b-a3b", "decode-b4")]
WALK_CASES = [(m, a, s) for m in MESHES for a, s in STEPS]


def _bundle(arch, step, mesh):
    """``step`` of ``arch`` at the SMOKE widths on ``mesh``: a train step
    (8 rows of 32 tokens; "auto" or "chunked" sync), a prefill (4 rows of
    32) or a decode step over a 64-position cache at batch 4 or 1 (batch 1:
    the cache's time cut over every axis)."""
    from repro_torch.configs.registry import ShapeCell, build_model

    model = build_model(arch, mesh, smoke=True)
    if step.startswith("train"):
        return tsteps.build_train_step(model, mesh, cell=ShapeCell("t", 32, 8, "train"),
                                       sync_mode=step.split("-")[1])
    if step == "prefill":
        return tsteps.build_prefill_step(model, mesh, cell=ShapeCell("p", 32, 4, "prefill"))
    batch = int(step.split("-b")[1])
    return tsteps.build_serve_step(model, mesh, cell=ShapeCell("d", 64, batch, "decode"))


def _real_records(rank, root, shape):
    """Every step of ``STEPS`` on this rank's seeded blocks (floats N(0,
    0.02), integers 0, as ``measure`` draws them), counted by ``_account``;
    rank 0 writes its records."""
    from repro_torch.distributed.mesh import make_mesh

    mesh = make_mesh(shape, AXES, device="cpu")
    gen = torch.Generator().manual_seed(rank)

    def draw(m):
        if m.dtype.is_floating_point:
            return torch.empty(m.shape, dtype=m.dtype).normal_(0.0, 0.02, generator=gen)
        return torch.zeros(m.shape, dtype=m.dtype)

    out = {}
    for arch, step in STEPS:
        bundle = _bundle(arch, step, mesh)
        out[f"{arch}|{step}"] = tdr._account(bundle.fn, tdr._tree_map(draw, bundle.in_shapes))
    if rank == 0:
        with open(root / f"real-{'x'.join(map(str, shape))}.json", "w") as fh:
            json.dump(out, fh)


@pytest.fixture(scope="module")
def real_records(tmp_path_factory):
    root = tmp_path_factory.mktemp("dryrun_mesh")
    out = {}
    for shape in MESHES:
        spawn_world(_real_records, 4, (root, shape), root, timeout=240)
        with open(root / f"real-{'x'.join(map(str, shape))}.json") as fh:
            out[shape] = json.load(fh)
    return out


@pytest.mark.parametrize("shape,arch,step", WALK_CASES)
def test_fake_walk_equals_a_real_world(shape, arch, step, real_records):
    real = real_records[shape][f"{arch}|{step}"]
    with tmesh.fake_world(4, "cpu"):
        mesh = tmesh.make_host_mesh(shape, AXES, device="cpu")
        fake = tdr.walk(_bundle(arch, step, mesh), "cpu")
    for key in ("flops_per_device", "argument_bytes", "output_bytes", "collectives"):
        assert fake[key] == real[key], key
    assert fake["collectives"]["n_ops"] > 0
    assert abs(fake["temp_bytes"] - real["temp_bytes"]) <= PEAK_REL * real["temp_bytes"]


def test_the_walk_sees_every_kind_the_port_issues(real_records):
    """Between them the cases issue every kind: all-reduce and all-gather
    (the model axis, ZeRO), reduce-scatter (ZeRO's backward), all-to-all
    (the MoE) and collective-permute (the chunked cross-pod rings)."""
    for kind in tdr.KINDS:
        assert any(r["collectives"][kind] > 0 for recs in real_records.values()
                   for r in recs.values()), kind
    chunked = real_records[(2, 1, 2)]["gemma-2b|train-chunked"]["collectives"]
    assert chunked["collective-permute"] > 0 and chunked["by_group_size"]["2"] > 0


# ---------------------------------------------------------------------------
# (c) one cell a family on a production mesh: collectives and probes
# ---------------------------------------------------------------------------
# (arch, shape, mesh kind, n_layers): full width, a depth the probes do not reach
FAMILY_CELLS = [
    ("gemma-2b", "decode_32k", "single", 3), ("qwen3-moe-30b-a3b", "decode_32k", "multi", 3),
    ("mamba2-370m", "prefill_32k", "multi", 3),
    ("recurrentgemma-2b", "long_500k", "single", 9),
    ("whisper-large-v3", "decode_32k", "multi", 3), ("internvl2-2b", "prefill_32k", "single", 3),
]


@pytest.mark.parametrize("arch,shape,mesh_kind,n_layers", FAMILY_CELLS)
def test_probes_extrapolate_the_collectives(arch, shape, mesh_kind, n_layers):
    depth = {"n_layers": n_layers}
    if treg.get_config(arch).family == "encdec":
        depth["n_enc_layers"] = n_layers
    rec = tdr.run_cell(arch, shape, mesh_kind, device="cpu", cfg_overrides=depth)
    assert rec["devices"] == WORLDS[mesh_kind] and rec["mesh"] == mesh_kind
    assert rec["collectives"]["n_ops"] > 0
    assert any(rec["collectives"][k] > 0 for k in tdr.KINDS)
    for key in ("flops_per_device", "bytes_accessed", *tdr.KINDS):
        full = rec["collectives"][key] if key in tdr.KINDS else rec[key]
        assert rec["extrapolated"][key] == pytest.approx(full, rel=LINEAR_REL, abs=1e-6), key
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# (d) the fake world leaves nothing behind
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("multi_pod,n", [(False, 256), (True, 512)])
def test_production_mesh_in_a_fake_world(multi_pod, n):
    """The reference's axes and sizes; each axis's group, the pod x data
    group and the world as sizes; nothing in the environment."""
    env = dict(os.environ)
    with tmesh.fake_world(n, "cpu") as world:
        assert world == n and dist.get_world_size() == n and dist.get_rank() == 0
        mesh = tmesh.make_production_mesh(multi_pod=multi_pod, device="cpu")
        assert dict(os.environ) == env
        assert mesh.size == n
        want = {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}
        assert mesh.shape == want
        for axis, size in want.items():
            assert dist.get_world_size(mesh.group(axis)) == size
        batch = 32 if multi_pod else 16
        group = mesh.batch_group
        assert (dist.get_world_size(group) if group is not None else n // 16) == batch
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match=f"need {n} devices"):
        tmesh.make_production_mesh(multi_pod=multi_pod, device="cpu")


def test_no_world_is_left_after_a_cell_even_one_that_raised(monkeypatch, tmp_path):
    rec = tdr.run_cell("mamba2-370m", "long_500k", "single", device="cpu", probes=False)
    assert rec["devices"] == 256 and rec["collectives"]["n_ops"] > 0
    assert not dist.is_initialized()

    def boom(bundle, device):
        assert dist.get_world_size() in (256, 512)
        raise RuntimeError("the walk failed")

    monkeypatch.setattr(tdr, "walk", boom)
    with pytest.raises(RuntimeError, match="the walk failed"):
        tdr.run_cell("mamba2-370m", "long_500k", "multi", device="cpu", probes=False)
    assert not dist.is_initialized()
    out = str(tmp_path / "dry.json")
    res = tdr.main(["--arch", "mamba2-370m", "--shape", "long_500k", "--mesh", "both",
                    "--device", "cpu", "--no-probes", "--out", out])
    assert all(r["error"] == "RuntimeError: the walk failed" for r in res.values())
    assert not dist.is_initialized()


def test_fake_world_refuses_inside_a_real_world(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="a world of 1 ranks \\(gloo\\) is up"):
            with tmesh.fake_world(256, "cpu"):
                pass
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()
