"""The port's dry run (``repro_torch.launch.{mesh,steps,dryrun}``) against the reference's.

On the CPU, at the SMOKE widths: the meshes, the probe depths and their
extrapolation, the ring accounting of collectives, the cell builders, and
the walk's argument and output bytes against the reference's compiled
``memory_analysis()`` on a (1, 1) mesh. The probes extrapolate the walk to
the full depth within 1e-9, and ``main`` writes the reference's keys into
its cache. One test, marked ``gpu``, holds ``walk`` to ``measure`` on the
card.

The reference is imported inside the tests, so the card's machine, which
has no JAX, can collect the file. ``import repro.launch.dryrun`` sets
``XLA_FLAGS`` to 512 host devices: ``_jdryrun`` imports it only after JAX
has started (``jax.devices()``) and restores the variable, so no later test
in this worker sees it.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as treg
from repro_torch.launch import dryrun as tdr
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps

XLA_TUPLE_POINTER = 8    # XLA's output tuple holds one 8-byte pointer per leaf
LINEAR_REL = 1e-9        # probes extrapolated to the full depth, relative
PEAK_REL = 0.10          # the walk's peak against the card's

# (arch, shape): the reference compiles these at the SMOKE widths on a (1, 1) mesh
BYTES_CELLS = [
    ("gemma-2b", "train_4k"), ("internvl2-2b", "train_4k"),
    ("whisper-large-v3", "prefill_32k"), ("qwen3-moe-30b-a3b", "decode_32k"),
    ("recurrentgemma-2b", "decode_32k"), ("mamba2-370m", "long_500k"),
]
# one cell per family, at a depth the probes do not reach: (arch, shape, n_layers)
LINEAR_CELLS = [
    ("gemma-2b", "train_4k", 5), ("qwen3-moe-30b-a3b", "decode_32k", 5),
    ("mamba2-370m", "long_500k", 5), ("recurrentgemma-2b", "long_500k", 13),
    ("whisper-large-v3", "train_4k", 3), ("internvl2-2b", "train_4k", 5),
]


def _jdryrun():
    """``repro.launch.dryrun``, imported with ``XLA_FLAGS`` left as it was."""
    import jax

    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun


def _smoke(pkg_registry, arch, **extra):
    """The SMOKE config's fields as ``cfg_overrides``."""
    sm = pkg_registry.get_config(arch, smoke=True)
    return {**{f.name: getattr(sm, f.name) for f in dataclasses.fields(sm)}, **extra}


def _fields(cfg):
    from test_torch_models import _fields as fields
    return fields(cfg)


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("multi_pod,n", [(False, 256), (True, 512)])
def test_production_mesh_raises_on_one_device(multi_pod, n):
    with pytest.raises(RuntimeError, match=f"need {n} devices"):
        tmesh.make_production_mesh(multi_pod=multi_pod, device="cpu")


@pytest.mark.parametrize("shape,ok", [((1, 1), True), ((2, 2), False)])
def test_host_mesh(shape, ok):
    from repro.launch import mesh as jmesh

    if not ok:
        with pytest.raises(RuntimeError, match="need 4 devices, have 1"):
            tmesh.make_host_mesh(device="cpu")
        return
    mesh = tmesh.make_host_mesh(shape, device="cpu")
    assert mesh.axis_names == jmesh.make_host_mesh(shape).axis_names == ("data", "model")
    assert mesh.size == 1 and mesh.device == torch.device("cpu")


def test_importing_the_port_sets_no_environment():
    """Unlike the reference's dry run (``XLA_FLAGS`` on its line 2), the
    port's sets no variable and starts no device at import."""
    code = ("import os, torch; before = dict(os.environ); "
            "import repro_torch.launch.dryrun, repro_torch.launch.mesh; "
            "assert dict(os.environ) == before; assert not torch.cuda.is_initialized()")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [os.path.join(os.path.dirname(os.path.dirname(__file__)), "src"),
         os.environ.get("PYTHONPATH", "")])}
    subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)


# ---------------------------------------------------------------------------
# probes and the ring accounting
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", treg.ARCHS)
def test_probe_layers_equal_the_reference(arch):
    fam = treg.get_config(arch).family
    assert tdr._probe_layers(arch, fam) == _jdryrun()._probe_layers(arch, fam)


def _probe_records(rng, depths):
    keys = ("flops_per_device", "bytes_accessed")
    return {L: {**{k: float(rng.integers(1, 1 << 40)) for k in keys},
                "collectives": {k: float(rng.integers(0, 1 << 30)) for k in tdr.KINDS}}
            for L in depths}


@pytest.mark.parametrize("arch,family,depths,n_layers", [
    ("gemma-2b", "dense", [1, 2], 18), ("gemma2-2b", "dense", [2, 4], 26),
    ("whisper-large-v3", "encdec", [1, 2], 32), ("mamba2-370m", "ssm", [1, 2], 48),
    ("recurrentgemma-2b", "hybrid", [3, 6, 8], 26),
    ("recurrentgemma-2b", "hybrid", [3, 6, 8], 13),
    ("recurrentgemma-2b", "hybrid", [3, 6, 8], 9),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_reconstruct_equals_the_reference(arch, family, depths, n_layers, seed):
    probes = _probe_records(np.random.default_rng(seed), depths)
    want = _jdryrun()._reconstruct({}, probes, arch, family, n_layers)
    assert tdr._reconstruct({}, probes, arch, family, n_layers) == want


_HLO_DTYPES = {"f32": 4, "bf16": 2, "s32": 4, "u8": 1}


def _hlo_line(i, kind, dtype, dims, groups, total):
    """One HLO instruction the reference's regexes read; ``groups`` is
    "iota", "list" or None (no replica_groups: the whole mesh)."""
    shape = f"{dtype}[{','.join(map(str, dims))}]"
    rg = ""
    if groups is not None:
        n, g = groups
        if n == "iota":
            rg = f", replica_groups=[{total // g},{g}]<=[{total}]"
        else:
            rows = [",".join(str(r * g + c) for c in range(g)) for r in range(total // g)]
            rg = ", replica_groups={" + ",".join("{" + r + "}" for r in rows) + "}"
    return f"  %op.{i} = {shape}{{0}} {kind}({shape}{{0}} %x.{i}){rg}"


@pytest.mark.parametrize("form", ["iota", "list", "none"])
@pytest.mark.parametrize("seed", [0, 1])
def test_ring_accounting_equals_the_reference(form, seed):
    """The reference's ``collective_bytes`` over HLO lines built from the
    records equals the port's over the records: every kind (with the
    ``-start`` forms), group sizes 1 to 16."""
    rng = np.random.default_rng(seed)
    total = 16
    kinds = list(tdr.KINDS) + ["all-gather-start", "all-reduce-start",
                               "collective-permute-start"]
    lines, records = [], []
    for i in range(40):
        kind = kinds[i % len(kinds)]
        dtype = list(_HLO_DTYPES)[int(rng.integers(len(_HLO_DTYPES)))]
        dims = [int(d) for d in rng.integers(1, 64, size=int(rng.integers(1, 4)))]
        g = int(rng.choice([1, 2, 4, 8, 16]))
        groups = None if form == "none" else (form, g)
        lines.append(_hlo_line(i, kind, dtype, dims, groups, total))
        records.append((kind.replace("-start", ""), int(np.prod(dims)) * _HLO_DTYPES[dtype],
                        total if form == "none" else g))
        if i % 7 == 0:      # a -done never counts, in either package
            lines.append(f"  %done.{i} = f32[4]{{0}} all-gather-done(f32[4]{{0}} %op.{i})")
    want = _jdryrun().collective_bytes("\n".join(lines), total)
    got = tdr.collective_bytes(records)
    assert got["n_ops"] == want["n_ops"] == 40
    assert got == want          # the same products, summed in the same order
    assert tdr.collective_bytes(()) == _jdryrun().collective_bytes("", 1)


# ---------------------------------------------------------------------------
# the cell builders
# ---------------------------------------------------------------------------
def test_default_microbatches_equal_the_reference():
    from repro.launch import steps as jsteps
    assert tsteps.DEFAULT_MICROBATCHES == jsteps.DEFAULT_MICROBATCHES


@pytest.mark.parametrize("arch", treg.ARCHS)
def test_build_cell_and_with_layers_equal_the_reference(arch):
    """Each shape's model config, field by field: at full width cut to a
    probe depth (``_with_layers``), and on the SMOKE fields as overrides."""
    from repro.configs import registry as jreg
    from repro.launch import steps as jsteps

    fam = treg.get_config(arch).family
    L = tdr._probe_layers(arch, fam)[0]
    for shape in treg.SHAPES:
        got = tsteps.build_cell(arch, shape, layers_override=L)
        want = jsteps._with_layers(arch, jreg.build_model(arch, shape=shape), None, L, shape)
        assert _fields(got.model.cfg) == _fields(want.cfg)
        assert got.kind == treg.SHAPES[shape].kind
        assert getattr(got.model, "max_target", None) == getattr(want, "max_target", None)
        assert getattr(got.model, "cf", None) == getattr(want, "cf", None)
    jm = jreg.build_model(arch, shape="train_4k")
    jm = jsteps._rebuild(jm, None, dataclasses.replace(jm.cfg, **_smoke(jreg, arch)), "train_4k")
    got = tsteps.build_cell(arch, "train_4k", cfg_overrides=_smoke(treg, arch))
    assert _fields(got.model.cfg) == _fields(jm.cfg) == _fields(jreg.get_config(arch, smoke=True))


@pytest.mark.parametrize("shape", list(treg.SHAPES))
def test_in_shapes_equal_the_reference(shape):
    """``in_shapes``: every leaf's shape and dtype, in the reference's
    order of arguments (params, optimizer state, batch / cache, tokens,
    pos), for a vlm and an encdec, whose batches carry embeddings."""
    import jax

    from repro.configs import registry as jreg
    from repro.distributed.mesh import make_mesh
    from repro.launch import steps as jsteps

    for arch in ("internvl2-2b", "whisper-large-v3"):
        if treg.skip_reason(arch, shape):
            continue
        jb = jsteps.build_cell(arch, shape, make_mesh((1, 1), ("data", "model")),
                               cfg_overrides=_smoke(jreg, arch))
        tb = tsteps.build_cell(arch, shape, cfg_overrides=_smoke(treg, arch))
        want = [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(jb.in_shapes)]
        got = [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
               for t in tdr._tensors(tb.in_shapes)]
        assert sorted(got) == sorted(want)
        assert len(tb.in_shapes) == len(jb.in_shapes)
        assert all(t.device.type == "meta" for t in tdr._tensors(tb.in_shapes))


# ---------------------------------------------------------------------------
# the walk against the reference's memory analysis
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,shape", BYTES_CELLS)
def test_argument_and_output_bytes_equal_the_reference(arch, shape):
    """Byte for byte against the reference's compiled ``memory_analysis()``
    on a (1, 1) CPU mesh. The one difference the port makes on purpose
    (ROADMAP, deliberate differences): XLA's output tuple also holds an
    8-byte pointer per leaf (``XLA_TUPLE_POINTER``), which eager PyTorch
    does not allocate."""
    import jax

    from repro.configs import registry as jreg
    from repro.distributed.mesh import make_mesh
    from repro.launch import steps as jsteps

    mesh = make_mesh((1, 1), ("data", "model"))
    jb = jsteps.build_cell(arch, shape, mesh, cfg_overrides=_smoke(jreg, arch))
    with mesh:
        compiled = jax.jit(jb.fn, in_shardings=jb.in_shardings,
                           out_shardings=jb.out_shardings).lower(*jb.in_shapes).compile()
    ma = compiled.memory_analysis()
    n_out = len(jax.tree.leaves(jax.eval_shape(jb.fn, *jb.in_shapes)))
    table = XLA_TUPLE_POINTER * n_out if n_out > 1 else 0

    rec = tdr.run_cell(arch, shape, device="cpu", probes=False,
                       cfg_overrides=_smoke(treg, arch))
    assert rec["argument_bytes"] == ma.argument_size_in_bytes
    assert rec["output_bytes"] + table == ma.output_size_in_bytes
    assert rec["peak_bytes"] == rec["argument_bytes"] + rec["temp_bytes"]
    assert rec["flops_per_device"] > 0 and rec["bytes_accessed"] > rec["argument_bytes"]
    assert rec["collectives"]["n_ops"] == 0 and rec["collectives"]["by_group_size"] == {}
    assert rec["mesh"] == "one" and rec["devices"] == 1


def test_walk_counts_flops_and_live_bytes_of_a_known_function():
    """A hand-checked step: two matmuls and an elementwise op, the first
    product dying before the second is made."""
    n = 64

    def fn(a, b):
        c = a @ b                 # 2 n^3 FLOPs, n*n*4 bytes
        d = c * 2.0
        del c
        return d @ b              # 2 n^3 FLOPs

    meta = torch.empty((n, n), device="meta")
    rec = tdr.walk(tsteps.StepBundle(fn, None, "custom", (meta, meta)), "cpu")
    nb = n * n * 4
    assert rec["flops_per_device"] == 4 * n ** 3
    assert rec["argument_bytes"] == 2 * nb and rec["output_bytes"] == nb
    assert rec["temp_bytes"] == 2 * nb                 # c and d, then d and the result
    assert rec["bytes_accessed"] == 3 * nb + 2 * nb + 3 * nb


@pytest.mark.parametrize("arch,shape,n_layers", LINEAR_CELLS)
def test_probes_extrapolate_to_the_full_walk(arch, shape, n_layers):
    """Eager runs every layer, so the probes' linear extrapolation equals
    the walk at the full depth: a check of ``_with_layers`` and of the
    accounting. Microbatches 1 in both (the probes' own); an encdec's
    probes cut both stacks, so its full depth sets both."""
    depth = {"n_layers": n_layers}
    if treg.get_config(arch).family == "encdec":
        depth["n_enc_layers"] = n_layers
    rec = tdr.run_cell(arch, shape, device="cpu", microbatches=1,
                       cfg_overrides=_smoke(treg, arch, **depth))
    assert sorted(rec["probes"]) == sorted(map(str, tdr._probe_layers(
        arch, treg.get_config(arch).family)))
    for key in ("flops_per_device", "bytes_accessed"):
        assert rec["extrapolated"][key] == pytest.approx(rec[key], rel=LINEAR_REL), key
        assert rec["probes"][min(rec["probes"], key=int)][key] < rec[key]
    assert all(rec["extrapolated"][k] == 0.0 for k in tdr.KINDS)


def test_moe_bucket_slots_have_a_static_shape():
    """``bucket_slots`` walks on fake tensors (no ``bincount``) and still
    ranks each assignment in its expert's bucket."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.moe import bucket_slots

    with FakeTensorMode():
        assert bucket_slots(torch.zeros(12, dtype=torch.int64), 4).shape == (12,)
    e = torch.tensor([2, 0, 2, 1, 2, 0])
    assert bucket_slots(e, 4).tolist() == [0, 0, 1, 0, 2, 1]


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------
REF_RECORD = {"arch", "shape", "mesh", "devices", "sync_mode", "microbatches",
              "cfg_overrides", "weight_stationary", "lower_s", "compile_s",
              "param_count", "active_param_count", "extrapolated", "probes"}


def _ref_analysis_keys():
    """The keys of the reference's ``_analyze`` on a compiled function."""
    import jax
    import jax.numpy as jnp

    compiled = jax.jit(lambda x: x @ x).lower(jnp.ones((4, 4))).compile()
    return set(_jdryrun()._analyze(compiled, 1))


def test_main_writes_the_reference_keys_and_skips_cached_cells(tmp_path, capsys):
    """Two cells into one cache: mamba2-370m long_500k, walked at its full
    config (one decode token through 48 layers; fake tensors allocate
    nothing), and gemma-2b long_500k, skipped for the reference's reason.
    A second run reports the cached cell."""
    from repro.configs import registry as jreg

    out = str(tmp_path / "dry.json")
    common = ["--shape", "long_500k", "--device", "cpu", "--out", out]
    tdr.main(["--arch", "mamba2-370m", *common])
    res = tdr.main(["--arch", "gemma-2b", *common])
    assert capsys.readouterr().out.splitlines()[-1] == f"done: 2 cells, 0 errors -> {out}"
    with open(out) as fh:
        assert json.load(fh) == json.loads(json.dumps(res))
    rec = res["mamba2-370m|long_500k|one|auto|mb0"]
    assert set(rec) == (REF_RECORD - {"lower_s", "compile_s"}) | {"walk_s"} | _ref_analysis_keys()
    assert set(rec["collectives"]) == set(_jdryrun().collective_bytes("", 1))
    assert rec["param_count"] == treg.get_config("mamba2-370m").param_count()
    assert set(rec["probes"]) == {"1", "2"}
    assert res["gemma-2b|long_500k|one|auto|mb0"] == {
        "arch": "gemma-2b", "shape": "long_500k", "mesh": "one",
        "skipped": jreg.skip_reason("gemma-2b", "long_500k")}
    tdr.main(["--arch", "mamba2-370m", *common])
    assert "[skip-cached] mamba2-370m|long_500k|one|auto|mb0" in capsys.readouterr().out


def test_main_walks_both_production_meshes(tmp_path, capsys):
    """``--mesh both``: one cell on 16x16 and on 2x16x16, each as rank 0 of
    its fake world, with the reference's keys and the collectives counted;
    no world is left after it."""
    import torch.distributed as dist

    out = str(tmp_path / "dry.json")
    res = tdr.main(["--arch", "mamba2-370m", "--shape", "long_500k", "--mesh", "both",
                    "--device", "cpu", "--out", out, "--no-probes"])
    assert capsys.readouterr().out.splitlines()[-1] == f"done: 2 cells, 0 errors -> {out}"
    for mk, n in (("single", 256), ("multi", 512)):
        rec = res[f"mamba2-370m|long_500k|{mk}|auto|mb0"]
        keys = REF_RECORD - {"lower_s", "compile_s", "extrapolated", "probes"}
        assert set(rec) == keys | {"walk_s"} | _ref_analysis_keys()
        assert rec["mesh"] == mk and rec["devices"] == n
        assert rec["collectives"]["n_ops"] > 0
        assert set(rec["collectives"]) == set(_jdryrun().collective_bytes("", 1))
    assert not dist.is_initialized()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal where there is no card")
def test_the_card_is_required_by_default(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdr.main(["--arch", "gemma-2b", "--shape", "decode_32k", "--out",
                  str(tmp_path / "dry.json")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdr.run_cell("gemma-2b", "decode_32k")
    assert not os.path.exists(tmp_path / "dry.json")


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------
@pytest.mark.gpu
def test_walk_equals_measure_on_the_card():
    """gemma-2b at full width, one layer, on the decode_32k cell: the
    walk's FLOPs and argument bytes equal the card's, its peak is within
    ``PEAK_REL`` of the card's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bundle = tsteps.build_cell("gemma-2b", "decode_32k", layers_override=1)
    got, card = tdr.walk(bundle, "cuda"), tdr.measure(bundle, "cuda")
    assert got["flops_per_device"] == card["flops_per_device"]
    assert got["argument_bytes"] == card["argument_bytes"]
    assert got["output_bytes"] == card["output_bytes"]
    assert abs(got["peak_bytes"] - card["peak_bytes"]) <= PEAK_REL * card["peak_bytes"]
    assert card["step_ms"] > 0
