"""The dry run's probes on a train cell with more than one microbatch, in
both packages.

Both packages build their probes with ``microbatches=1``
(``src/repro/launch/dryrun.py:207-208``, the port's ``run_cell``) and
extrapolate them linearly in depth. Both train steps gather the ZeRO-cut
weights once a microbatch: the reference's compiled step holds the weights'
all-gathers inside its microbatch loop (a ``while`` with
``known_trip_count`` m), and the port's eager step regathers each layer in
each microbatch's forward (and reduce-scatters its gradients in the
backward). So in both the probes count one microbatch's weight gathers
where the step runs m of them. A property of both packages, pinned here on
mistral-nemo-12b's train_4k cell (m = 2):

  * the reference, compiled at full width and 1 layer on a 2x2x2 mesh of
    host devices (a subprocess): its microbatch loop regathers whole weight
    blocks, and the gather bytes it runs (outside the loop, plus m times the
    loop's) exceed those of the one-microbatch step its probes extrapolate;
  * the port, walked at full width and 3 layers on the 16x16 production
    mesh (rank 0 of a fake world): the walk's all-gather and reduce-scatter
    bytes are exactly m times the probes' extrapolation.
"""
import json

import pytest

from conftest import run_multidevice
from repro_torch.launch import dryrun as tdr
from repro_torch.launch import steps as tsteps

ARCH, SHAPE = "mistral-nemo-12b", "train_4k"
LINEAR_REL = 1e-9

REF_LOOP = """
import json, re
import jax
jax.devices()
from repro.launch import dryrun as jd
from repro.launch import steps as js
from repro.distributed.mesh import make_mesh
from repro.models import common as cm

mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))


def computations(text):
    comps, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"^(ENTRY\\s+)?%?([\\w.\\-]+)\\s*\\(.*\\{\\s*$", line)
        if m:
            cur = "ENTRY" if m.group(1) else m.group(2)
            comps[cur] = []
        elif cur:
            comps[cur].append(line)
    return {k: "\\n".join(v) for k, v in comps.items()}


def weight_block(dims, params):
    # a param's shape, or its block cut in two on some dims (the model axis
    # is 2 here), with or without the leading layer dim of a stacked leaf
    for p in params:
        for q in (p, p[1:]):
            if len(q) == len(dims) and all(r in (d, d // 2) for r, d in zip(dims, q)):
                return True
    return False


out = {}
for mb in (1, M):
    b = js.build_cell(ARCH, SHAPE, mesh, microbatches=mb, layers_override=1)
    params = {tuple(x.shape) for x in jax.tree.leaves(b.in_shapes[0]) if len(x.shape) >= 2}
    with cm.unroll_scans(), mesh:
        text = jax.jit(b.fn, in_shardings=b.in_shardings, out_shardings=b.out_shardings
                       ).lower(*b.in_shapes).compile().as_text()
    comps = computations(text)
    loops = re.findall(r'body=%?([\\w.\\-]+).*?"known_trip_count":\\{"n":"(\\d+)"', text)
    rec = {"step": jd.collective_bytes(text, 8)["all-gather"],
           "entry": jd.collective_bytes(comps["ENTRY"], 8)["all-gather"],
           "trips": [int(n) for _b, n in loops], "loop": 0.0, "weight_gathers": 0}
    for name, _n in loops:
        rec["loop"] += jd.collective_bytes(comps[name], 8)["all-gather"]
        for line in comps[name].splitlines():
            m = re.search(r"= \\w+\\[([\\d,]*)\\]\\S* all-gather\\(", line)
            if m and weight_block(tuple(int(d) for d in m.group(1).split(",")), params):
                rec["weight_gathers"] += 1
    out[mb] = rec
print(json.dumps(out))
"""


def test_reference_regathers_weights_each_microbatch():
    """The reference's step at m = 2 runs its weight gathers in the
    microbatch loop, twice; the one-microbatch step its probes build runs
    them once, so its extrapolation misses the repeats."""
    m = tsteps.DEFAULT_MICROBATCHES[ARCH]
    code = f"ARCH, SHAPE, M = {ARCH!r}, {SHAPE!r}, {m}\n" + REF_LOOP
    rec = json.loads(run_multidevice(code, n_devices=8, timeout=600).strip().splitlines()[-1])
    one, many = rec["1"], rec[str(m)]
    assert one["trips"] == [] and one["loop"] == 0.0        # no loop at m = 1
    assert many["trips"] == [m] and many["weight_gathers"] > 0
    ran = many["entry"] + m * many["loop"]
    assert ran > one["step"]                                 # the probes' basis
    # and the step's own text count sees the loop once: under what it runs
    assert many["step"] == pytest.approx(many["entry"] + many["loop"])
    assert many["step"] < ran


def test_port_probes_count_one_microbatch_of_zero_gathers():
    """The port's walk at m = 2 counts every microbatch's ZeRO gather and
    reduce-scatter; its probes, built at one microbatch, count one: exactly
    1/m of the walk's."""
    m = tsteps.DEFAULT_MICROBATCHES[ARCH]
    assert m > 1
    rec = tdr.run_cell(ARCH, SHAPE, "single", device="cpu", microbatches=m,
                       cfg_overrides={"n_layers": 3})
    walk, probes = rec["collectives"], rec["extrapolated"]
    for kind in ("all-gather", "reduce-scatter"):
        assert walk[kind] > 0
        assert walk[kind] == pytest.approx(m * probes[kind], rel=LINEAR_REL), kind
    # FLOPs do not depend on the cut into microbatches: the probes hold them
    assert probes["flops_per_device"] == pytest.approx(rec["flops_per_device"],
                                                       rel=LINEAR_REL)
