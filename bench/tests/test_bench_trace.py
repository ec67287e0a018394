"""Layer times from a trace (``bench.trace``), on the CPU: a CPU trace has no
kernels, so each innermost host operation launches one made-up kernel of
1 us. A toy under remat is held to an attribution worked out another way
(by the profiler's forward-to-backward flow events), and every per-layer
metric that names a function of the program finds it called in the small
cells' step, in the forward and in the backward."""
import json
import sys
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils.checkpoint import checkpoint

from bench import spec, train
from bench import trace as tr
from bench.reference.dims import Dims
from bench.tests.small import CELLS, small_cell

US = 1e-6


def cpu_trace(fn, tmp_path) -> list:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def with_kernels(events: list) -> tuple[list, list]:
    """``events`` with a launch and a 1 us kernel in the middle of each
    innermost host operation; and those (tid, time) launch points."""
    by_tid = {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in tr.STACK_CATS and ev.get("dur", 0) > 0:
            by_tid.setdefault(ev["tid"], []).append(ev)
    out, points = list(events), []
    for tid, evs in by_tid.items():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        for i, ev in enumerate(evs):
            end = ev["ts"] + ev["dur"]
            if i + 1 < len(evs) and evs[i + 1]["ts"] < end:
                continue                                   # not innermost
            t, cid = ev["ts"] + ev["dur"] / 2, len(points) + 1
            out.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": tid,
                        "ts": t, "dur": 0, "args": {"correlation": cid}})
            out.append({"ph": "X", "cat": "kernel", "name": ev["name"], "tid": 0, "ts": t,
                        "dur": 1.0, "args": {"correlation": cid}})
            points.append((tid, t))
    return out, points


def open_at(events, tid, t):
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in tr.STACK_CATS
            and e["tid"] == tid and e["ts"] <= t < e["ts"] + e["dur"]]


def expected_by_flows(events: list, points: list) -> dict:
    """Each launch point's layer, worked out by containment and by the
    profiler's fwdbwd flows (a flow starts at a forward operation and ends
    at the autograd node that runs its backward)."""
    span = lambda e: e["cat"] == "user_annotation" and e["name"].startswith(tr.SPAN)  # noqa: E731
    node = lambda e: (e.get("args", {}).get(tr.FWD, 0) != 0                           # noqa: E731
                      and not e["name"].startswith(tr.ENGINE))
    forward = lambda e: tr.SEQ in e.get("args", {}) and not node(e)                    # noqa: E731
    flow_layer = {}
    for f in events:
        if f.get("cat") == "fwdbwd" and f.get("ph") == "s":
            here = open_at(events, f["tid"], f["ts"])
            spans = [e for e in here if span(e)]
            if spans and not any(node(e) for e in here):
                flow_layer[f["id"]] = spans[0]["name"][len(tr.SPAN):]
    node_layer = {(f["tid"], f["ts"]): flow_layer[f["id"]] for f in events
                  if f.get("cat") == "fwdbwd" and f.get("ph") == "f" and f["id"] in flow_layer}
    out = {}
    for tid, t in points:
        here = open_at(events, tid, t)
        spans = sorted((e for e in here if span(e)), key=lambda e: e["ts"])
        nodes = sorted((e for e in here if node(e)), key=lambda e: e["ts"])
        layer = None
        if spans:
            layer = spans[-1]["name"][len(tr.SPAN):]
        elif nodes and not any(forward(e) and e["ts"] >= nodes[-1]["ts"] for e in here):
            layer = node_layer.get((tid, nodes[-1]["ts"]))
        if layer is not None:
            out[layer] = out.get(layer, 0) + 1
    return out


def test_toy_layers_under_remat(tmp_path, monkeypatch):
    toy = types.ModuleType("bench_trace_toy")
    toy.a = lambda x, w: (x @ w).sin()
    toy.b = lambda x, w: (x @ w).tanh()
    monkeypatch.setitem(sys.modules, "bench_trace_toy", toy)
    a = toy.a
    gen = torch.Generator().manual_seed(0)
    x, wa, wb = (torch.randn((8, 8), generator=gen, requires_grad=True) for _ in range(3))

    def block(x, wa, wb):       # between the two layers, work of neither
        return toy.b(toy.a(x, wa).cos() @ wa, wb)

    def step():
        y = checkpoint(block, x, wa, wb, use_reentrant=False)
        torch.autograd.grad(y.square().sum(), (x, wa, wb))

    targets = {"a_ms": "bench_trace_toy:a", "b_ms": "bench_trace_toy:b",
               "gone_ms": "bench_trace_toy:missing", "nowhere_ms": "bench_no_such_module:f"}
    with tr.wrapped(targets):
        events = cpu_trace(step, tmp_path)
    assert toy.a is a                                      # unwrapped again
    events, points = with_kernels(events)
    want = expected_by_flows(events, points)
    got = tr.layer_seconds(events)
    assert set(got) == {"a_ms", "b_ms"}
    assert {k: round(v / US) for k, v in got.items()} == want
    # the backward counts too: more than the forward spans hold
    in_spans = {k: 0 for k in want}
    for tid, t in points:
        names = [e["name"][len(tr.SPAN):] for e in open_at(events, tid, t)
                 if e["name"].startswith(tr.SPAN)]
        if names:
            in_spans[names[0]] += 1
    assert all(want[k] > in_spans[k] > 0 for k in want), (want, in_spans)
    assert sum(want.values()) < len(points)                # the work between counts for neither


@pytest.mark.parametrize("name", CELLS)
def test_each_wrapped_function_runs_in_the_step(name, tmp_path):
    """One step of the small cell under the wrapping that a traced run uses:
    every metric that names a function of the program gets a span, and
    its layer's time holds forward and backward (the optimizer: forward)."""
    from repro_torch.optim import adamw

    from bench.reference import tokens

    cell = small_cell(name, dtype="float32")
    dm = Dims.of(cell.config)
    prog = train.build_program(cell.config, cell.traffic, dm)
    params = train.load_weights(prog, dm, 7, "cpu")
    opt = adamw.init(params, prog.ocfg)
    batch = {"tokens": tokens.batch(7, 1, 4, 32, dm.vocab, "cpu")}
    wraps = {}
    for m in cell.per_layer:
        mod = spec.metric_module(m["name"])
        if hasattr(mod, "WRAPS"):
            wraps[m["name"]] = mod.WRAPS
    with tr.wrapped(wraps):
        events = cpu_trace(lambda: prog.step_fn(params, opt, batch), tmp_path)
    events, points = with_kernels(events)
    got = tr.layer_seconds(events)
    assert set(got) == set(wraps)
    assert got == pytest.approx({k: v * US for k, v in expected_by_flows(events, points).items()})
    for layer, seconds in got.items():
        forward = sum(1 for tid, t in points
                      if any(e["name"] == tr.SPAN + layer for e in open_at(events, tid, t)))
        if layer == "adamw_ms":
            assert round(seconds / US) == forward > 0
        else:
            assert round(seconds / US) > forward > 0, layer
