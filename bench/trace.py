"""What a span of steps traced by torch.profiler says about the device.

The span's Chrome trace is read for the device's operations (kernels,
copies, fills), the host's operations and the launches that join them.

* ``busy_s``: the union of the device operations' intervals; the idle gaps
  between them are charged to the innermost host operation running when
  each gap starts (what the host was doing while the device waited).
* ``layers``: each wrapped layer's device seconds. While the span runs,
  ``wrapped`` puts each function that a per-layer metric names (its
  ``WRAPS``, ``"module:function"``) inside a ``record_function`` span
  ``bench.<metric>``. A device operation counts for a layer when its
  launch lies, on the launching thread, inside that span (the layer's
  forward, and remat's recompute of it), or inside an autograd node that
  the layer's forward made (its backward): the last forward operation to
  carry the node's sequence number, the one that made the node, lay inside
  the span (an operation that makes no node carries the next node's number). The engine's
  sums of a tensor's gradients, outside the node, count for no layer; nor
  does a launch inside a recomputed forward operation that no span holds,
  whichever node's backward ran the recompute.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import heapq
import importlib
import json
import os
import tempfile

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function"}
STACK_CATS = {"cpu_op", "user_annotation"}       # what a launch can lie inside
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
SPAN = "bench."
SEQ, FWD = "Sequence number", "Fwd thread id"
ENGINE = "autograd::engine::evaluate_function"   # around a node: the node, then gradient sums
TOP = 10


def _in_span(fn, name: str):
    from torch.profiler import record_function

    @functools.wraps(fn)
    def call(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)

    return call


@contextlib.contextmanager
def wrapped(targets: dict):
    """While the block runs, each ``"module:function"`` of ``targets``
    (layer name -> target) that the program has is called inside the span
    ``bench.<layer>``; one it does not have is left out."""
    undo = []
    try:
        for layer, target in targets.items():
            mod_name, fn_name = target.split(":")
            try:
                mod = importlib.import_module(mod_name)
                fn = getattr(mod, fn_name)
            except (ImportError, AttributeError):
                continue
            setattr(mod, fn_name, _in_span(fn, SPAN + layer))
            undo.append((mod, fn_name, fn))
        yield
    finally:
        for mod, fn_name, fn in reversed(undo):
            setattr(mod, fn_name, fn)


def traced(fn):
    """Run ``fn`` under torch.profiler (host and device); returns its parsed
    trace (``parse``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.remove(path)
    return parse(events)


def _union(intervals):
    """Merged (start, end) intervals of sorted ``intervals``."""
    out = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _complete(events):
    for ev in events:
        if ev.get("ph") == "X" and "dur" in ev:
            yield ev, float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])


def parse(events: list) -> dict:
    """busy_s, window_s (first device start to last device end, or the host
    span if longer), device_ops and idle_gaps (name, seconds), most first,
    and layers (``layer_seconds``)."""
    dev, host = [], []
    for ev, s, e in _complete(events):
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((s, e, ev.get("name", "?")))
        elif cat in HOST_CATS:
            host.append((s, e, ev.get("name", "?")))
    if not dev:
        return {"busy_s": 0.0, "window_s": 0.0, "device_ops": [], "idle_gaps": [], "layers": {}}
    dev.sort()
    host.sort()
    merged = _union((s, e) for s, e, _ in dev)
    busy_us = sum(e - s for s, e in merged)
    t0 = min(merged[0][0], host[0][0] if host else merged[0][0])
    t1 = max(merged[-1][1], max((e for _, e, _ in host), default=merged[-1][1]))
    by_op = collections.Counter()
    for s, e, name in dev:
        by_op[name] += e - s
    edges = [(t0, merged[0][0])] + [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    gaps = collections.Counter()
    for (gs, ge), name in zip(edges, _host_at(host, [gs for gs, _ in edges])):
        if ge > gs:
            gaps[name] += ge - gs
    return {
        "busy_s": busy_us / 1e6,
        "window_s": (t1 - t0) / 1e6,
        "device_ops": [[n[:200], us / 1e6] for n, us in by_op.most_common(TOP)],
        "idle_gaps": [[n[:200], us / 1e6] for n, us in gaps.most_common(TOP)],
        "layers": layer_seconds(events),
    }


def _host_at(host: list, times: list) -> list:
    """For each of the increasing ``times``, the innermost host operation
    open then (of those open, the one that started last), by one sweep over
    ``host`` sorted by start."""
    out, heap, i = [], [], 0
    for t in times:
        while i < len(host) and host[i][0] <= t:
            s, e, name = host[i]
            heapq.heappush(heap, (-s, e, name))
            i += 1
        while heap and heap[0][1] <= t:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else "(no host operation)")
    return out


def _stacks(ops: list, times: list) -> list:
    """For each of the sorted ``times``, the operations of one thread (``ops``:
    (start, end, event), sorted by start and outer first) open then,
    innermost first. Operations of one thread nest."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(ops) and ops[i][0] <= t:
            while stack and stack[-1][1] <= ops[i][0]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append([ev for _, _, ev in reversed(stack)])
    return out


def _owner(stack: list):
    """What a point of a thread with this stack (innermost first) belongs to:
    ("span", layer), ("node", sequence number) for an autograd node's
    backward, or None."""
    forward = False
    for ev in stack:
        name = ev.get("name", "")
        if ev.get("cat") == "user_annotation" and name.startswith(SPAN):
            return "span", name[len(SPAN):]
        args = ev.get("args", {})
        if SEQ not in args or name.startswith(ENGINE):
            continue
        if not args.get(FWD, 0):
            forward = True              # an operation of a forward, or of a recompute
        else:
            return None if forward else ("node", args[SEQ])
    return None


def layer_seconds(events: list) -> dict:
    """Device seconds of each layer whose span the trace holds (see the
    module's docstring)."""
    ops = collections.defaultdict(list)
    launches = {}
    spans = set()
    for ev, s, e in _complete(events):
        cat = ev.get("cat", "")
        if cat in STACK_CATS:
            ops[ev.get("tid")].append((s, e, ev))
            if cat == "user_annotation" and ev.get("name", "").startswith(SPAN):
                spans.add(ev["name"][len(SPAN):])
        elif cat in LAUNCH_CATS and "correlation" in ev.get("args", {}):
            launches[ev["args"]["correlation"]] = (ev.get("tid"), s)
    if not spans:
        return {}
    queries = collections.defaultdict(list)      # tid -> [(time, what)]
    for tid, lst in ops.items():
        lst.sort(key=lambda x: (x[0], -x[1]))
        for s, _e, ev in lst:
            args = ev.get("args", {})
            if SEQ in args and not args.get(FWD, 0):
                queries[tid].append((s, ("forward", args[SEQ])))
    for ev, _s, _e in _complete(events):
        if ev.get("cat") in DEVICE_CATS:
            at = launches.get(ev.get("args", {}).get("correlation"))
            if at is not None:
                queries[at[0]].append((at[1], ("device", float(ev["dur"]))))
    node_layer, device = {}, []
    for tid, qs in queries.items():
        qs.sort(key=lambda q: q[0])
        times = [t for t, _ in qs]
        for (_t, (kind, val)), stack in zip(qs, _stacks(ops.get(tid, []), times)):
            if kind == "forward":
                # a forward's operation, not a recompute inside a backward;
                # operations that make no node carry the next node's number,
                # so the last to carry a number, its node's maker, decides
                if not any(ev.get("args", {}).get(FWD, 0) for ev in stack):
                    owner = _owner(stack)
                    node_layer[val] = owner[1] if owner and owner[0] == "span" else None
            else:
                device.append((val, _owner(stack)))
    out = {layer: 0.0 for layer in spans}
    for dur, owner in device:
        layer = None
        if owner and owner[0] == "span":
            layer = owner[1]
        elif owner:
            layer = node_layer.get(owner[1])
        if layer is not None:
            out[layer] += dur / 1e6
    return out


def per_step_ms(run, layer: str):
    """``layer``'s device milliseconds a traced step, or None where the
    trace holds no span of it."""
    if run.trace is None or layer not in run.trace["layers"]:
        return None
    return 1e3 * run.trace["layers"][layer] / run.trace_steps
