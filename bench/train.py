"""The training kind of cell: one train step of the port, driven from the seed.

Set-up builds the program's step (``repro_torch.launch.steps.
build_train_step`` on the configuration's model, ``launch.train.rebuild``
from the registry's), loads the seed's weights into its parameter tree,
and runs the checked steps through the same step and feed as the window,
keeping the numbers the reference is compared with: each step's loss,
each leaf's norm of the first clipped gradient (from AdamW's first moment
after step 1) and of the weights' change over the checked steps. Those
steps warm up every shape. The window then dispatches steps, each on a new
batch, until ``seconds`` have passed, and waits for the last; the losses
stay on the device until it has closed. With ``trace``, ``TRACE_STEPS``
more steps run under torch.profiler, with the functions that the per-layer
metrics name inside spans of their own (``bench.trace``), and each
per-layer reader reads the trace or the window.
Then the program's state is freed and the reference runs the checked steps
again from the seed, in float32.
"""
from __future__ import annotations

import dataclasses
import gc
import inspect
import time

import torch

from bench import check, flops, spec
from bench.reference import readings as ref_readings
from bench.reference import tokens, weights
from bench.reference.dims import DTYPES, Dims
from bench.reference.precision import F32

TRACE_STEPS = 3         # steps under torch.profiler after the window


def port_fields(config: dict, dm: Dims) -> dict:
    """The program's ``ModelConfig`` fields that the configuration file sets."""
    fields = dict(n_layers=dm.layers, d_model=dm.d, n_heads=dm.heads, n_kv_heads=dm.kv_heads,
                  head_dim=dm.hd, d_ff=dm.ff, vocab=dm.vocab, rope_theta=dm.theta,
                  act=config["hidden_act"], tie_embeddings=dm.tie, dtype=dm.dtype,
                  remat=config["remat"])
    if dm.family == "moe":
        fields.update(n_experts=dm.experts, top_k=dm.top_k)
    return fields


@dataclasses.dataclass
class Program:
    """The system under test: the model, its step and what the step is given."""
    model: object
    step_fn: object
    ocfg: object
    param_shapes: dict        # leaf path -> the step's parameter as a meta tensor


def build_program(config: dict, traffic: dict, dm: Dims) -> Program:
    from repro_torch.configs.registry import ShapeCell, build_model
    from repro_torch.launch.steps import build_train_step
    from repro_torch.launch.train import rebuild
    from repro_torch.models import common
    from repro_torch.optim import adamw

    eps = inspect.signature(common.rms_norm).parameters["eps"].default
    if eps != dm.eps:
        raise ValueError(f"the configuration's rms_norm_eps {dm.eps} is not the program's {eps}")
    model = build_model(config["port_arch"])
    if (model.cfg.family == "moe") != (dm.family == "moe"):
        raise ValueError(f"{config['port_arch']} is of family {model.cfg.family}")
    cfg = dataclasses.replace(model.cfg, **port_fields(config, dm))
    if cfg != model.cfg:
        model = rebuild(model, cfg)
    if dm.family == "moe":
        model.cf = dm.capacity_factor
    opt = dict(traffic["optimizer"])
    ocfg = adamw.AdamWConfig(**{**opt, "state_dtype": DTYPES[opt["state_dtype"]]})
    shape = ShapeCell("bench", traffic["seq_len"], traffic["global_batch"], "train")
    bundle = build_train_step(model, None, ocfg, cell=shape)
    return Program(model, bundle.fn, ocfg, weights.flatten(bundle.in_shapes[0]))


def load_weights(prog: Program, dm: Dims, seed: int, device) -> dict:
    """The seed's weights as the program's parameter tree, in its leaf order;
    every leaf's shape and type checked against what the step takes."""
    drawn = weights.draw(dm, seed, device)
    if sorted(drawn) != sorted(prog.param_shapes):
        raise ValueError(f"weights {sorted(drawn)} for a step that takes {sorted(prog.param_shapes)}")
    for path, meta in prog.param_shapes.items():
        t = drawn[path]
        if t.shape != meta.shape or t.dtype != meta.dtype:
            raise ValueError(f"{path}: drawn {tuple(t.shape)} {t.dtype}, "
                             f"the step takes {tuple(meta.shape)} {meta.dtype}")
    return weights.nest({path: drawn[path] for path in prog.param_shapes})


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Run:
    """What a run hands the per-layer readers."""
    cell: spec.Cell
    device: torch.device
    window_s: float
    window_steps: int
    step_flops: float
    trace: dict | None        # ``bench.trace.parse`` of the traced steps
    trace_steps: int


def program_readings(prog: Program, dm: Dims, traffic: dict, seed: int, device):
    """Set-up: the seed's weights through the checked steps. Returns (params,
    opt state, the program's ``Readings``, feed)."""
    from repro_torch.optim import adamw

    B, S = traffic["global_batch"], traffic["seq_len"]

    def feed(step: int) -> dict:
        return {"tokens": tokens.batch(seed, step, B, S, dm.vocab, device)}

    params = load_weights(prog, dm, seed, device)
    opt = adamw.init(params, prog.ocfg)
    losses, grads = [], None
    for k in range(1, ref_readings.STEPS + 1):
        params, opt, stats = prog.step_fn(params, opt, feed(k))
        losses.append(stats["loss"])
        if k == 1:          # the clipped gradient, from m = (1 - b1) g
            grads = {p: torch.linalg.vector_norm(m.float()) / (1.0 - prog.ocfg.b1)
                     for p, m in weights.flatten(opt.m).items()}
    changes = ref_readings.change_norms(weights.flatten(params), dm, seed)
    got = ref_readings.Readings([float(x) for x in losses],
                                {p: float(g) for p, g in grads.items()}, changes)
    return params, opt, got, feed


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run of a training cell; the result line's object."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    traffic, dm = cell.traffic, Dims.of(cell.config)
    prog = build_program(cell.config, traffic, dm)
    params, opt, got, feed = program_readings(prog, dm, traffic, seed, device)
    sync(device)
    setup_s = time.perf_counter() - t_start

    # ---- the window
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    step, window_losses = ref_readings.STEPS + 1, []
    t0 = time.perf_counter()
    while True:
        params, opt, stats = prog.step_fn(params, opt, feed(step))
        window_losses.append(stats["loss"])
        step += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    window_s = time.perf_counter() - t0
    n_steps = len(window_losses)
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    nonfinite = int((~torch.isfinite(torch.stack(window_losses))).sum())
    step_tokens = traffic["seq_len"] * traffic["global_batch"]
    out = {
        "attempted": n_steps,
        "failed": nonfinite,
        "metrics": {},
        "device": {"memory_peak_bytes": peak},
        "window": {"steps": n_steps, "seconds": window_s, "tokens_per_step": step_tokens},
    }
    e2e = {
        "train_tokens_per_s": n_steps * step_tokens / window_s,
        "train_peak_gb": peak / 1e9 if peak is not None else None,
        "setup_s": setup_s,
    }

    # ---- the traced span and the per-layer readers
    traced = None
    if trace:
        from bench import trace as tr

        readers = {m["name"]: spec.metric_module(m["name"]) for m in cell.per_layer}
        wraps = {name: mod.WRAPS for name, mod in readers.items() if hasattr(mod, "WRAPS")}

        def span():
            nonlocal params, opt, step
            with tr.wrapped(wraps):
                for _ in range(TRACE_STEPS):
                    params, opt, _stats = prog.step_fn(params, opt, feed(step))
                    step += 1

        if on_card:
            traced = tr.traced(span)
            out["device"].update(busy_s=traced["busy_s"], window_s=traced["window_s"])
            out["breakdown"] = {"device_ops": traced["device_ops"],
                                "idle_gaps": traced["idle_gaps"]}
        ctx = Run(cell, device, window_s, n_steps,
                  flops.train_step_flops(dm, traffic["seq_len"], traffic["global_batch"]),
                  traced, TRACE_STEPS)
        for m in cell.per_layer:
            value = readers[m["name"]].read(ctx)
            if value is not None:
                out["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if e2e.get(m["name"]) is not None:
                out["metrics"][m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    # ---- the comparison, once the program's state is gone
    del params, opt, window_losses, prog
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    values = check.numbers(got, reference_readings(dm, traffic, seed, device))
    values["nonfinite_losses"] = nonfinite
    out["correct"], out["checks"] = check.judge(values, cell.limits)
    return out


def reference_readings(dm: Dims, traffic: dict, seed: int, device, prec=F32, **kw):
    """The reference's readings, float32 products with TF32 off on the card."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return ref_readings.reference(dm, traffic, seed, device, prec, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
