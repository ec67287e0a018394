"""Dry run: walk every (arch x shape x mesh) cell on a fake device.

Twin of ``repro.launch.dryrun``. For each cell it:
  1. builds the mesh: kind "one" is this process alone
     (``make_host_mesh((1, 1))``); "single" (16x16 over data x model) and
     "multi" (2x16x16 over pod x data x model) are the reference's
     production meshes, built with this process as rank 0 of a fake world
     of 256 or 512 ranks (``launch.mesh.fake_world``: torch's fake process
     group, whose collectives return at once and move nothing); the cell's
     build, walk and probes run inside that world, which is gone when the
     cell ends, even if it raised,
  2. builds the step (train_step / prefill / serve_step) with full config;
     its arguments are rank 0's blocks (``StepBundle.in_shapes``: the
     reference's per-device shard shapes),
  3. walks it once (``walk``): ``bundle.fn`` runs on fake tensors made from
     ``bundle.in_shapes`` under ``FakeTensorMode`` on the device, so a step
     of any size allocates nothing; ``FlopCounterMode`` counts its FLOPs,
     and two dispatch modes of this module the bytes its storages hold and
     its ops touch (``_LiveBytes``) and the collectives it issues
     (``_Collectives``),
  4. records the reference's ``_analyze`` keys, with ``walk_s`` in place of
     ``lower_s`` and ``compile_s``,
  5. walks reduced-layer probes and extrapolates them (``_reconstruct``).
     Eager runs every layer, so on the port the probes check
     ``_with_layers`` and the accounting rather than recover loop bodies.

What the numbers mean (counts of one rank's step, the same on any device;
not timings):
  flops_per_device  matmul FLOPs only (``FlopCounterMode``'s rule: mm, bmm,
                    addmm, baddbmm, convolutions, attention), not XLA's
                    count of every op.
  bytes_accessed    the sum over the aten ops the step dispatches of their
                    input and output tensors' bytes, leaving out what moves
                    nothing (views, reshapes, ``prim`` metadata queries):
                    eager PyTorch's unfused traffic, not XLA's post-fusion
                    count.
  argument_bytes    the inputs' bytes; ``output_bytes`` the outputs' (XLA
                    adds an 8-byte pointer per leaf of a tuple output).
  temp_bytes        the most bytes the step's own storages hold at once,
                    its outputs included, each storage rounded up to the
                    CUDA caching allocator's 512-byte blocks.
  peak_bytes        argument_bytes + temp_bytes.
  collectives       the reference's schema, from one ``(kind, nbytes,
                    group_size)`` record a c10d op the step issues (its
                    result's bytes, its group's size) through
                    ``collective_bytes``, the reference's ring accounting.
                    These are the port's explicit collectives, not the ones
                    GSPMD picks for the reference: the bytes by kind differ
                    from its HLO's; a world of one device records none.

``measure`` runs the same bundle for real on the card and returns the same
keys plus ``step_ms``. Nothing happens at import: no environment variable
is set and no device is touched.

Usage (the card by default; ``--device cpu`` walks fake host tensors):
  python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both --device cpu \
      --out results/dryrun_torch.json
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.registry import ARCHS, SHAPES, get_config, skip_reason
from repro_torch.distributed.mesh import available_devices
from repro_torch.launch.mesh import fake_world, make_host_mesh, make_production_mesh

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
ALLOC_BLOCK = 512     # the CUDA caching allocator rounds every block up to this
# views that the schema does not mark as such (matmul's reshapes of its result)
_RESHAPES = (torch.ops.aten._unsafe_view.default,)


# ---------------------------------------------------------------------------
# trees of tensors: dicts, lists, tuples and named tuples
# ---------------------------------------------------------------------------
def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tensors(tree):
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        if isinstance(tree, torch.Tensor):
            yield tree
        return
    for v in tree:
        yield from _tensors(v)


# ---------------------------------------------------------------------------
# collectives: the reference's ring accounting
# ---------------------------------------------------------------------------
def collective_bytes(records) -> dict:
    """Per-device bytes moved on the interconnect, by collective kind, from
    ``(kind, nbytes, group_size)`` records (one per op, ``nbytes`` its
    result's bytes).

    Ring-algorithm accounting per op (n = group size, at least 2):
    all-gather and reduce-scatter move (n-1)/n of the full tensor through
    each device; all-reduce = RS+AG = 2(n-1)/n; all-to-all (n-1)/n;
    collective-permute sends exactly its operand.
    """
    out: dict = {k: 0.0 for k in KINDS}
    out.update(n_ops=0, by_group_size={})
    for kind, nbytes, group_size in records:
        n = max(2, group_size)
        factor = {"all-gather": (n - 1) / n, "reduce-scatter": (n - 1) / n,
                  "all-reduce": 2 * (n - 1) / n, "all-to-all": (n - 1) / n,
                  "collective-permute": 1.0}[kind]
        out[kind] += nbytes * factor
        out["n_ops"] += 1
        # bucket by participant-group size: on the production meshes, group
        # size 2 == the pod axis, 16 == data or model, 32 == pod x data,
        # 256 or 512 == the world (a batch-1 cache's time cut over every axis)
        gk = str(n)
        out["by_group_size"][gk] = out["by_group_size"].get(gk, 0.0) + nbytes * factor
    return out


# ---------------------------------------------------------------------------
# the walk
# ---------------------------------------------------------------------------
class _LiveBytes(TorchDispatchMode):
    """Bytes held by the storages the ops create, their peak, and the bytes
    the ops touch. A storage counts from the op that first returns it until
    it dies (a weakref callback); the arguments' storages never count."""

    def __init__(self, arguments):
        super().__init__()
        self._known = {id(t.untyped_storage()): t for t in arguments}
        self._refs: dict[int, weakref.ref] = {}
        self.live = self.peak = self.accessed = 0

    def _free(self, key, nbytes, _ref):
        if self._refs.pop(key, None) is not None:
            self.live -= nbytes

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._known or key in self._refs:
            return
        nbytes = -(-st.nbytes() // ALLOC_BLOCK) * ALLOC_BLOCK
        self._refs[key] = weakref.ref(st, functools.partial(self._free, key, nbytes))
        self.live += nbytes
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = list(_tensors(out))
        for t in outs:
            self._track(t)
        if not (func.is_view or func.namespace == "prim" or func in _RESHAPES):
            self.accessed += sum(t.nbytes for t in (*_tensors((args, kwargs)), *outs))
        return out


# c10d's ops -> the reference's kinds; a ring hop counts once, at its send
# (``recv_`` is left out), as XLA's collective-permute is one op
_C10D_KINDS = {
    "allreduce_": "all-reduce", "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "send": "collective-permute",
}


class _Collectives(TorchDispatchMode):
    """One ``(kind, nbytes, group_size)`` record a collective the step
    issues: ``nbytes`` its result's bytes (the first argument of a c10d op
    is what it writes, or for a send what it sends), ``group_size`` the size
    of the process group it runs over."""

    def __init__(self):
        super().__init__()
        self.records: list[tuple[str, int, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kind = _C10D_KINDS.get(func._opname) if func.namespace == "c10d" else None
        if kind is not None:
            group = next(a for a in args if isinstance(a, torch.ScriptObject))
            nbytes = sum(t.nbytes for t in _tensors(args[0]))
            self.records.append((kind, nbytes, dist.ProcessGroup.unbox(group).size()))
        return func(*args, **(kwargs or {}))


def _account(fn, args) -> dict:
    """Run ``fn(*args)`` once under the counters; the ``_analyze`` record."""
    inputs = list(_tensors(args))
    live, colls = _LiveBytes(inputs), _Collectives()
    with FlopCounterMode(display=False) as flops, live, colls:
        out = fn(*args)
    arg_bytes = sum(t.nbytes for t in inputs)
    return {
        "flops_per_device": float(flops.get_total_flops()),
        "bytes_accessed": float(live.accessed),
        "argument_bytes": int(arg_bytes),
        "output_bytes": int(sum(t.nbytes for t in _tensors(out))),
        "temp_bytes": int(live.peak),
        "peak_bytes": int(arg_bytes + live.peak),
        "collectives": collective_bytes(colls.records),
    }


def walk(bundle, device="cuda") -> dict:
    """``bundle.fn`` once on fake tensors of ``bundle.in_shapes`` on
    ``device``: what it computes, touches and holds, allocating nothing."""
    dev = available_devices(device)[0]
    with FakeTensorMode():
        args = _tree_map(lambda m: torch.empty(m.shape, dtype=m.dtype, device=dev),
                         bundle.in_shapes)
        return _account(bundle.fn, args)


def measure(bundle, device="cuda") -> dict:
    """``bundle.fn`` for real on the card, on seeded inputs (floats
    N(0, 0.02), integers 0): the ``walk`` record measured. A first
    call counts FLOPs and bytes accessed (and warms the libraries'
    workspaces); a second is timed with CUDA events, and its temp bytes are
    ``max_memory_allocated`` above what was allocated before it."""
    dev = available_devices(device)[0]
    if dev.type != "cuda":
        raise ValueError(f"measure runs on a card, not {device!r}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def draw(m):
        if m.dtype.is_floating_point:
            return torch.empty(m.shape, dtype=m.dtype, device=dev).normal_(0.0, 0.02, generator=gen)
        return torch.zeros(m.shape, dtype=m.dtype, device=dev)

    args = _tree_map(draw, bundle.in_shapes)
    rec = _account(bundle.fn, args)
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = bundle.fn(*args)
    end.record()
    torch.cuda.synchronize(dev)
    temp = torch.cuda.max_memory_allocated(dev) - before
    del out, args
    rec.update(temp_bytes=int(temp), peak_bytes=int(rec["argument_bytes"] + temp),
               step_ms=start.elapsed_time(end))
    return rec


# ---------------------------------------------------------------------------
# probes
# ---------------------------------------------------------------------------
def _probe_layers(arch: str, family: str) -> list[int]:
    cfg = get_config(arch)
    p = len(cfg.attn_pattern) if family in ("dense", "moe", "vlm") else 1
    if family == "hybrid":
        return [3, 6, 8]     # (1 block), (2 blocks), (2 blocks + 2-layer tail)
    if family == "encdec":
        return [1, 2]
    return [p, 2 * p]


def _reconstruct(full: dict, probes: dict[int, dict], arch: str, family: str,
                 n_layers: int) -> dict:
    """Totals from reduced-layer probes (linear in L)."""
    ls = sorted(probes)
    keys = ["flops_per_device", "bytes_accessed"]
    ckeys = list(KINDS)

    def val(d, k):
        return d["collectives"][k] if k in ckeys else d[k]

    out = {}
    if family == "hybrid":
        l1, l2, l3 = ls  # 3, 6, 8
        for k in keys + ckeys:
            block = val(probes[l2], k) - val(probes[l1], k)       # per (r,r,a) block
            tail2 = val(probes[l3], k) - val(probes[l2], k)       # 2-layer rec tail
            base = val(probes[l1], k) - block
            n_blocks = n_layers // 3
            n_tail = n_layers - 3 * n_blocks
            out[k] = base + n_blocks * block + (tail2 / 2.0) * n_tail
    else:
        l1, l2 = ls[0], ls[1]
        for k in keys + ckeys:
            body = (val(probes[l2], k) - val(probes[l1], k)) / ((l2 - l1))
            base = val(probes[l1], k) - body * l1
            out[k] = base + body * n_layers
    return out


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _mesh(mesh_kind: str, device):
    """The cell's mesh: this process alone for "one"; for "single" and
    "multi", the production mesh with this process as rank 0 of a fake
    world of 256 or 512 ranks, destroyed on the way out."""
    if mesh_kind == "one":
        yield make_host_mesh((1, 1), device=device)
        return
    multi = mesh_kind == "multi"
    with fake_world(512 if multi else 256, device):
        yield make_production_mesh(multi_pod=multi, device=device)


def run_cell(arch: str, shape: str, mesh_kind: str = "one", *, device="cuda",
             sync_mode: str = "auto", microbatches: int = 1, probes: bool = True,
             cfg_overrides: dict | None = None,
             weight_stationary: bool = False) -> dict:
    """One cell's record: its build, its walk and its probes, on a
    production mesh inside that mesh's fake world (gone when this returns
    or raises)."""
    from repro_torch.launch.steps import build_cell

    with _mesh(mesh_kind, device) as mesh:
        rec: dict = {
            "arch": arch, "shape": shape, "mesh": mesh_kind, "devices": mesh.size,
            "sync_mode": sync_mode, "microbatches": microbatches,
            "cfg_overrides": cfg_overrides, "weight_stationary": weight_stationary,
        }
        t0 = time.perf_counter()
        kw = dict(cfg_overrides=cfg_overrides, weight_stationary=weight_stationary)
        bundle = build_cell(arch, shape, mesh, sync_mode=sync_mode,
                            microbatches=microbatches, **kw)
        rec.update(walk(bundle, mesh.device))
        rec["walk_s"] = round(time.perf_counter() - t0, 1)

        cfg = bundle.model.cfg
        rec["param_count"] = cfg.param_count()
        rec["active_param_count"] = cfg.active_param_count()

        if probes:
            fam = cfg.family
            probe_res = {}
            for L in _probe_layers(arch, fam):
                b2 = build_cell(arch, shape, mesh, sync_mode=sync_mode,
                                microbatches=1, layers_override=L, **kw)
                probe_res[L] = walk(b2, mesh.device)
            rec["extrapolated"] = _reconstruct(rec, probe_res, arch, fam, cfg.n_layers)
            rec["probes"] = {str(k): v for k, v in probe_res.items()}
        return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="one", choices=["one", "single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--sync-mode", default="auto", choices=["auto", "chunked"])
    ap.add_argument("--microbatches", type=int, default=0)  # 0 = per-arch auto
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    available_devices(args.device)      # a request for the card without one raises

    targets = []
    archs = ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    for a in archs:
        for s in shapes:
            for mk in meshes:
                targets.append((a, s, mk))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as fh:
            results = json.load(fh)

    for arch, shape, mk in targets:
        key = f"{arch}|{shape}|{mk}|{args.sync_mode}|mb{args.microbatches}"
        if key in results and "error" not in results[key]:
            print(f"[skip-cached] {key}")
            continue
        reason = skip_reason(arch, shape)
        if reason:
            results[key] = {"arch": arch, "shape": shape, "mesh": mk,
                            "skipped": reason}
            print(f"[skipped] {key}: {reason}")
        else:
            print(f"[run] {key} ...", flush=True)
            try:
                results[key] = run_cell(arch, shape, mk, device=args.device,
                                        sync_mode=args.sync_mode,
                                        microbatches=args.microbatches,
                                        probes=not args.no_probes)
                r = results[key]
                print(f"  ok: walk {r['walk_s']}s "
                      f"peak {r['peak_bytes']/1e9:.2f} GB "
                      f"flops/dev {r['flops_per_device']/1e12:.2f} TF(matmul)",
                      flush=True)
            except Exception as e:  # noqa: BLE001 — recorded, run continues
                traceback.print_exc()
                results[key] = {"arch": arch, "shape": shape, "mesh": mk,
                                "error": f"{type(e).__name__}: {e}"}
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=1)

    n_err = sum(1 for v in results.values() if "error" in v)
    print(f"done: {len(results)} cells, {n_err} errors -> {args.out}")
    return results


if __name__ == "__main__":
    main()
