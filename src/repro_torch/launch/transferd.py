"""transferd — drive the transfer-task service from the command line.

Service modes:

  * testbed (default): run a mixed multi-tenant workload through the
    service scheduling stack in virtual time against the calibrated
    ALCF->NERSC simulator, and report aggregate Gb/s + task-latency
    percentiles per allocation policy. This answers "which mover-allocation
    policy should the service run?" without a testbed:

        PYTHONPATH=src python -m repro_torch.launch.transferd \\
            --policy all --small 1000 --small-mb 100 --large 4 --large-gb 1000

  * --real DIR: spin a *real* TransferService in DIR, generate a small mixed
    batch of local files, submit them across two tenants, and print each
    task's lifecycle — a smoke test of the wall-clock path:

        PYTHONPATH=src python -m repro_torch.launch.transferd --real /tmp/transferd

Observability modes (``transferd top`` / ``transferd trace``):

  * ``top``    — live terminal snapshot of a draining service: one row per
    task (state, progress, wire-time quantiles, verify lag, faults) plus a
    registry header (active tasks per tenant, movers, aggregate bytes).
    Drives the same local smoke workload as ``--real``:

        ... transferd top --root /tmp/transferd-top

  * ``trace``  — run a workload with the span tracer attached and export a
    Chrome/Perfetto ``trace_event`` JSON (open at https://ui.perfetto.dev):

        ... transferd trace --export /tmp/testbed.trace.json           # virtual
        ... transferd trace --export /tmp/real.trace.json --real DIR   # real

Content-addressed store (``transferd cas <cmd>``, the dedup chunk index):

  * ``cas stats`` — entry/byte counts and hit/miss/stale counters of an
    endpoint's chunk-index log:

        ... transferd cas stats --index /tmp/transferd/state/cas/index.log

  * ``cas gc``    — compact the index log (drop superseded/discarded records
    and the torn tail, atomically rewrite):

        ... transferd cas gc --index /tmp/transferd/state/cas/index.log

Resilience plane (``transferd scrub``, the landed-data repair daemon):

  * ``scrub`` — one budgeted scrub pass over a service root: re-verify landed
    regions against their journal digests, repair bit-rot from replicas via
    the chunk index, quarantine regions with no surviving donor (the cursor
    resumes where the budget ran out, so cron-style invocations round-robin
    the whole fleet):

        ... transferd scrub --root /tmp/transferd/state --budget-mb 256

Fabric modes (``transferd fabric <cmd>``, the multi-endpoint WAN layer):

  * ``fabric plan``      — k-shortest routes between two endpoints:

        ... transferd fabric plan --topology chain --src src --dst d0 -k 3

  * ``fabric campaign``  — virtual-time 1->N replication campaign vs naive
    per-destination transfers (wire bytes + makespan), optionally under a
    chaos scenario:

        ... transferd fabric campaign --topology chain --fanout 4 --gb 100 \\
                --chaos link_outage_at_50pct+degrade_hop

  * ``fabric replicate`` — REAL fan-out campaign on local directories,
    decomposed into service tasks (one per distribution-tree edge):

        ... transferd fabric replicate --root /tmp/fabric --fanout 4 --kb 512

``--topology`` is a built-in shape (``chain`` / ``star`` / ``fat_tree``) or
a JSON topology file (see ``repro_torch.fabric.topology.Topology.save``).

This is the port's copy of ``repro.launch.transferd``, with one flag more:
``--device`` (default ``cuda``) is where every real mode digests — it is
handed to each ``TransferService`` the CLI builds (``--real``, ``top``,
``trace --real``, ``scrub``, ``fabric replicate``). Without a card,
``--device cuda`` raises before anything is written; ``--device cpu`` runs
the digest kernels' plain versions. The virtual modes (the testbed,
``trace`` without ``--real``, ``fabric plan`` and ``fabric campaign``) and
``cas stats`` / ``cas gc``, which read or compact the index log and take
no digest, use no device and print what the reference prints.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from repro_torch.core.chunker import MiB
from repro_torch.core.dataplane import resolve_device
from repro_torch.core.simulator import SITES
from repro_torch.service import (
    BatchConfig,
    ServiceConfig,
    TransferService,
    mixed_workload,
    run_load,
)

POLICIES = ("fair", "file_bound", "marginal")


def _device_flag(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="where the real modes digest: cuda (the card; raises "
                         "where there is none) or cpu (the kernels' plain "
                         "versions)")


def _fmt_row(policy: str, rep) -> str:
    return (
        f"{policy:11s} {rep.aggregate_gbps:9.2f} {rep.makespan_s:11.1f} "
        f"{rep.p50_s:9.1f} {rep.p99_s:9.1f} {len(rep.tasks):6d}"
    )


def run_testbed(args) -> dict[str, object]:
    work = mixed_workload(
        n_small=args.small,
        small_bytes=args.small_mb * 1000 * 1000,
        n_large=args.large,
        large_bytes=args.large_gb * 1000 * 1000 * 1000,
        tenants=args.tenants,
    )
    total = sum(sum(s.file_bytes) for s in work)
    chunk_bytes = args.chunk_mb * 1000 * 1000
    if args.tune:
        # SimTuner warm start: replace the static default with the
        # calibrated simulator's predicted-optimal size for the large files
        from repro_torch.tune import SimTuner

        tuner = SimTuner(SITES[args.src], SITES[args.dst])
        chunk_bytes = tuner.seed_chunk(args.large_gb * 1000 * 1000 * 1000)
        print(f"# sim-tuned chunk size: {chunk_bytes / 1e6:.0f} MB "
              f"(static default was {args.chunk_mb} MB)")
    print(f"# workload: {args.small} x {args.small_mb} MB + "
          f"{args.large} x {args.large_gb} GB over {args.tenants} tenants "
          f"({total / 1e12:.2f} TB total)")
    print(f"# budget: {args.movers} movers, {args.concurrent} concurrent tasks, "
          f"{args.src}->{args.dst}, chunk {chunk_bytes / 1e6:.0f} MB")
    print(f"{'policy':11s} {'agg Gb/s':>9s} {'makespan s':>11s} "
          f"{'p50 s':>9s} {'p99 s':>9s} {'tasks':>6s}")
    policies = POLICIES if args.policy == "all" else (args.policy,)
    reports = {}
    for pol in policies:
        t0 = time.perf_counter()
        rep = run_load(
            work,
            policy=pol,
            mover_budget=args.movers,
            max_concurrent=args.concurrent,
            chunk_bytes=chunk_bytes,
            src=SITES[args.src],
            dst=SITES[args.dst],
            batch=BatchConfig(
                direct_bytes=args.direct_mb * 1000 * 1000,
                batch_files=args.batch_files,
            ),
        )
        reports[pol] = rep
        print(_fmt_row(pol, rep) + f"   ({time.perf_counter() - t0:.1f}s wall)")
    if "marginal" in reports and "file_bound" in reports:
        m, f = reports["marginal"], reports["file_bound"]
        if f.aggregate_gbps > 0:
            print(f"# marginal/file_bound aggregate speedup: "
                  f"{m.aggregate_gbps / f.aggregate_gbps:.2f}x")
    return reports


def run_real(args) -> None:
    import numpy as np

    device = resolve_device(args.device)
    root = os.path.abspath(args.real)
    datadir = os.path.join(root, "data")
    os.makedirs(datadir, exist_ok=True)
    rng = np.random.default_rng(args.seed)

    budget = max(1, min(args.movers, 16))      # smoke mode: local threads
    svc = TransferService(
        os.path.join(root, "state"),
        ServiceConfig(
            mover_budget=budget,
            max_concurrent_tasks=max(1, min(4, args.concurrent, budget)),
            chunk_bytes=256 * 1024,
            batch=BatchConfig(direct_bytes=4 * MiB, batch_files=8),
            # --tune: close the chunk-size loop over every submitted task
            tuning="auto" if args.tune else "static",
            tune_min_chunk=32 * 1024,
            tune_max_chunk=4 * MiB,
        ),
        device=device,
    )
    events = []
    svc.subscribe(lambda e: events.append(e))

    all_ids = []
    for k in range(2):
        tenant = f"tenant{k}"
        items = []
        for i in range(6):
            p = os.path.join(datadir, f"{tenant}-small{i}.bin")
            with open(p, "wb") as fh:
                fh.write(rng.integers(0, 256, 300_000 + i, dtype=np.uint8).tobytes())
            items.append((p, p + ".out"))
        big = os.path.join(datadir, f"{tenant}-big.bin")
        with open(big, "wb") as fh:
            fh.write(rng.integers(0, 256, 8 * MiB, dtype=np.uint8).tobytes())
        items.append((big, big + ".out"))
        all_ids += svc.submit(items, tenant=tenant, label="smoke")

    print(f"submitted {len(all_ids)} tasks")
    for st in svc.wait_all(all_ids, timeout=120):
        tuned = (f" replans={st.replans} chunk={st.chunk_bytes_current}"
                 if st.tuning == "auto" else "")
        print(f"  {st.task_id:24s} {st.state:9s} files={st.n_files:2d} "
              f"chunks={st.chunks_done}/{st.chunks_total} "
              f"retries={st.retries} latency={st.latency_s:.2f}s{tuned}")
    kinds = {}
    for e in events:
        kinds[e.kind] = kinds.get(e.kind, 0) + 1
    print("events:", dict(sorted(kinds.items())))
    svc.close()


# ---------------------------------------------------------------------------
# observability subcommands
# ---------------------------------------------------------------------------
def _smoke_ids(svc, datadir, seed, *, tenants=2, n_small=4,
               small_kb=200, big_kb=2048):
    """Generate and submit a small mixed local workload; returns task ids."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ids = []
    for k in range(tenants):
        tenant = f"tenant{k}"
        items = []
        for i in range(n_small):
            p = os.path.join(datadir, f"{tenant}-small{i}.bin")
            with open(p, "wb") as fh:
                fh.write(rng.integers(
                    0, 256, small_kb * 1024 + i, dtype=np.uint8).tobytes())
            items.append((p, p + ".out"))
        big = os.path.join(datadir, f"{tenant}-big.bin")
        with open(big, "wb") as fh:
            fh.write(rng.integers(0, 256, big_kb * 1024, dtype=np.uint8).tobytes())
        items.append((big, big + ".out"))
        ids += svc.submit(items, tenant=tenant, label="smoke")
    return ids


def render_top(svc) -> str:
    """One ``transferd top`` frame: registry header + per-task metric rows."""
    from repro_torch.obs.metrics import REGISTRY

    snap = REGISTRY.snapshot()
    active = snap.get("service_active_tasks", {"series": {}})["series"]
    act = ", ".join(
        f"{k or 'default'}={int(v)}" for k, v in sorted(active.items())
    ) or "-"
    rows = [
        f"tenants active: {act}",
        f"{'task':26s} {'state':9s} {'prog':>5s} {'chunks':>9s} "
        f"{'wire p50/p99 ms':>16s} {'vlag p99 ms':>11s} {'faults':>6s} {'retries':>7s}",
    ]
    for st in sorted(svc.tasks(), key=lambda s: s.task_id):
        m = st.metrics or {}
        faults = sum((m.get("faults") or {}).values())
        chunks = f"{st.chunks_done}/{st.chunks_total}"
        rows.append(
            f"{st.task_id:26s} {st.state:9s} {st.progress * 100:4.0f}% "
            f"{chunks:>9s} "
            f"{m.get('wire_p50_s', 0.0) * 1e3:7.2f}/"
            f"{m.get('wire_p99_s', 0.0) * 1e3:<8.2f} "
            f"{m.get('verify_lag_p99_s', 0.0) * 1e3:11.2f} "
            f"{faults:6.0f} {st.retries:7d}"
        )
    return "\n".join(rows)


def top_main(argv) -> None:
    ap = argparse.ArgumentParser(
        prog="transferd top",
        description="live snapshot of a draining local service")
    ap.add_argument("--root", required=True, help="working directory")
    ap.add_argument("--interval", type=float, default=0.25)
    ap.add_argument("--frames", type=int, default=0,
                    help="stop after N frames (0 = until all tasks drain)")
    ap.add_argument("--seed", type=int, default=0)
    _device_flag(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    root = os.path.abspath(args.root)
    datadir = os.path.join(root, "data")
    os.makedirs(datadir, exist_ok=True)
    svc = TransferService(os.path.join(root, "state"), ServiceConfig(
        mover_budget=4, max_concurrent_tasks=2, chunk_bytes=128 * 1024,
        batch=BatchConfig(direct_bytes=1 << 30, batch_files=8),
    ), device=device)
    try:
        ids = _smoke_ids(svc, datadir, args.seed)
        frames = 0
        while True:
            print(f"--- transferd top · frame {frames} ---")
            print(render_top(svc))
            frames += 1
            if all(svc.status(i).done for i in ids):
                break
            if args.frames and frames >= args.frames:
                break
            time.sleep(args.interval)
    finally:
        svc.close()


def trace_main(argv) -> None:
    from repro_torch.obs.clock import Clock
    from repro_torch.obs.trace import Tracer

    ap = argparse.ArgumentParser(
        prog="transferd trace",
        description="run a workload under the span tracer and export a "
                    "Chrome/Perfetto trace_event JSON")
    ap.add_argument("--export", required=True, metavar="FILE")
    ap.add_argument("--real", default=None, metavar="DIR",
                    help="trace a real local smoke run instead of the "
                         "virtual testbed (which is deterministic per seed)")
    ap.add_argument("--small", type=int, default=40, help="# small testbed files")
    ap.add_argument("--large", type=int, default=2, help="# large testbed files")
    ap.add_argument("--chaos", nargs="?", default=None,
                    const="corrupt_1_per_TiB+kill_2_movers+outage_at_50pct",
                    help="scenario DSL for the testbed (bare --chaos uses "
                         "the standard compound scenario)")
    ap.add_argument("--seed", type=int, default=0)
    _device_flag(ap)
    args = ap.parse_args(argv)
    if args.real:
        device = resolve_device(args.device)
        root = os.path.abspath(args.real)
        datadir = os.path.join(root, "data")
        os.makedirs(datadir, exist_ok=True)
        svc = TransferService(os.path.join(root, "state"), ServiceConfig(
            mover_budget=4, max_concurrent_tasks=2, chunk_bytes=128 * 1024,
            batch=BatchConfig(direct_bytes=1 << 30, batch_files=8),
        ), device=device)
        try:
            svc.wait_all(_smoke_ids(svc, datadir, args.seed), timeout=300)
            tracer = svc.tracer
        finally:
            svc.close()
    else:
        from repro_torch.faults import parse_scenario

        tracer = Tracer(clock=Clock(lambda: 0.0, virtual=True))
        run_load(
            mixed_workload(n_small=args.small, n_large=args.large),
            scenario=parse_scenario(args.chaos) if args.chaos else None,
            seed=args.seed, tracer=tracer,
        )
    path = tracer.export(args.export)
    print(f"exported {len(tracer.spans())} spans "
          f"({len(tracer.tasks())} tasks) -> {path}")


# ---------------------------------------------------------------------------
# fabric subcommands
# ---------------------------------------------------------------------------
def _load_topology(spec: str, fanout: int):
    from repro_torch.fabric import BUILTIN_TOPOLOGIES, Topology

    if spec in BUILTIN_TOPOLOGIES:
        return BUILTIN_TOPOLOGIES[spec](fanout)
    if os.path.exists(spec):
        return Topology.load(spec)
    raise SystemExit(
        f"unknown topology {spec!r}: not a builtin "
        f"({sorted(BUILTIN_TOPOLOGIES)}) and no such file")


def fabric_plan(args) -> None:
    from repro_torch.fabric import RoutePlanner

    topo = _load_topology(args.topology, args.fanout)
    planner = RoutePlanner(topo)
    nbytes = int(args.gb * 1e9)
    routes = planner.k_shortest(args.src, args.dst, nbytes, args.k)
    print(f"# {args.src} -> {args.dst}, {args.gb} GB, k={args.k}")
    for i, r in enumerate(routes):
        print(f"{i}: {' -> '.join(r.nodes)}   ({r.seconds:.2f}s est, "
              f"{r.n_hops} hops)")


def fabric_campaign(args) -> None:
    from repro_torch.fabric import (
        RoutePlanner,
        build_distribution_tree,
        naive_wire_hops,
        simulate_campaign,
        simulate_naive,
    )
    from repro_torch.faults import parse_scenario

    topo = _load_topology(args.topology, args.fanout)
    planner = RoutePlanner(topo)
    nbytes = int(args.gb * 1e9)
    dests = args.dests or [f"d{i}" for i in range(args.fanout)]
    tree = build_distribution_tree(planner, args.src, dests, nbytes)
    scenario = parse_scenario(args.chaos) if args.chaos else None
    camp = simulate_campaign(topo, tree, nbytes, scenario=scenario, seed=args.seed)
    naive = simulate_naive(topo, args.src, dests, nbytes,
                           scenario=scenario, seed=args.seed)
    hops = naive_wire_hops(RoutePlanner(topo), args.src, dests, nbytes)
    print(f"# campaign {args.src} -> {dests} ({args.gb} GB each, "
          f"scenario={camp.scenario})")
    print("tree:")
    for u, v in tree.edges:
        print(f"  {u} -> {v}")
    print(f"{'':14s}{'wire GB':>10s}{'makespan s':>12s}{'agg Gb/s':>10s}")
    for name, rep in (("campaign", camp), ("naive", naive)):
        print(f"{name:14s}{rep.wire_bytes / 1e9:10.1f}{rep.makespan_s:12.1f}"
              f"{rep.aggregate_gbps:10.1f}")
    print(f"# wire reduction: {hops * nbytes / tree.wire_bytes(nbytes):.2f}x, "
          f"makespan speedup: "
          f"{naive.makespan_s / camp.makespan_s if camp.makespan_s else 1.0:.2f}x")
    if camp.victims:
        print(f"# fault victims: {camp.victims}")


def fabric_replicate(args) -> None:
    import numpy as np

    from repro_torch.fabric import CampaignRunner

    device = resolve_device(args.device)
    topo = _load_topology(args.topology, args.fanout)
    root = os.path.abspath(args.root)
    dirs = {}
    for name in topo.endpoints:
        dirs[name] = os.path.join(root, name)
        os.makedirs(dirs[name], exist_ok=True)
    nbytes = args.kb * 1024
    src_file = os.path.join(dirs[args.src], "replica.bin")
    with open(src_file, "wb") as fh:
        fh.write(np.random.default_rng(args.seed)
                 .integers(0, 256, nbytes, dtype=np.uint8).tobytes())
    dests = args.dests or [f"d{i}" for i in range(args.fanout)]
    svc = TransferService(os.path.join(root, "svc"), ServiceConfig(
        mover_budget=4, max_concurrent_tasks=4, chunk_bytes=64 * 1024,
        tick_s=0.002, batch=BatchConfig(direct_bytes=1 << 30, batch_files=64),
    ), device=device)
    try:
        rep = CampaignRunner(svc, topo, dirs).replicate(
            "replica.bin", args.src, dests, tenant=args.tenant, timeout=300)
    finally:
        svc.close()
    print(f"campaign {rep.state}: {rep.replicas_verified}/{len(dests)} replicas "
          f"verified, {rep.integrity_escapes} escapes")
    for (u, v), tid in rep.edge_tasks.items():
        print(f"  {u} -> {v}: {tid} {rep.edge_states.get((u, v), '?')}")
    print(f"wire bytes {rep.wire_bytes} vs naive {rep.naive_wire_bytes} "
          f"({rep.wire_reduction:.2f}x), {rep.seconds:.2f}s")
    if rep.state != "SUCCEEDED":
        raise SystemExit(1)


# ---------------------------------------------------------------------------
# content-addressed store subcommands
# ---------------------------------------------------------------------------
def cas_stats(args) -> None:
    from repro_torch.cas import ChunkIndex

    with ChunkIndex(args.index) as idx:
        s = idx.stats()
        print(f"# chunk index {os.path.abspath(args.index)}")
        print(f"digests        {s['digests']}")
        print(f"locations      {s['locations']}")
        print(f"indexed bytes  {s['indexed_bytes']}")
        print(f"log bytes      {s['log_bytes']}")
        print(f"hits / misses  {int(s['hits'])} / {int(s['misses'])}")
        print(f"stale entries  {int(s['stale'])}")


def cas_gc(args) -> None:
    from repro_torch.cas import ChunkIndex

    with ChunkIndex(args.index) as idx:
        rep = idx.compact()
    saved = rep["bytes_before"] - rep["bytes_after"]
    print(f"compacted {os.path.abspath(args.index)}: "
          f"{rep['records']} live records, "
          f"{rep['bytes_before']} -> {rep['bytes_after']} bytes "
          f"({saved} reclaimed)")


def cas_main(argv) -> None:
    ap = argparse.ArgumentParser(prog="transferd cas",
                                 description="content-addressed chunk store")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("stats", help="entry counts + hit/miss/stale counters")
    p.add_argument("--index", required=True, help="chunk-index log path")
    p.set_defaults(fn=cas_stats)

    p = sub.add_parser("gc", help="compact the index log")
    p.add_argument("--index", required=True, help="chunk-index log path")
    p.set_defaults(fn=cas_gc)

    args = ap.parse_args(argv)
    args.fn(args)


def scrub_main(argv) -> None:
    ap = argparse.ArgumentParser(
        prog="transferd scrub",
        description="re-verify landed regions against their journal digests "
                    "and repair bit-rot from replicas via the chunk index")
    ap.add_argument("--root", required=True, help="service state directory")
    ap.add_argument("--task", default=None,
                    help="scrub one task id (default: every SUCCEEDED task)")
    ap.add_argument("--budget-mb", type=float, default=None,
                    help="max MiB re-read this pass (the cursor resumes "
                         "where the budget ran out)")
    ap.add_argument("--no-repair", action="store_true",
                    help="detect and quarantine only, never rewrite")
    _device_flag(ap)
    args = ap.parse_args(argv)
    from repro_torch.service import TransferService

    svc = TransferService(args.root, device=args.device)
    try:
        budget = (None if args.budget_mb is None
                  else int(args.budget_mb * 1024 * 1024))
        rep = svc.scrub(args.task, budget_bytes=budget,
                        repair=not args.no_repair)
    finally:
        svc.close()
    print(f"scanned    {rep.scanned} regions / {rep.scanned_bytes} bytes "
          f"({rep.clean} clean, {rep.remaining} past budget)")
    print(f"rot        {rep.rot_detected} detected, {rep.repaired} repaired, "
          f"{rep.quarantined} quarantined")
    for t in rep.quarantines:
        print(f"QUARANTINE {t.task_id} item {t.item} chunk {t.chunk} "
              f"@ {t.path}+{t.offset}")
    if rep.quarantined:
        sys.exit(1)


def fabric_main(argv) -> None:
    ap = argparse.ArgumentParser(prog="transferd fabric",
                                 description="multi-endpoint WAN fabric tools")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p, *, real=False):
        p.add_argument("--topology", default="chain",
                       help="chain | star | fat_tree | topology JSON file")
        p.add_argument("--fanout", type=int, default=4)
        p.add_argument("--src", default="src")
        p.add_argument("--dests", nargs="*", default=None)
        p.add_argument("--seed", type=int, default=0)
        if real:
            _device_flag(p)
        else:
            p.add_argument("--gb", type=float, default=100.0,
                           help="payload size per replica (GB)")

    p = sub.add_parser("plan", help="k-shortest routes between two endpoints")
    common(p)
    p.add_argument("--dst", default="d0")
    p.add_argument("-k", type=int, default=3)
    p.set_defaults(fn=fabric_plan)

    p = sub.add_parser("campaign", help="virtual 1->N campaign vs naive")
    common(p)
    p.add_argument("--chaos", default=None,
                   help="scenario DSL, e.g. link_outage_at_50pct+degrade_hop")
    p.set_defaults(fn=fabric_campaign)

    p = sub.add_parser("replicate", help="real fan-out campaign on local dirs")
    common(p, real=True)
    p.add_argument("--root", required=True, help="working directory")
    p.add_argument("--kb", type=int, default=512, help="payload size (KiB)")
    p.add_argument("--tenant", default="default")
    p.set_defaults(fn=fabric_replicate)

    args = ap.parse_args(argv)
    args.fn(args)


def main(argv=None):
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "fabric":
        fabric_main(argv[1:])
        return None
    if argv and argv[0] == "cas":
        cas_main(argv[1:])
        return None
    if argv and argv[0] == "scrub":
        scrub_main(argv[1:])
        return None
    if argv and argv[0] == "top":
        top_main(argv[1:])
        return None
    if argv and argv[0] == "trace":
        trace_main(argv[1:])
        return None
    ap = argparse.ArgumentParser(prog="transferd", description=__doc__)
    ap.add_argument("--policy", default="all", choices=POLICIES + ("all",))
    ap.add_argument("--movers", type=int, default=64)
    ap.add_argument("--concurrent", type=int, default=16)
    ap.add_argument("--small", type=int, default=1000, help="# small files")
    ap.add_argument("--small-mb", type=int, default=100)
    ap.add_argument("--large", type=int, default=4, help="# large files")
    ap.add_argument("--large-gb", type=int, default=1000)
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--chunk-mb", type=int, default=500)
    ap.add_argument("--direct-mb", type=int, default=500, help="direct-route threshold")
    ap.add_argument("--batch-files", type=int, default=64)
    ap.add_argument("--src", default="ALCF", choices=sorted(SITES))
    ap.add_argument("--dst", default="NERSC", choices=sorted(SITES))
    ap.add_argument("--real", default=None, metavar="DIR",
                    help="run a real local service smoke test in DIR instead")
    ap.add_argument("--tune", action="store_true",
                    help="autotune chunk sizes: SimTuner-seeded chunks in "
                         "testbed mode, closed-loop tuning in --real mode")
    ap.add_argument("--seed", type=int, default=0)
    _device_flag(ap)
    args = ap.parse_args(argv)
    if args.concurrent > args.movers:
        ap.error(f"--concurrent ({args.concurrent}) must be <= --movers "
                 f"({args.movers}): every active task needs a mover")

    if args.real:
        run_real(args)
        return None
    return run_testbed(args)


if __name__ == "__main__":
    main()
