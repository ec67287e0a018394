"""Virtual-time service testbed — the calibrated-simulator backend.

Runs the *same* batching (service.batcher), tenant-fair activation and mover
allocation (service.scheduler) as the real TransferService, but executes
tasks in virtual time against the calibrated WAN model (core.simulator)
instead of moving real bytes. This is how service-level questions — aggregate
Gb/s and p50/p99 task latency under mixed multi-tenant load, policy A vs
policy B — are answered at testbed scale (terabyte files, 100 Gb/s WAN)
without a testbed.

Fluid model: each ACTIVE task drains at the steady-state rate the calibrated
simulator predicts for its (files, chunking, movers) configuration; the WAN
cap is enforced max-min fair across active tasks; allocations are recomputed
at every arrival/activation/completion. Chunk-level transients inside one
task (pipelining warm-up, checksum tails) are already folded into the
predicted rate because predictions come from the event-stepped per-chunk
simulator.

Fault campaigns (``run_load(scenario=..., seed=...)``) execute the same
``repro_torch.faults`` scenarios the real engine runs, translated to fluid-model
equivalents:

  * corruption at ``bytes_per_error`` -> seeded Poisson draw of corrupt-chunk
    events per task, each costing one chunk re-move (extra bytes on the
    task's remaining counter — the chunk-granular re-fetch cost);
  * ``kill_movers`` -> the global mover budget shrinks when total progress
    crosses ``kill_at_frac`` (dead movers are not replaced at testbed scale);
  * outage windows  -> every active task's rate is zero for ``outage_s``
    virtual seconds once progress crosses ``outage_at_frac``;
  * ``torn_journal`` has no fluid equivalent (journals are a real-engine
    artifact) and is a no-op here.

The injected totals are accounted in ``LoadReport.faults`` so chaos sweeps
can report goodput retention and retry amplification against the clean run.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.core.scheduler import TransferRequest
from repro_torch.core.simulator import ALCF, DEFAULT_LINK, NERSC, LinkConfig, SiteConfig
from repro_torch.core.vclock import VirtualClock, Window
from repro_torch.faults.scenarios import Scenario
from repro_torch.service.batcher import BatchConfig, Batcher
from repro_torch.service.scheduler import (
    DEFAULT_QUOTA,
    ActivationIndex,
    AllocationEngine,
    TenantQuota,
)
from repro_torch.service.task import TransferItem


@dataclasses.dataclass(frozen=True)
class Submission:
    """One client request: a set of files submitted at ``time_s``."""

    time_s: float
    tenant: str
    file_bytes: tuple[int, ...]
    label: str = ""


@dataclasses.dataclass
class SimTask:
    task_id: str
    tenant: str
    label: str
    file_bytes: tuple[int, ...]
    chunk_bytes: int | None
    submit_s: float
    seq: int
    start_s: float | None = None
    done_s: float | None = None
    movers: int = 0
    remaining_bytes: float = 0.0
    rate_gbps: float = 0.0

    @property
    def total_bytes(self) -> int:
        return sum(self.file_bytes)

    @property
    def latency_s(self) -> float:
        assert self.done_s is not None
        return self.done_s - self.submit_s

    @property
    def wait_s(self) -> float:
        assert self.start_s is not None
        return self.start_s - self.submit_s


@dataclasses.dataclass
class FaultLog:
    """Faults injected into one virtual-time run (fluid-model accounting)."""

    corruptions: int = 0          # corrupt-chunk events drawn across tasks
    re_moved_bytes: float = 0.0   # extra bytes moved to heal them
    mover_kills: int = 0
    outage_s: float = 0.0         # virtual seconds of rate-zero window


@dataclasses.dataclass
class LoadReport:
    policy: str
    tasks: list[SimTask]
    makespan_s: float
    aggregate_gbps: float
    scenario: str = "clean"
    faults: FaultLog = dataclasses.field(default_factory=FaultLog)
    goodput_bytes: float = 0.0    # client-useful bytes (sum of task sizes)
    moved_bytes: float = 0.0      # bytes actually moved (goodput + re-moves)

    @property
    def retry_amplification(self) -> float:
        """moved/goodput — 1.0 means no byte was moved twice."""
        return self.moved_bytes / self.goodput_bytes if self.goodput_bytes else 1.0

    def latencies(self, *, large_bytes: int | None = None) -> list[float]:
        sel = self.tasks
        if large_bytes is not None:
            sel = [t for t in sel if max(t.file_bytes) >= large_bytes]
        return sorted(t.latency_s for t in sel)

    def percentile(self, q: float, **kw) -> float:
        lat = self.latencies(**kw)
        if not lat:
            return 0.0
        idx = min(len(lat) - 1, max(0, math.ceil(q / 100.0 * len(lat)) - 1))
        return lat[idx]

    @property
    def p50_s(self) -> float:
        return self.percentile(50)

    @property
    def p99_s(self) -> float:
        return self.percentile(99)


def run_load(
    submissions: Sequence[Submission],
    *,
    policy: str = "marginal",
    mover_budget: int = 64,
    max_concurrent: int = 16,
    chunk_bytes: int | None = 500 * 1000 * 1000,
    src: SiteConfig = ALCF,
    dst: SiteConfig = NERSC,
    link: LinkConfig = DEFAULT_LINK,
    batch: BatchConfig | None = None,
    quotas: dict[str, TenantQuota] | None = None,
    default_quota: TenantQuota = DEFAULT_QUOTA,
    alloc_step: int = 4,
    integrity: bool = True,
    scenario: Scenario | None = None,
    seed: int = 0,
    tracer=None,
) -> LoadReport:
    """Drive the service scheduling stack over a workload in virtual time.

    ``tracer`` (an ``obs.trace.Tracer``) receives one deterministic span set
    per task — queue wait, fluid drain, outage stalls — stamped with VIRTUAL
    timestamps, so two same-seed runs export byte-identical traces.
    """
    if max_concurrent > mover_budget:
        raise ValueError("max_concurrent must be <= mover_budget")
    engine = AllocationEngine(
        policy=policy, mover_budget=mover_budget, src=src, dst=dst, link=link,
        step=alloc_step, quotas=quotas, default_quota=default_quota,
    )
    batcher = Batcher(batch)

    # ---- batch every submission into tasks (the service's submit() path)
    tasks: list[SimTask] = []
    for sub in sorted(submissions, key=lambda s: s.time_s):
        items = [TransferItem(f"f{i}", f"f{i}", nb) for i, nb in enumerate(sub.file_bytes)]
        for group in batcher.split(items):
            sizes = tuple(it.nbytes for it in group)
            tasks.append(SimTask(
                task_id=f"task-{len(tasks):09d}-{sub.tenant}",
                tenant=sub.tenant,
                label=sub.label,
                file_bytes=sizes,
                chunk_bytes=chunk_bytes,
                submit_s=sub.time_s,
                seq=len(tasks),
                remaining_bytes=float(sum(sizes)),
            ))

    # ---- fault campaign: seeded fluid-model realisation
    flog = FaultLog()
    goodput_bytes = float(sum(t.total_bytes for t in tasks))
    if scenario is not None and scenario.bytes_per_error is not None:
        rng = np.random.default_rng(seed)
        for task in tasks:
            n = int(rng.poisson(task.total_bytes / scenario.bytes_per_error))
            if n:
                eff_chunk = min(task.chunk_bytes or task.total_bytes, task.total_bytes)
                extra = float(min(n * eff_chunk, 4 * task.total_bytes))
                task.remaining_bytes += extra     # chunk-granular re-fetch cost
                flog.corruptions += n
                flog.re_moved_bytes += extra
    grand_total = float(sum(t.remaining_bytes for t in tasks))
    kill_at = outage_at = None
    if scenario is not None and scenario.kill_movers > 0:
        kill_at = scenario.kill_at_frac * grand_total
    if scenario is not None and scenario.outage_at_frac is not None:
        outage_at = scenario.outage_at_frac * grand_total
    outage_win: Window | None = None
    outage_log: list[tuple[float, float]] = []   # closed windows, for spans
    moved_bytes = 0.0

    # heap-indexed pending set (same policy as the real scheduler): each
    # reschedule costs O(decisions log tenants), not a scan of every queued
    # task — the difference between 10^3-task and 10^6-task workloads here
    pending: dict[str, SimTask] = {}
    activation = ActivationIndex()
    active: list[SimTask] = []
    finished: list[SimTask] = []
    arrivals = sorted(tasks, key=lambda t: (t.submit_s, t.seq))
    ai = 0
    clock = VirtualClock(guard=20 * len(tasks) + 1000, label="testbed")

    def request_of(task: SimTask) -> TransferRequest:
        return TransferRequest(
            name=task.task_id, src=src, dst=dst,
            file_bytes=task.file_bytes, chunk_bytes=task.chunk_bytes,
            integrity=integrity,
        )

    def reschedule() -> None:
        # activation (tenant-fair), then mover allocation + fluid rates
        free = max_concurrent - len(active)
        if free > 0 and pending:
            chosen = activation.select(
                free, quotas=quotas, default_quota=default_quota,
                validate=lambda tid: tid in pending,
            )
            for tid in chosen:
                task = pending.pop(tid)
                task.start_s = clock.now
                active.append(task)
        if not active:
            return
        movers = engine.allocate([(a.task_id, a.tenant, request_of(a)) for a in active])
        for a in active:
            a.movers = max(1, movers.get(a.task_id, 1))
            secs = engine.predict_seconds(request_of(a), a.movers)
            a.rate_gbps = a.total_bytes * 8 / 1e9 / secs if secs > 0 else float("inf")
        # WAN is shared across tasks: max-min fair clamp (progressive filling)
        cap = link.wan_gbps
        todo = sorted(active, key=lambda a: a.rate_gbps)
        n_left = len(todo)
        for a in todo:
            share = cap / n_left
            got = min(a.rate_gbps, share)
            a.rate_gbps = got
            cap -= got
            n_left -= 1

    while ai < len(arrivals) or pending or active:
        # admit all submissions at the current time
        moved = False
        while ai < len(arrivals) and arrivals[ai].submit_s <= clock.now + 1e-12:
            task = arrivals[ai]
            pending[task.task_id] = task
            activation.add(task.seq, task.task_id, task.tenant)
            ai += 1
            moved = True
        if moved or active or pending:
            reschedule()
        # endpoint outage window: every active task's rate is zero
        in_outage = outage_win is not None and outage_win.contains(clock.now)
        if in_outage:
            for a in active:
                a.rate_gbps = 0.0
        agg_Bps = sum(a.rate_gbps for a in active) * 1e9 / 8
        # next event: earliest completion vs next arrival vs fault events
        cands = [
            a.remaining_bytes * 8 / 1e9 / a.rate_gbps
            for a in active if a.rate_gbps > 0
        ]
        if ai < len(arrivals):
            cands.append(arrivals[ai].submit_s - clock.now)
        if in_outage:
            cands.append(outage_win.until_end(clock.now))
        for trigger in (kill_at, outage_at):
            if trigger is not None and agg_Bps > 0 and moved_bytes < trigger:
                cands.append((trigger - moved_bytes) / agg_Bps)
        dt = clock.tick(*cands)
        for a in active:
            a.remaining_bytes -= a.rate_gbps * 1e9 / 8 * dt
        moved_bytes += agg_Bps * dt
        # fault triggers crossed by this step
        if kill_at is not None and moved_bytes >= kill_at - 1e-6:
            engine.mover_budget = max(1, engine.mover_budget - scenario.kill_movers)
            flog.mover_kills = scenario.kill_movers
            kill_at = None
        if outage_at is not None and moved_bytes >= outage_at - 1e-6:
            outage_win = Window(clock.now, scenario.outage_s)
            flog.outage_s = scenario.outage_s
            outage_at = None
        if outage_win is not None and clock.now >= outage_win.end - 1e-12:
            outage_log.append((outage_win.start, outage_win.end))
            outage_win = None
        done_now = [a for a in active if a.remaining_bytes <= 1e-6]
        for a in done_now:
            a.done_s = clock.now
            a.remaining_bytes = 0.0
            active.remove(a)
            activation.active_delta(a.tenant, -1)
            finished.append(a)

    if outage_win is not None:
        outage_log.append((outage_win.start, min(outage_win.end, clock.now)))

    # ---- deterministic trace emission (virtual timestamps, seq order)
    if tracer is not None:
        for t in sorted(finished, key=lambda t: t.seq):
            end = t.done_s if t.done_s is not None else clock.now
            start = t.start_s if t.start_s is not None else end
            tracer.add(
                "queue_wait", "queue", t.submit_s, start,
                task=t.task_id, lane="scheduler", tenant=t.tenant,
            )
            tracer.add(
                "drain", "wire", start, end, task=t.task_id, lane="fluid",
                tenant=t.tenant, bytes=t.total_bytes,
            )
            for (o0, o1) in outage_log:
                lo, hi = max(o0, start), min(o1, end)
                if hi > lo:
                    tracer.add(
                        "outage", "stall", lo, hi, task=t.task_id,
                        lane="fluid", kind="outage",
                    )
            tracer.add(
                "task", "task", t.submit_s, end, task=t.task_id,
                tenant=t.tenant, state="SUCCEEDED",
            )

    total_bytes = sum(t.total_bytes for t in tasks)
    t0 = min((t.submit_s for t in tasks), default=0.0)
    makespan = max((t.done_s or 0.0 for t in tasks), default=0.0) - t0
    return LoadReport(
        policy=policy,
        tasks=finished,
        makespan_s=makespan,
        aggregate_gbps=total_bytes * 8 / 1e9 / makespan if makespan > 0 else 0.0,
        scenario=scenario.name if scenario is not None else "clean",
        faults=flog,
        goodput_bytes=goodput_bytes,
        moved_bytes=moved_bytes,
    )


# ---------------------------------------------------------------------------
# canonical workloads
# ---------------------------------------------------------------------------
def mixed_workload(
    *,
    n_small: int = 1000,
    small_bytes: int = 100 * 1000 * 1000,
    n_large: int = 4,
    large_bytes: int = 1_000_000_000_000,
    tenants: int = 4,
) -> list[Submission]:
    """The paper's mixed workload: many small files + a few terabyte files,
    spread round-robin over tenants, all submitted at t=0."""
    subs: list[Submission] = []
    per = max(1, n_small // max(1, tenants))
    for k in range(tenants):
        lo, hi = k * per, min(n_small, (k + 1) * per) if k < tenants - 1 else n_small
        if hi > lo:
            subs.append(Submission(
                0.0, f"tenant{k}", tuple([small_bytes] * (hi - lo)), label="small",
            ))
    for j in range(n_large):
        subs.append(Submission(
            0.0, f"tenant{j % max(1, tenants)}", (large_bytes,), label="large",
        ))
    return subs
