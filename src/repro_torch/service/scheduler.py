"""Service-level scheduling: tenant-fair activation + mover allocation.

Two decisions, both shared by the real (wall-clock) service and the
virtual-time testbed:

  1. *Which pending tasks go ACTIVE* — bounded by the global concurrent-task
     cap and per-tenant quotas, selected round-robin by tenant load so a
     tenant with one task is not starved behind another tenant's backlog
     (max-min fairness over task slots).

  2. *How many movers each ACTIVE task gets* — delegated to the chunk-aware
     allocator (core.scheduler): "fair", "file_bound" (the pre-chunking
     baseline), or "marginal" (greedy water-filling on simulated marginal
     throughput gain). Predictions are memoized here because the service
     reallocates on every active-set change over mostly-identical requests.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Sequence

from repro_torch.core.scheduler import TransferRequest, allocate
from repro_torch.core.simulator import ALCF, DEFAULT_LINK, NERSC, LinkConfig, SiteConfig


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Per-tenant rate limits. None = unlimited (global caps still apply)."""

    max_active: int | None = None    # concurrent ACTIVE tasks
    max_movers: int | None = None    # movers summed over the tenant's tasks


DEFAULT_QUOTA = TenantQuota()


# ---------------------------------------------------------------------------
# Activation: tenant-fair selection of pending tasks
# ---------------------------------------------------------------------------
def select_activations(
    pending: Sequence[tuple[int, str, str]],    # (submit_seq, task_id, tenant)
    active_by_tenant: dict[str, int],
    *,
    free_slots: int,
    quotas: dict[str, TenantQuota] | None = None,
    default_quota: TenantQuota = DEFAULT_QUOTA,
    served_by_tenant: dict[str, int] | None = None,
) -> list[str]:
    """Pick up to ``free_slots`` pending task_ids, fairly across tenants.

    Stride-style fairness: each tenant's priority is (currently ACTIVE +
    historically served) task count, so a tenant submitting one task is not
    starved behind another tenant's backlog even when only one slot frees at
    a time. FIFO within a tenant; ``max_active`` quotas are respected; the
    quota check uses ACTIVE counts only.
    """
    quotas = quotas or {}
    served = dict(served_by_tenant or {})     # local copy: stay side-effect free
    by_tenant: dict[str, list[tuple[int, str]]] = {}
    for seq, task_id, tenant in sorted(pending):
        by_tenant.setdefault(tenant, []).append((seq, task_id))
    active = dict(active_by_tenant)
    chosen: list[str] = []
    while len(chosen) < free_slots:
        best_tenant, best_key = None, None
        for tenant, queue in by_tenant.items():
            if not queue:
                continue
            quota = quotas.get(tenant, default_quota)
            if quota.max_active is not None and active.get(tenant, 0) >= quota.max_active:
                continue
            key = (active.get(tenant, 0) + served.get(tenant, 0), queue[0][0])
            if best_key is None or key < best_key:
                best_tenant, best_key = tenant, key
        if best_tenant is None:
            break
        _seq, task_id = by_tenant[best_tenant].pop(0)
        chosen.append(task_id)
        active[best_tenant] = active.get(best_tenant, 0) + 1
        served[best_tenant] = served.get(best_tenant, 0) + 1
    return chosen


# ---------------------------------------------------------------------------
# Indexed activation: the same policy at O(log n) per decision
# ---------------------------------------------------------------------------
class ActivationIndex:
    """Incremental heap index implementing select_activations' policy.

    ``select_activations`` rescans every pending task per scheduler pass —
    fine at 10^3 tasks, fatal at 10^6. This index keeps a heap of
    ``(submit_seq, task_id)`` per tenant plus a tenant-level heap keyed by
    the same stride-fairness priority ``(active + served, head_seq)``, so
    each activation decision is O(log tenants) regardless of how many tasks
    are queued. Head seqs are globally unique (submission order), so the
    greedy argmin here selects exactly what the scan-based function would —
    tests assert the equivalence on randomized scenarios.

    Staleness is handled by lazy deletion: every mutation bumps the
    tenant's version and pushes a fresh heap entry; entries with old
    versions are discarded when popped. Tasks that left PENDING without
    being selected (canceled, paused) are dropped via the ``validate``
    callback at pop time — callers re-``add`` a task when it becomes
    PENDING again (resume). Not thread-safe: callers hold their own lock
    (the service's scheduler lock / the testbed is single-threaded).
    """

    def __init__(self, served: dict[str, int] | None = None):
        self._queues: dict[str, list[tuple[int, str]]] = {}
        self._tenant_heap: list[tuple[int, int, str, int]] = []
        self._version: dict[str, int] = {}
        self._active: dict[str, int] = {}
        # shared with the caller so historical fairness survives the index
        # (the service exposes it as served_by_tenant)
        self._served = served if served is not None else {}

    def _load(self, tenant: str) -> int:
        return self._active.get(tenant, 0) + self._served.get(tenant, 0)

    def _push_tenant(self, tenant: str) -> None:
        """Invalidate the tenant's live heap entry; push a fresh one if it
        still has queued tasks."""
        v = self._version.get(tenant, 0) + 1
        self._version[tenant] = v
        queue = self._queues.get(tenant)
        if queue:
            heapq.heappush(
                self._tenant_heap,
                (self._load(tenant), queue[0][0], tenant, v),
            )

    def add(self, seq: int, task_id: str, tenant: str) -> None:
        """Register a PENDING task (call again after a resume re-pends it)."""
        heapq.heappush(self._queues.setdefault(tenant, []), (seq, task_id))
        self._push_tenant(tenant)

    def active_delta(self, tenant: str, delta: int) -> None:
        """Adjust a tenant's ACTIVE count (selection already counts +1; call
        with -1 when a task leaves ACTIVE)."""
        self._active[tenant] = self._active.get(tenant, 0) + delta
        self._push_tenant(tenant)

    def active_count(self, tenant: str) -> int:
        return self._active.get(tenant, 0)

    def pending_count(self) -> int:
        """Upper bound on queued tasks (stale entries linger until popped)."""
        return sum(len(q) for q in self._queues.values())

    def select(
        self,
        free_slots: int,
        *,
        quotas: dict[str, TenantQuota] | None = None,
        default_quota: TenantQuota = DEFAULT_QUOTA,
        validate: Callable[[str], bool] | None = None,
    ) -> list[str]:
        """Pick up to ``free_slots`` task_ids; same contract as
        select_activations. Selected tasks are counted ACTIVE and served
        immediately (mirroring what the caller is about to do)."""
        quotas = quotas or {}
        chosen: list[str] = []
        seen: set[str] = set()      # a task must not be chosen twice even if
        blocked: list[str] = []     # pause/resume left duplicate entries
        while len(chosen) < free_slots and self._tenant_heap:
            load, head_seq, tenant, ver = heapq.heappop(self._tenant_heap)
            if ver != self._version.get(tenant):
                continue                      # stale: a fresher entry exists
            queue = self._queues.get(tenant)
            while queue:
                _seq, tid = queue[0]
                if tid in seen or (validate is not None and not validate(tid)):
                    heapq.heappop(queue)      # lazy deletion at pop time
                    continue
                break
            if not queue:
                self._version[tenant] = ver + 1   # nothing left: no re-push
                continue
            if (self._load(tenant), queue[0][0]) != (load, head_seq):
                self._push_tenant(tenant)     # key drifted: re-enter fresh
                continue
            quota = quotas.get(tenant, default_quota)
            if (quota.max_active is not None
                    and self._active.get(tenant, 0) >= quota.max_active):
                blocked.append(tenant)        # re-pushed after the loop so a
                continue                      # full-quota tenant can't spin us
            _seq, tid = heapq.heappop(queue)
            seen.add(tid)
            chosen.append(tid)
            self._active[tenant] = self._active.get(tenant, 0) + 1
            self._served[tenant] = self._served.get(tenant, 0) + 1
            self._push_tenant(tenant)
        for tenant in blocked:
            self._push_tenant(tenant)
        return chosen


# ---------------------------------------------------------------------------
# Allocation: movers across active tasks, with memoized predictions
# ---------------------------------------------------------------------------
class AllocationEngine:
    """Memoizing wrapper around core.scheduler.allocate for one service."""

    def __init__(
        self,
        *,
        policy: str = "marginal",
        mover_budget: int = 64,
        src: SiteConfig = ALCF,
        dst: SiteConfig = NERSC,
        link: LinkConfig = DEFAULT_LINK,
        step: int = 4,
        quotas: dict[str, TenantQuota] | None = None,
        default_quota: TenantQuota = DEFAULT_QUOTA,
    ):
        self.policy = policy
        self.mover_budget = mover_budget
        self.src, self.dst, self.link = src, dst, link
        self.step = step
        self.quotas = quotas or {}
        self.default_quota = default_quota
        self._cache: dict[tuple, float] = {}

    # requests are rebuilt each round from stable task signatures, so the
    # cache key is the request content, not object identity.
    def _predict(self, req: TransferRequest, movers: int) -> float:
        key = (req.src, req.dst, req.file_bytes, req.chunk_bytes,
               req.integrity, req.stripe_count, movers)
        t = self._cache.get(key)
        if t is None:
            from repro_torch.core.scheduler import _predict
            t = _predict(req, movers, self.link)
            self._cache[key] = t
        return t

    def predict_seconds(self, req: TransferRequest, movers: int) -> float:
        return self._predict(req, movers)

    def allocate(
        self, tasks: Sequence[tuple[str, str, TransferRequest]]
    ) -> dict[str, int]:
        """(task_id, tenant, request) -> task_id -> movers.

        Applies the configured policy under the global budget, then clamps
        each tenant to its ``max_movers`` quota (freed movers are handed to
        unclamped tenants in allocation order).
        """
        if not tasks:
            return {}
        reqs = [req for _tid, _ten, req in tasks]
        allocs = allocate(
            reqs,
            total_movers=self.mover_budget,
            policy=self.policy,
            link=self.link,
            step=self.step,
            predict=self._predict,
        )
        movers = {tid: a.movers for (tid, _ten, _req), a in zip(tasks, allocs)}

        # per-tenant mover caps: proportional clamp with a floor of 1
        by_tenant: dict[str, list[str]] = {}
        tenant_of: dict[str, str] = {}
        for tid, tenant, _req in tasks:
            by_tenant.setdefault(tenant, []).append(tid)
            tenant_of[tid] = tenant
        freed = 0
        uncapped: list[str] = []
        for tenant, tids in by_tenant.items():
            quota = self.quotas.get(tenant, self.default_quota)
            total = sum(movers[t] for t in tids)
            if quota.max_movers is None or total <= quota.max_movers:
                uncapped.extend(tids)
                continue
            scale = quota.max_movers / total
            for t in tids:
                new = max(1, int(movers[t] * scale))
                freed += movers[t] - new
                movers[t] = new
        # hand freed movers to other tasks, re-checking each RECIPIENT
        # tenant's own cap so redistribution never pushes it over quota
        for t in uncapped:
            if freed <= 0:
                break
            tenant = tenant_of[t]
            cap = self.quotas.get(tenant, self.default_quota).max_movers
            if cap is not None:
                total = sum(movers[x] for x in by_tenant[tenant])
                if total >= cap:
                    continue
            movers[t] += 1
            freed -= 1
        return movers
