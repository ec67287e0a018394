"""Load-aware allocation of mover concurrency across concurrent transfers.

Kettimuthu et al. [2015] (cited in paper §2.3) showed that "a sufficient, but
not excessive, allocation of concurrency to the right transfers" improves
aggregate resource performance. With client-driven chunking in the picture the
allocator has a new degree of freedom: a single-large-file transfer can now
*use* more than one mover, so concurrency is allocated by marginal benefit
rather than by file count.

Policies:
  * "fair"        — equal movers per transfer (classic Globus behaviour).
  * "file_bound"  — movers = min(files, share): the pre-chunking allocator;
                    single-file transfers get 1 mover (the paper's baseline).
  * "marginal"    — greedy water-filling by simulated marginal throughput
                    gain, chunk-aware (the paper-enabled allocator).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

from repro_torch.core.simulator import (
    DEFAULT_LINK,
    LinkConfig,
    SiteConfig,
    TransferSpec,
    simulate_transfer,
)


@dataclasses.dataclass(frozen=True)
class TransferRequest:
    name: str
    src: SiteConfig
    dst: SiteConfig
    file_bytes: tuple[int, ...]
    chunk_bytes: int | None = 200 * 1024 * 1024
    integrity: bool = True
    stripe_count: int = 16


@dataclasses.dataclass(frozen=True)
class Allocation:
    request: TransferRequest
    movers: int
    predicted_seconds: float
    predicted_gbps: float


def _predict(req: TransferRequest, movers: int, link: LinkConfig) -> float:
    if movers <= 0:
        return float("inf")
    spec = TransferSpec(
        file_bytes=req.file_bytes,
        chunk_bytes=req.chunk_bytes,
        integrity=req.integrity,
        stripe_count=req.stripe_count,
        concurrency=movers,
    )
    return simulate_transfer(req.src, req.dst, spec, link).seconds


def allocate(
    requests: Sequence[TransferRequest],
    total_movers: int = 64,
    policy: str = "marginal",
    link: LinkConfig = DEFAULT_LINK,
    step: int = 4,
    predict: Callable[[TransferRequest, int], float] | None = None,
) -> list[Allocation]:
    """Split a mover budget across transfers; returns per-transfer allocations.

    ``predict(request, movers) -> seconds`` overrides the built-in simulator
    cost model; the service layer passes a memoizing wrapper so repeated
    reallocation over a stable active set stays cheap.
    """
    if not requests:
        return []
    if predict is None:
        predict = lambda r, m: _predict(r, m, link)  # noqa: E731
    n = len(requests)
    if total_movers < n:
        raise ValueError(f"need >= 1 mover per transfer ({n} transfers, {total_movers} movers)")

    if policy == "fair":
        alloc = [total_movers // n] * n
        for i in range(total_movers - sum(alloc)):
            alloc[i] += 1
    elif policy == "file_bound":
        # Pre-chunking behaviour: a transfer can't use more movers than files.
        alloc = [0] * n
        budget = total_movers
        for i, r in enumerate(requests):
            alloc[i] = 1
            budget -= 1
        for i, r in enumerate(requests):
            extra = min(len(r.file_bytes) - 1, budget)
            alloc[i] += extra
            budget -= extra
    elif policy == "marginal":
        # Greedy water-filling on simulated completion-time reduction per mover.
        alloc = [1] * n
        budget = total_movers - n
        cur = [predict(r, 1) for r in requests]
        while budget >= step:
            best_i, best_gain, best_t = -1, 0.0, 0.0
            for i, r in enumerate(requests):
                t = predict(r, alloc[i] + step)
                gain = cur[i] - t
                if gain > best_gain:
                    best_i, best_gain, best_t = i, gain, t
            if best_i < 0:
                break
            alloc[best_i] += step
            cur[best_i] = best_t
            budget -= step
    else:
        raise ValueError(f"unknown policy {policy!r}")

    out = []
    for r, m in zip(requests, alloc):
        secs = predict(r, m)
        total = sum(r.file_bytes)
        out.append(Allocation(r, m, secs, total * 8 / 1e9 / secs if secs > 0 else 0.0))
    return out
