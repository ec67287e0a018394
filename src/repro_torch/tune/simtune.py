"""Simulator-seeded warm start for the chunk controller.

``plan_auto`` already consults the calibrated WAN model to pick a *static*
chunk size. ``SimTuner`` closes the gap between that one-shot choice and the
online controller: it sweeps the same candidate ladder through
``core.simulator.predict_transfer_time`` (or a fabric link's site
projections — the ``fabric.virtual`` rate model) and hands the controller

  * an initial target — the predicted-optimal size, so the first chunks of
    a tuned transfer already fly at the model's sweet spot instead of
    hill-climbing from an arbitrary default (warm cold-start), and
  * [min, max] bounds — the smallest and largest candidates whose predicted
    completion time is within ``bound_tolerance`` of the best, so the online
    loop explores only the plateau the model considers sane.

Observed telemetry then corrects the model: if the real path disagrees with
the prediction (the whole reason the paper wants run-time adaptation), the
AIMD/hill-climb loop walks away from the seed, within the seeded bounds.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.core.chunker import MiB
from repro_torch.core.simulator import (
    DEFAULT_LINK,
    LinkConfig,
    SiteConfig,
    predict_transfer_time,
)
from repro_torch.tune.controller import ChunkController

# the plan_auto candidate ladder (core.chunker.plan_auto defaults), reused so
# the online tuner and the static planner agree on what sizes are plausible
AUTO_CANDIDATES: tuple[int, ...] = (
    16 * MiB, 50 * MiB, 100 * MiB, 200 * MiB, 500 * MiB, 1000 * MiB,
    2000 * MiB, 5000 * MiB,
)


class SimTuner:
    """Pre-seed a ChunkController from calibrated-simulator predictions."""

    def __init__(
        self,
        src: SiteConfig,
        dst: SiteConfig,
        link: LinkConfig = DEFAULT_LINK,
        *,
        candidates: Sequence[int] = AUTO_CANDIDATES,
        integrity: bool = True,
    ):
        if not candidates:
            raise ValueError("need at least one candidate chunk size")
        self.src, self.dst, self.link = src, dst, link
        self.candidates = tuple(sorted(int(c) for c in candidates))
        self.integrity = integrity
        self._cache: dict[tuple[int, int], float] = {}

    @staticmethod
    def for_link(u, v, link) -> "SimTuner":
        """Fabric flavour: seed from two ``fabric.topology.Endpoint``s and
        the loss-degraded (Mathis-bound) bandwidth of the ``Link`` between
        them — the same projection ``fabric.virtual`` rates hops with."""
        return SimTuner(
            u.to_site(), v.to_site(),
            LinkConfig(wan_gbps=link.effective_gbps,
                       chunk_latency_s=max(1e-4, link.rtt_ms / 1e3)),
        )

    # ------------------------------------------------------------------
    def predict_seconds(self, total_bytes: int, chunk_bytes: int | None) -> float:
        key = (int(total_bytes), int(chunk_bytes) if chunk_bytes else 0)
        if key not in self._cache:
            self._cache[key] = predict_transfer_time(
                self.src, self.dst, int(total_bytes),
                chunk_bytes=chunk_bytes, integrity=self.integrity,
                link=self.link,
            )
        return self._cache[key]

    def sweep(self, total_bytes: int) -> dict[int, float]:
        """Predicted seconds per viable candidate size (the seed's evidence)."""
        out = {}
        for c in self.candidates:
            if c <= total_bytes:
                out[c] = self.predict_seconds(total_bytes, c)
        if not out:          # transfer smaller than every candidate: unchunked
            out[int(total_bytes)] = self.predict_seconds(total_bytes, None)
        return out

    def seed_chunk(self, total_bytes: int) -> int:
        """The predicted-optimal chunk size (ties go to the larger size —
        fewer chunks means less control-plane state for equal time)."""
        sweep = self.sweep(total_bytes)
        best = min(sweep.items(), key=lambda kv: (kv[1], -kv[0]))
        return best[0]

    def bounds(self, total_bytes: int, *, tolerance: float = 2.0) -> tuple[int, int]:
        """[min, max] candidates predicted within ``tolerance`` x best time."""
        sweep = self.sweep(total_bytes)
        best_t = min(sweep.values())
        ok = [c for c, t in sweep.items() if t <= tolerance * best_t]
        return min(ok), max(ok)

    def make_controller(self, total_bytes: int, **ctrl_kw) -> ChunkController:
        """A ChunkController warm-started at the model's optimum with
        model-sane bounds; ``ctrl_kw`` overrides any controller knob."""
        lo, hi = self.bounds(total_bytes)
        kw = dict(chunk_bytes=self.seed_chunk(total_bytes),
                  min_chunk=lo, max_chunk=hi)
        kw.update(ctrl_kw)
        return ChunkController(**kw)
