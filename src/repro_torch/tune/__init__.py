"""Closed-loop chunk autotuning — chunking as a control loop, not a plan.

The port's copy of ``repro.tune``, without the step-change harness:

  * ``probe``      — ``ChunkSample`` / ``TransferProbe``: per-chunk goodput,
    checksum latency and retry amplification sampled from mover telemetry,
    with fault time excluded from the congestion signal;
  * ``controller`` — ``ChunkController``: AIMD (multiplicative decrease on
    rate collapse) plus a guarded, hysteresis-damped hill climb, bounded by
    the ``plan_auto`` candidate ladder; recommends new tail chunk sizes;
  * ``simtune``    — ``SimTuner``: warm-starts the controller (initial
    target + bounds) from the calibrated simulator.

The actuators live with the engines that own the chunks: ``core.transfer``
re-partitions the un-started tail at un-journaled boundaries and
``service`` re-plans per task (TUNE events, tuned TaskStatus fields).
"""
from repro_torch.tune.controller import (
    CLIMB,
    FLAT,
    HOLD,
    KEEP,
    MD,
    REVERT,
    SEED,
    ChunkController,
    TuneDecision,
)
from repro_torch.tune.probe import ChunkSample, TransferProbe
from repro_torch.tune.simtune import AUTO_CANDIDATES, SimTuner

__all__ = [
    "AUTO_CANDIDATES", "CLIMB", "ChunkController", "ChunkSample", "FLAT",
    "HOLD", "KEEP", "MD", "REVERT", "SEED", "SimTuner", "TransferProbe",
    "TuneDecision",
]
