"""Closed-loop chunk autotuning — chunking as a control loop, not a plan.

The port's copy of ``repro.tune``.

The paper's automated client-driven chunking picks parameters from what it
knows *before* the transfer starts. This package closes the loop with what
the transfer learns while it runs:

  * ``probe``      — ``ChunkSample`` / ``TransferProbe``: per-chunk goodput,
    checksum latency and retry amplification sampled from mover telemetry,
    with fault time excluded from the congestion signal;
  * ``controller`` — ``ChunkController``: AIMD (multiplicative decrease on
    rate collapse) plus a guarded, hysteresis-damped hill climb, bounded by
    the ``plan_auto`` candidate ladder; recommends new tail chunk sizes;
  * ``simtune``    — ``SimTuner``: warm-starts the controller (initial
    target + bounds) from the calibrated simulator / fabric link models so
    cold start begins at the predicted optimum;
  * ``harness``    — reproducible step-change path dynamics (link degrade,
    checksum starvation, loss spikes) for benchmarks and conformance tests.

The actuators live with the engines that own the chunks: ``core.transfer``
re-partitions the un-started tail at un-journaled boundaries,
``repro_torch.service`` re-plans per task (TUNE events, tuned TaskStatus fields),
and ``fabric.relay`` adapts per-hop transfer granules under custody chunks.
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
from repro_torch.tune.harness import (
    STEP_SCENARIOS,
    Phase,
    StepPath,
    StepScenario,
    SteppedDest,
    SteppedSource,
    cksum_starvation_scenario,
    link_degrade_scenario,
    loss_spike_scenario,
    precise_sleep,
)
from repro_torch.tune.probe import ChunkSample, TransferProbe
from repro_torch.tune.simtune import AUTO_CANDIDATES, SimTuner

__all__ = [
    "AUTO_CANDIDATES", "CLIMB", "ChunkController", "ChunkSample", "FLAT",
    "HOLD", "KEEP", "MD", "Phase", "REVERT", "SEED", "STEP_SCENARIOS",
    "SimTuner", "StepPath", "StepScenario", "SteppedDest", "SteppedSource",
    "TransferProbe", "TuneDecision", "cksum_starvation_scenario",
    "link_degrade_scenario", "loss_spike_scenario", "precise_sleep",
]
