"""Closed-loop chunk-size controller — AIMD plus guarded hill-climb.

The decision half of the autotuner: consumes ``ChunkSample`` telemetry
(``repro_torch.tune.probe``) and recommends a new nominal chunk size for the
*untransferred tail* of the transfer. The engine/service owns the actual
re-partitioning (``core.chunker.partition_regions`` at un-journaled chunk
boundaries); the controller only ever says "the tail should use N bytes now".

Control law, evaluated once per epoch (a fixed number of landed chunks):

  * **multiplicative decrease** — when the epoch rate collapses below
    ``(1 - degrade_threshold)`` of the reference rate, the path changed
    under us (link degrade, loss spike, checksum starvation): shrink the
    chunk size by ``md_factor`` immediately and reset the reference to the
    post-change world. Repeated epochs of decline keep shrinking — the
    AIMD response to a step change;
  * **guarded hill-climb (additive-ish increase)** — in steady state,
    periodically probe a ``climb_factor`` step in the current direction.
    A probe must improve the rate by at least ``hysteresis`` to be kept;
    a probe that degrades by ``hysteresis`` is reverted and the direction
    flips. Probes landing inside the deadband are reverted too, and after
    ``flat_probe_limit`` consecutive flat probes the controller goes quiet
    for ``long_hold_epochs`` — this is the hysteresis that keeps a
    noisy-but-stationary path from oscillating;
  * **bounds** — recommendations are clamped to ``[min_chunk, max_chunk]``
    (the ``plan_auto`` candidate ladder endpoints, or caller-supplied) and
    rounded to ``alignment`` so re-partitioned boundaries stay composable
    with device tiles and per-chunk digests.

The controller is deterministic: no wall clock, no RNG — the same sample
stream always yields the same decision list (``tests/test_determinism.py``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.tune.probe import ChunkSample, TransferProbe


def _round_up(x: int, align: int) -> int:
    return ((x + align - 1) // align) * align


# decision actions
SEED = "seed"          # first epoch: reference established, no move
MD = "md"              # multiplicative decrease on rate collapse
CLIMB = "climb"        # hill-climb probe (direction in the payload)
KEEP = "keep"          # probe improved the rate: kept, climbing on
REVERT = "revert"      # probe degraded the rate: rolled back, flipped
FLAT = "flat"          # probe landed in the deadband: rolled back
HOLD = "hold"          # nothing to do this epoch
STRIPE = "stripe"      # stripe-ladder move (direction +1 escalate, -1 back off)


@dataclasses.dataclass(frozen=True)
class TuneDecision:
    """One epoch's verdict (appended to ``ChunkController.decisions``)."""

    epoch: int
    action: str
    chunk_bytes: int         # target after this decision
    rate_Bps: float          # epoch rate that drove it
    ref_Bps: float           # reference rate it was judged against
    direction: int = 0


class ChunkController:
    """Feedback controller recommending tail chunk sizes mid-flight."""

    def __init__(
        self,
        *,
        chunk_bytes: int,
        min_chunk: int = 64 * 1024,
        max_chunk: int = 1 << 30,
        alignment: int = 1,
        epoch_chunks: int = 4,
        md_factor: float = 0.4,
        climb_factor: float = 1.5,
        degrade_threshold: float = 0.35,
        hysteresis: float = 0.10,
        hold_patience: int = 2,
        flat_probe_limit: int = 2,
        long_hold_epochs: int = 8,
        max_replans: int = 64,
        fast_md_streak: int = 2,
        stripe_ladder: tuple[int, ...] = (1,),
    ):
        if not (0 < md_factor < 1):
            raise ValueError("md_factor must be in (0, 1)")
        if climb_factor <= 1:
            raise ValueError("climb_factor must be > 1")
        if not (0 < degrade_threshold < 1):
            raise ValueError("degrade_threshold must be in (0, 1)")
        if not (0 <= hysteresis < degrade_threshold):
            raise ValueError("hysteresis must be in [0, degrade_threshold)")
        if min_chunk < alignment:
            min_chunk = alignment
        if max_chunk < min_chunk:
            raise ValueError(f"max_chunk {max_chunk} < min_chunk {min_chunk}")
        self.min_chunk = min_chunk
        self.max_chunk = max_chunk
        self.alignment = alignment
        self.epoch_chunks = epoch_chunks
        self.md_factor = md_factor
        self.climb_factor = climb_factor
        self.degrade_threshold = degrade_threshold
        self.hysteresis = hysteresis
        self.hold_patience = hold_patience
        self.flat_probe_limit = flat_probe_limit
        self.long_hold_epochs = long_hold_epochs
        self.max_replans = max_replans
        if fast_md_streak < 1:
            raise ValueError("fast_md_streak must be >= 1")
        self.fast_md_streak = fast_md_streak
        ladder = tuple(int(s) for s in stripe_ladder)
        if not ladder or any(s < 1 for s in ladder) or list(ladder) != sorted(set(ladder)):
            raise ValueError(
                f"stripe_ladder must be strictly ascending ints >= 1, got {ladder!r}")
        self.stripe_ladder = ladder
        self._stripe_rung = 0

        self.probe = TransferProbe()
        self._target = self._clamp(chunk_bytes)
        self._epoch_samples: list[ChunkSample] = []
        self._epoch = 0
        self._ref_rate: float | None = None      # rate credited to _target
        self._dir = 1                            # hill-climb direction
        self._probing_from: tuple[int, float] | None = None
        self._hold_epochs = 0
        self._flat_probes = 0
        self._collapse_streak = 0
        self.replans = 0
        self.decisions: list[TuneDecision] = []

    # ------------------------------------------------------------------
    def _clamp(self, size: int) -> int:
        size = max(self.min_chunk, min(self.max_chunk, int(size)))
        return max(self.alignment, _round_up(size, self.alignment))

    def target(self) -> int:
        """The currently recommended nominal chunk size."""
        return self._target

    def target_stripes(self) -> int:
        """The currently recommended intra-chunk stripe count.

        The ladder is a second, coarser actuator on top of chunk size: the
        controller only climbs it when a GROW probe is already pinned at
        ``max_chunk`` — i.e. per-chunk overhead amortization is exhausted and
        the remaining lever is intra-chunk wire parallelism — and steps back
        down one rung per multiplicative-decrease event (the collapse may BE
        the stripe overhead; shedding one rung per MD keeps the response
        proportional and deterministic).
        """
        return self.stripe_ladder[self._stripe_rung]

    def _escalate_stripes(self, rate: float) -> bool:
        if self._stripe_rung + 1 >= len(self.stripe_ladder):
            return False
        self._stripe_rung += 1
        self._decide(STRIPE, rate, +1)
        return True

    def _deescalate_stripes(self, rate: float) -> None:
        if self._stripe_rung > 0:
            self._stripe_rung -= 1
            self._decide(STRIPE, rate, -1)

    def _decide(self, action: str, rate: float, direction: int = 0) -> None:
        self.decisions.append(TuneDecision(
            self._epoch, action, self._target, rate,
            self._ref_rate if self._ref_rate is not None else 0.0, direction,
        ))

    # ------------------------------------------------------------------
    def observe_outcome(self, out) -> int | None:
        """Adapter for the engine's ChunkOutcome (duck-typed, so
        ``core.transfer`` never has to import this package)."""
        c = out.chunk
        return self.observe(ChunkSample(
            offset=c.offset, length=c.length, seconds=out.seconds,
            attempt_seconds=out.attempt_seconds,
            cksum_seconds=out.cksum_seconds,
            cksum_lag_s=getattr(out, "cksum_lag_s", 0.0),
            attempts=out.attempts,
            refetches=out.refetches, mover=out.mover,
        ))

    def observe(self, sample: ChunkSample) -> int | None:
        """Feed one chunk's telemetry; returns a new target size when the
        tail should be re-planned, else None."""
        self.probe.add(sample)
        self._epoch_samples.append(sample)
        # fast path: ``fast_md_streak`` consecutive chunks whose rates
        # collapsed below the degrade threshold close the epoch immediately —
        # waiting out a full epoch at the degraded rate is exactly the cost
        # the loop exists to avoid (a streak, so isolated noisy samples
        # cannot fake a step change)
        r = sample.rate_Bps
        if (self._ref_rate is not None and r > 0
                and r < self._ref_rate * (1.0 - self.degrade_threshold)):
            self._collapse_streak += 1
        else:
            self._collapse_streak = 0
        if (len(self._epoch_samples) < self.epoch_chunks
                and self._collapse_streak < self.fast_md_streak):
            return None
        self._collapse_streak = 0
        rate = TransferProbe.epoch_rate(self._epoch_samples)
        work_s = sum(s.attempt_seconds for s in self._epoch_samples)
        ck_s = sum(s.cksum_seconds for s in self._epoch_samples)
        # pipelined data plane: verification runs OFF the mover path, so its
        # cost shows up as per-chunk lag, not mover checksum time. Lag is
        # sampled separately from mover time (it must not read as
        # congestion), but it IS checksum pressure: fold it into the
        # checksum-dominance fraction so starved verifiers still steer the
        # MD direction toward larger (amortizing) chunks.
        lag_s = sum(s.cksum_lag_s for s in self._epoch_samples)
        denom = work_s + lag_s
        ck_frac = (ck_s + lag_s) / denom if denom > 0 else 0.0
        self._epoch_samples = []
        self._epoch += 1
        return self._update(rate, ck_frac)

    def _update(self, rate: float, ck_frac: float = 0.0) -> int | None:
        if rate <= 0:
            return None
        if self._ref_rate is None:
            self._ref_rate = rate
            self._decide(SEED, rate)
            return None

        # ---- multiplicative step: the path changed under us. Direction
        # comes from WHAT got expensive: when per-chunk checksum overhead
        # dominates the epoch (starved checksum workers), larger chunks
        # amortise it — grow; otherwise the per-byte path degraded
        # (congestion, loss) and smaller chunks bound the retry unit — shrink.
        if rate < self._ref_rate * (1.0 - self.degrade_threshold):
            self._ref_rate = rate               # judge the post-change world
            self._probing_from = None
            self._hold_epochs = 0
            self._flat_probes = 0
            grow = ck_frac > 0.5
            self._dir = 1 if grow else -1       # keep refining that way
            if not grow:
                # per-byte path degraded: stripe fan-out may be the cause —
                # shed one rung alongside the chunk-size decrease
                self._deescalate_stripes(rate)
            factor = (1.0 / self.md_factor) if grow else self.md_factor
            return self._move(self._clamp(int(self._target * factor)),
                              MD, rate, self._dir)

        # ---- a probe step is pending judgment
        if self._probing_from is not None:
            from_size, from_rate = self._probing_from
            self._probing_from = None
            if rate >= from_rate * (1.0 + self.hysteresis):
                # improvement: keep the new size and climb on
                self._ref_rate = rate
                self._flat_probes = 0
                self._decide(KEEP, rate, self._dir)
                return self._start_probe(rate)
            if rate <= from_rate * (1.0 - self.hysteresis):
                # degradation: revert and flip direction
                self._dir = -self._dir
                self._flat_probes = 0
                self._hold_epochs = 0
                self._ref_rate = from_rate
                return self._move(from_size, REVERT, rate, self._dir)
            # deadband: not proven better — go back, count the flat probe
            self._flat_probes += 1
            self._hold_epochs = (
                -self.long_hold_epochs
                if self._flat_probes >= self.flat_probe_limit else 0
            )
            if self._flat_probes >= self.flat_probe_limit:
                self._flat_probes = 0
            self._ref_rate = from_rate
            return self._move(from_size, FLAT, rate, self._dir)

        # ---- steady state: slow reference tracking, occasional probes
        self._ref_rate = 0.5 * self._ref_rate + 0.5 * rate
        self._hold_epochs += 1
        if self._hold_epochs >= self.hold_patience:
            self._hold_epochs = 0
            return self._start_probe(rate)
        self._decide(HOLD, rate)
        return None

    def _start_probe(self, rate: float) -> int | None:
        step = (self._target * self.climb_factor if self._dir > 0
                else self._target / self.climb_factor)
        new = self._clamp(int(step))
        if new == self._target:
            if self._dir > 0 and self._escalate_stripes(rate):
                # grow probe pinned at max_chunk: chunk-size amortization is
                # exhausted — climb the stripe ladder instead of turning
                # around (one rung per probe window, so rate feedback lands
                # between rungs)
                return None
            self._dir = -self._dir              # pinned at a bound: turn around
            step = (self._target * self.climb_factor if self._dir > 0
                    else self._target / self.climb_factor)
            new = self._clamp(int(step))
        if new == self._target:
            self._decide(HOLD, rate)
            return None
        self._probing_from = (self._target, self._ref_rate or rate)
        return self._move(new, CLIMB, rate, self._dir)

    def _move(self, new: int, action: str, rate: float, direction: int) -> int | None:
        if new == self._target or self.replans >= self.max_replans:
            self._decide(HOLD, rate)
            return None
        self._target = new
        self.replans += 1
        self._decide(action, rate, direction)
        return new
