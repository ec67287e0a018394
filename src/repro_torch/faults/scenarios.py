"""Composable fault-campaign scenarios — the chaos DSL.

A ``Scenario`` names a set of faults to inject into one transfer (or one
service workload): silent bit-flip corruption at a bytes-per-error rate (the
paper's Globus logs: ~one corruption per 1.26 TB moved, §2.3), mover deaths
mid-chunk, stalled/straggler movers, endpoint outage windows, and torn
journal tails. Scenarios compose with ``+``::

    parse_scenario("corrupt_1_per_TiB+kill_2_movers+outage_at_50pct")

and the same scenario object drives BOTH backends:

  * the real threaded engine/service via ``repro_torch.faults.injectors.FaultCampaign``
    (wrapped ByteSource/ByteDest endpoints + mover-pool injection), and
  * the virtual-time testbed via ``repro_torch.service.testbed.run_load(scenario=...)``
    (fluid-model equivalents: re-moved bytes, mover-budget kills, rate-zero
    outage windows).

These are the repo's executable conformance campaigns: `benchmarks/chaos.py`
runs the ``FULL_MATRIX`` across seeds and asserts zero integrity escapes and
zero re-moved journaled chunks — the invariants every future PR must keep.
"""
from __future__ import annotations

import dataclasses

TiB = 1024**4
PAPER_BYTES_PER_ERROR = 1.26e12     # one silent corruption per 1.26 TB (§2.3)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One named fault campaign. All fields are deterministic *plans*; the
    random realisation (which byte flips, which op dies) comes from the seed
    given to the injector/testbed, never from global state."""

    name: str = "clean"
    # silent corruption: mean bytes between injected bit flips (None = off).
    bytes_per_error: float | None = None
    # mover deaths: kill this many movers mid-chunk, starting once the
    # transfer has moved ``kill_at_frac`` of its bytes.
    kill_movers: int = 0
    kill_at_frac: float = 0.25
    # endpoint outage: at ``outage_at_frac`` progress the endpoints reject
    # the next ``outage_ops`` operations (real engine) / go rate-zero for
    # ``outage_s`` virtual seconds (testbed).
    outage_at_frac: float | None = None
    outage_ops: int = 24
    outage_s: float = 30.0
    # stragglers: this many one-shot stalls of ``stall_s`` wall-clock seconds.
    stall_movers: int = 0
    stall_s: float = 0.02
    # torn journal: after a crash, truncate the journal mid-way through its
    # final record before restarting (exercised by chaos restart legs).
    torn_journal: bool = False
    # --- fabric faults (multi-hop relays / replication campaigns) ----------
    # link outage: at ``link_outage_at_frac`` campaign progress, one link on
    # the route/tree (seeded victim) goes dark — its endpoints reject the
    # next ``link_outage_ops`` operations (real relay) / carry zero bandwidth
    # for ``link_outage_s`` virtual seconds (fabric.virtual).
    link_outage_at_frac: float | None = None
    link_outage_ops: int = 24
    link_outage_s: float = 30.0
    # degraded intermediate endpoint: a seeded victim DTN on the route slows
    # down — every write stalls (real relay) / endpoint rates are multiplied
    # by ``degrade_factor`` (fabric.virtual).
    degrade_hops: int = 0
    degrade_factor: float = 0.25
    # --- content-plane faults (dedup against chunk indexes) ----------------
    # stale index entries: corrupt the backing bytes behind this many seeded
    # victim entries in the pre-populated chunk index before the dedup pass —
    # the lookup hit re-verifies, demotes the chunk to a wire move, and
    # quarantines the entry (the 0-escape invariant must survive a lying
    # index).
    stale_index: int = 0
    # --- resilience-plane faults (health breakers, failover, scrub) --------
    # hard endpoint death: at ``down_at_frac`` progress the endpoint rejects
    # the next ``down_ops`` operations — a window long enough to exhaust any
    # reasonable per-hop outage patience (failover territory) yet finite, so
    # a single-pipe transfer with no alternate route still waits it out.
    down_at_frac: float | None = None
    down_ops: int = 120
    # link flap: ``link_flaps`` short outage windows of ``flap_ops`` rejected
    # operations each, spread evenly across transfer progress — the
    # intermittent link that trips EWMA breakers without ever being hard down.
    link_flaps: int = 0
    flap_ops: int = 12
    # brownout: ``brownout_events`` seeded single-op rejections keyed to byte
    # positions in [0, total_bytes) — an endpoint that intermittently refuses
    # work rather than dying (each rejected op heals on its retry).
    brownout_events: int = 0
    # landed bit-rot: flip one bit in each of this many landed (verified,
    # journaled) destination regions AFTER the transfer succeeded — the
    # post-landing decay the scrub daemon exists to catch (injected by
    # ``corrupt_landed_regions``; no in-flight effect).
    bitrot_landed: int = 0

    def __post_init__(self):
        if self.bytes_per_error is not None and self.bytes_per_error <= 0:
            raise ValueError("bytes_per_error must be > 0")
        if not (0.0 <= self.kill_at_frac <= 1.0):
            raise ValueError("kill_at_frac must be in [0, 1]")
        if self.outage_at_frac is not None and not (0.0 <= self.outage_at_frac <= 1.0):
            raise ValueError("outage_at_frac must be in [0, 1]")
        if self.link_outage_at_frac is not None and not (0.0 <= self.link_outage_at_frac <= 1.0):
            raise ValueError("link_outage_at_frac must be in [0, 1]")
        if not (0.0 < self.degrade_factor <= 1.0):
            raise ValueError("degrade_factor must be in (0, 1]")
        if self.down_at_frac is not None and not (0.0 <= self.down_at_frac <= 1.0):
            raise ValueError("down_at_frac must be in [0, 1]")
        if self.down_ops <= 0:
            raise ValueError("down_ops must be > 0")
        if self.link_flaps < 0 or self.flap_ops <= 0:
            raise ValueError("link_flaps must be >= 0 and flap_ops > 0")
        if self.brownout_events < 0:
            raise ValueError("brownout_events must be >= 0")
        if self.bitrot_landed < 0:
            raise ValueError("bitrot_landed must be >= 0")

    # -- composition --------------------------------------------------------
    def __add__(self, other: "Scenario") -> "Scenario":
        """Merge two campaigns: for every field, the non-default wins (the
        right side wins when both differ from the default)."""
        merged = {}
        for f in dataclasses.fields(self):
            if f.name == "name":
                continue
            default = f.default
            a, b = getattr(self, f.name), getattr(other, f.name)
            merged[f.name] = b if b != default else a
        name = self.name if other.name == "clean" else (
            other.name if self.name == "clean" else f"{self.name}+{other.name}"
        )
        return Scenario(name=name, **merged)

    def replace(self, **kw) -> "Scenario":
        return dataclasses.replace(self, **kw)

    def scaled_to(self, total_bytes: int, *, target_events: float = 4.0) -> "Scenario":
        """Rescale the corruption rate so ~``target_events`` strikes hit a
        payload of ``total_bytes`` — the paper's per-TB rates would inject
        nothing into a test-sized payload; conformance runs scale the rate,
        not the mechanism."""
        if self.bytes_per_error is None or total_bytes <= 0:
            return self
        return dataclasses.replace(
            self, bytes_per_error=max(1.0, total_bytes / target_events)
        )

    @property
    def is_clean(self) -> bool:
        return (
            self.bytes_per_error is None and self.kill_movers == 0
            and self.outage_at_frac is None and self.stall_movers == 0
            and not self.torn_journal
            and self.link_outage_at_frac is None and self.degrade_hops == 0
            and self.stale_index == 0
            and self.down_at_frac is None and self.link_flaps == 0
            and self.brownout_events == 0 and self.bitrot_landed == 0
        )


# ---------------------------------------------------------------------------
# named registry
# ---------------------------------------------------------------------------
CLEAN = Scenario()
SCENARIOS: dict[str, Scenario] = {
    "clean": CLEAN,
    # corruption at the paper's calibrated Globus-log rate (§2.3) and at a
    # round per-TiB rate; conformance runs call .scaled_to(payload) on these.
    "corrupt_paper_rate": Scenario(name="corrupt_paper_rate",
                                   bytes_per_error=PAPER_BYTES_PER_ERROR),
    "corrupt_1_per_TiB": Scenario(name="corrupt_1_per_TiB", bytes_per_error=float(TiB)),
    "kill_2_movers": Scenario(name="kill_2_movers", kill_movers=2),
    "kill_all_movers": Scenario(name="kill_all_movers", kill_movers=1 << 10),
    "outage_at_50pct": Scenario(name="outage_at_50pct", outage_at_frac=0.5),
    "stall_1_mover": Scenario(name="stall_1_mover", stall_movers=1),
    "torn_journal_tail": Scenario(name="torn_journal_tail", torn_journal=True),
    # fabric faults: one link dies mid-campaign / one intermediate DTN slows
    "link_outage_at_50pct": Scenario(name="link_outage_at_50pct",
                                     link_outage_at_frac=0.5),
    "degrade_hop": Scenario(name="degrade_hop", degrade_hops=1),
    # content-plane fault: the chunk index promises bytes it no longer has
    "stale_index": Scenario(name="stale_index", stale_index=2),
    # resilience-plane faults: a hard endpoint death window, a flapping
    # link, an intermittently-refusing endpoint, and post-landing bit-rot
    "endpoint_down_at_50pct": Scenario(name="endpoint_down_at_50pct",
                                       down_at_frac=0.5),
    "link_flap": Scenario(name="link_flap", link_flaps=3),
    "brownout": Scenario(name="brownout", brownout_events=24),
    "bitrot_landed": Scenario(name="bitrot_landed", bitrot_landed=3),
}


def parse_scenario(expr: str) -> Scenario:
    """``"corrupt_1_per_TiB+kill_2_movers"`` -> the composed Scenario."""
    parts = [p.strip() for p in expr.split("+") if p.strip()]
    if not parts:
        raise ValueError(f"empty scenario expression {expr!r}")
    out = CLEAN
    for p in parts:
        if p not in SCENARIOS:
            raise ValueError(f"unknown scenario {p!r} (known: {sorted(SCENARIOS)})")
        out = out + SCENARIOS[p]
    return out


# The conformance matrix benchmarks/chaos.py sweeps: every fault class alone,
# then the compound campaigns (the paper's failure cocktail).
FULL_MATRIX: tuple[str, ...] = (
    "corrupt_1_per_TiB",
    "kill_2_movers",
    "outage_at_50pct",
    "stall_1_mover",
    "corrupt_1_per_TiB+kill_2_movers",
    "corrupt_1_per_TiB+outage_at_50pct",
    "corrupt_1_per_TiB+kill_2_movers+outage_at_50pct",
    "torn_journal_tail",
    "corrupt_1_per_TiB+torn_journal_tail",
    "stale_index",
    "endpoint_down_at_50pct",
    "link_flap",
    "brownout",
    "bitrot_landed",
)


# The fabric conformance matrix benchmarks/fabric.py sweeps over multi-hop
# relays and fan-out campaigns: link outages and degraded intermediate DTNs,
# alone and composed with the paper's silent-corruption rate.
FABRIC_MATRIX: tuple[str, ...] = (
    "link_outage_at_50pct",
    "degrade_hop",
    "link_outage_at_50pct+degrade_hop",
    "corrupt_1_per_TiB+link_outage_at_50pct+degrade_hop",
)
