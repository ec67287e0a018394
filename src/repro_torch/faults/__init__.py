"""Fault injection + chaos conformance for the transfer stack.

The paper's operational core is that integrity checking and chunk-granular
restart are *essential* at exascale: Globus logs show silent corruption about
once per 1.26 TB moved (§2.3), and production transfers survive on automated
recovery from mover crashes, endpoint outages, and checksum mismatches. This
package makes those failure modes executable:

  * ``scenarios``  — the composable campaign DSL (``corrupt_1_per_TiB +
    kill_2_movers + outage_at_50pct``) and the conformance ``FULL_MATRIX``;
  * ``injectors``  — deterministic seeded realisations: wrapped
    ByteSource/ByteDest endpoints, mover-pool kills, outage windows, torn
    journal tails, with full injected-fault accounting (``FaultStats``).

Consumed by the real threaded engine (``core.transfer`` / ``service``), the
virtual-time testbed (``service.testbed.run_load(scenario=...)``), the chaos
benchmark (``benchmarks/chaos.py``), and the scenario conformance suite
(``tests/test_faults.py``).
"""
from repro_torch.faults.injectors import (
    FaultCampaign,
    FaultStats,
    FaultyDest,
    FaultySource,
    corrupt_index_backing,
    corrupt_landed_regions,
    tear_journal_tail,
)
from repro_torch.faults.scenarios import (
    CLEAN,
    FABRIC_MATRIX,
    FULL_MATRIX,
    PAPER_BYTES_PER_ERROR,
    SCENARIOS,
    Scenario,
    parse_scenario,
)

__all__ = [
    "CLEAN", "FABRIC_MATRIX", "FULL_MATRIX", "FaultCampaign", "FaultStats",
    "FaultyDest", "FaultySource", "PAPER_BYTES_PER_ERROR", "SCENARIOS",
    "Scenario", "corrupt_index_backing", "corrupt_landed_regions",
    "parse_scenario", "tear_journal_tail",
]
