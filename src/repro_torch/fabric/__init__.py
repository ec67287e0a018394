"""Multi-endpoint WAN fabric: routed relays + fan-out replication campaigns.

The paper's production context moves data "to, from, and among" many
facilities; this package lifts the repo's single-pipe transfer stack onto a
fabric of endpoints:

  * ``topology``  — endpoint registry (mover caps, storage/checksum rates,
    outage calendars), link graph (bandwidth/RTT/loss), congestion-aware
    k-shortest-path route planning;
  * ``relay``     — multi-hop store-and-forward transfers with per-hop chunk
    custody journals (a chunk that reached an intermediate DTN is never
    re-pulled from the origin after a crash);
  * ``campaign``  — 1 -> N replication campaigns: cheapest-attachment
    distribution trees that pay shared trunk links once, decomposed into
    ordinary ``repro_torch.service`` tasks (tenants/quotas/events/pause-resume
    apply), with merge-law digest verification at every replica;
  * ``virtual``   — virtual-time fluid execution of the same trees on the
    calibrated simulator, with the fault-scenario DSL
    (``link_outage_at_50pct+degrade_hop``) applied to links and relay DTNs.
"""
from repro_torch.fabric.campaign import (
    CampaignError,
    CampaignReport,
    CampaignRunner,
    DistributionTree,
    build_distribution_tree,
    naive_wire_hops,
)
from repro_torch.fabric.relay import (
    HopReport,
    RelayReport,
    RelayTransfer,
    realize_hop_campaigns,
    run_relay,
)
from repro_torch.fabric.topology import (
    BUILTIN_TOPOLOGIES,
    Endpoint,
    Link,
    NoRouteError,
    Route,
    RoutePlanner,
    Topology,
    fat_tree_topology,
    shared_trunk_topology,
    star_topology,
)
from repro_torch.fabric.virtual import (
    CampaignSubmission,
    EdgeRatePredictor,
    FabricFaultLog,
    FabricLoadReport,
    FlowResult,
    run_fabric_load,
    simulate_campaign,
    simulate_naive,
)

__all__ = [
    "BUILTIN_TOPOLOGIES",
    "CampaignError", "CampaignReport", "CampaignRunner", "CampaignSubmission",
    "DistributionTree", "EdgeRatePredictor", "Endpoint", "FabricFaultLog",
    "FabricLoadReport", "FlowResult", "HopReport", "Link", "NoRouteError",
    "RelayReport", "RelayTransfer", "Route", "RoutePlanner", "Topology",
    "build_distribution_tree", "fat_tree_topology", "naive_wire_hops",
    "realize_hop_campaigns", "run_fabric_load", "run_relay",
    "shared_trunk_topology", "simulate_campaign", "simulate_naive",
    "star_topology",
]
