"""repro_torch.placement — two-timescale data placement & replica selection.

The paper's GMSA decides *per slot* which DC manages each job against a
frozen dataset layout; this subsystem adds the slow timescale the paper
names as future work (Sec. VI): every W slots a placement controller may
re-place / replicate the datasets across sites — under a WAN transfer-cost
model and per-site storage caps — while GMSA keeps dispatching against the
current layout.

* :mod:`repro_torch.placement.wan`        — WAN topology, transfer
  energy/latency, the fused plan bill and the degraded-link surcharge.
* :mod:`repro_torch.placement.replica`    — placement & replica-selection
  scoring (vectorized greedy / LP-vertex rules).
* :mod:`repro_torch.placement.controller` — the two-timescale controller
  (``simulate_placed`` / ``simulate_placed_many``), batched over
  Monte-Carlo runs.

The STATIC-PLACEMENT baseline is
:func:`repro_torch.core.baselines.static_placement_rule`; drifting-dataset
traces come from :mod:`repro_torch.traces.drift`; site-failure alive masks
from :mod:`repro_torch.traces.faults`.
"""

from repro_torch.placement.controller import (
    PlacedOutputs,
    PlacementConfig,
    SlowObs,
    simulate_placed,
    simulate_placed_many,
    summarize_placed,
)
from repro_torch.placement.replica import (
    capacity_project,
    effective_replicas,
    expected_read_cost,
    hosting_scores,
    make_adaptive_rule,
    replica_read_assignment,
    replication_premium,
    sync_cost,
    target_placement,
)
from repro_torch.placement.wan import (
    WanModel,
    degraded_surcharge,
    evacuation_cost,
    evacuation_plan,
    expected_pull,
    link_price_matrix,
    plan_cost,
    transfer_cost,
    transfer_latency,
    transfer_plan,
    wan_topology,
)

__all__ = [
    "PlacedOutputs",
    "PlacementConfig",
    "SlowObs",
    "simulate_placed",
    "simulate_placed_many",
    "summarize_placed",
    "capacity_project",
    "effective_replicas",
    "expected_read_cost",
    "hosting_scores",
    "make_adaptive_rule",
    "replica_read_assignment",
    "replication_premium",
    "sync_cost",
    "target_placement",
    "WanModel",
    "degraded_surcharge",
    "evacuation_cost",
    "evacuation_plan",
    "expected_pull",
    "link_price_matrix",
    "plan_cost",
    "transfer_cost",
    "transfer_latency",
    "transfer_plan",
    "wan_topology",
]
