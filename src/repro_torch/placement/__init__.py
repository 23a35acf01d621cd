"""repro_torch.placement — the WAN model the staged engine bills shuffles with.

* :mod:`repro_torch.placement.wan` — WAN topology, transfer energy/latency,
  the fused plan bill and the degraded-link surcharge.

The two-timescale placement controller and replica selection of the JAX
package's ``repro.placement`` come with a later slice of the port.
"""

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
