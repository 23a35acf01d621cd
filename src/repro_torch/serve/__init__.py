"""repro_torch.serve — the serving runtime: the local prefill/decode pair
and the simulation-stack-dispatched fleet engine (staged prefill → decode
dispatch, replica-read routing, admission control, pod-death recovery).
The sharded ``make_prefill_step`` / ``make_decode_step`` come with the
distributed slice."""

from repro_torch.serve.step import make_local_exec
from repro_torch.serve.engine import (
    FleetConfig,
    FleetEngine,
    RequestClass,
    ServeScenario,
    build_serve_scenario,
    serve_policy,
)

__all__ = [
    "make_local_exec",
    "FleetEngine",
    "FleetConfig",
    "RequestClass",
    "ServeScenario",
    "build_serve_scenario",
    "serve_policy",
]
