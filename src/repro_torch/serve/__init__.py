"""repro_torch.serve — the serving runtime: the local prefill/decode pair
and the simulation-stack-dispatched fleet engine (staged prefill → decode
dispatch, replica-read routing, admission control, pod-death recovery),
and the sharded ``make_prefill_step`` / ``make_decode_step`` at world
size 1."""

from repro_torch.serve.step import make_decode_step, make_local_exec, make_prefill_step
from repro_torch.serve.engine import (
    FleetConfig,
    FleetEngine,
    RequestClass,
    ServeScenario,
    build_serve_scenario,
    serve_policy,
)

__all__ = [
    "make_decode_step",
    "make_local_exec",
    "make_prefill_step",
    "FleetEngine",
    "FleetConfig",
    "RequestClass",
    "ServeScenario",
    "build_serve_scenario",
    "serve_policy",
]
