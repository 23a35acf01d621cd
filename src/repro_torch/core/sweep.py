"""Parameter-sweep grids: a whole V-grid of Monte-Carlo runs in one slot loop.

A Fig.-6 V-sweep as seven ``simulate_many`` calls runs seven slot loops.
Here the swept control parameter becomes a leading batch axis on top of
the runs axis, so one loop of T slots serves every (V, run) lane:

    sweep_grid(build, gmsa_policy, generator, 1000, V_GRID)   # (V, R, T) out

The lanes are **paired**: the traces are drawn once and every V lane sees
the same per-run traces (``arrivals`` and ``mu`` are expanded over V, not
copied), exactly as calling ``simulate_many`` per point with the same seed.
V reaches the policy as a ``(V, 1)`` scalar (:func:`repro_torch.core.gmsa
.per_lane`). Through the ``gmsa_score`` kernel the V·R lanes fold into the
kernel's runs axis: still one launch per slot.

Policy randomness is shared across lanes as well: a state-independent
policy (DATA, RANDOM, GREEDY — none reads the scalar) is simulated once on
the (R,) batch and its outputs are expanded over V. A state-dependent
policy that consumes the generator has no such sharing here and raises.

Axes: outputs are :class:`SimOutputs` whose tensors carry a leading
``(len(scalars),)`` axis, then the inputs' runs axis.

:func:`sweep_placed_budgets` does the same for the placement controller's
move budget: the budgets lead, ``(B, R)``, and each lane is the
per-budget ``simulate_placed_many`` call with the same seed.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import Tensor

from repro_torch.core.simulator import (
    PolicyFn,
    SimInputs,
    SimOutputs,
    build_runs,
    simulate,
    simulate_runs,
    take_runs_inputs,
)
from repro_torch.distributed.mesh import sharded_runs


def simulate_sweep(
    inputs: SimInputs,
    policy: PolicyFn,
    generator: torch.Generator | None,
    scalars,
    mesh=None,
) -> SimOutputs:
    """Run one trace bundle (with or without a runs axis) under ``policy``
    at every scalar in ``scalars``, all lanes in one slot loop. Outputs
    carry a leading ``(len(scalars),)`` axis. ``mesh`` runs a bundle's
    leading runs axis in chunks (:func:`repro_torch.core.simulator.simulate_runs`),
    bitwise the unchunked lanes."""
    dev = inputs.arrivals.device
    scalars = torch.as_tensor(scalars, dtype=torch.float32, device=dev)
    if scalars.ndim != 1:
        raise ValueError(f"scalars must be 1-D, got shape {tuple(scalars.shape)}")
    n_points = scalars.shape[0]
    lanes = lambda x: x.expand((n_points,) + tuple(x.shape))
    if getattr(policy, "state_independent", False):
        # The scalar reaches neither the decisions nor the queues: one
        # simulation, the same outputs in every lane.
        outs = simulate_runs(inputs, policy, generator, scalars[0], mesh=mesh)
        return SimOutputs(*(lanes(x) for x in outs))
    if getattr(policy, "consumes_key", True):
        raise ValueError(
            "simulate_sweep shares policy randomness across V lanes only for "
            "state-independent policies; a state-dependent policy that "
            "consumes the generator would draw a different stream per lane. "
            "Run it per point with simulate_many instead."
        )
    batch = tuple(inputs.arrivals.shape[:-2])

    def one(sel):
        part = take_runs_inputs(inputs, sel)
        grid = part._replace(arrivals=lanes(part.arrivals), mu=lanes(part.mu))
        return simulate(grid, policy, None, scalars.reshape((n_points,) + (1,) * len(batch)))

    return sharded_runs(one, batch[0] if batch else 1, mesh, axis=1)


def sweep_grid(
    build_inputs: Callable[[torch.Generator, int], SimInputs],
    policy: PolicyFn,
    generator: torch.Generator,
    n_runs: int,
    scalars,
    device=None,
    mesh=None,
) -> SimOutputs:
    """A full Monte-Carlo sweep at every scalar: ``build_inputs(generator,
    n_runs)`` once, then :func:`simulate_sweep` on the built bundle.

    Every scalar lane sees the same per-run traces, as ``simulate_many``
    per point with a generator seeded alike would. ``device=None`` means
    CUDA; the generator and the built inputs must live on that device.
    ``mesh`` runs the runs axis in chunks after the one draw, bitwise the
    unchunked call. Outputs: leading ``(len(scalars), n_runs)``.
    """
    inputs = build_runs(build_inputs, generator, n_runs, device)
    return simulate_sweep(inputs, policy, generator, scalars, mesh)


def sweep_placed_budgets(
    build_inputs: Callable[[torch.Generator, int], SimInputs],
    up: Tensor,
    down: Tensor,
    policy: PolicyFn,
    rule,
    generator: torch.Generator,
    n_runs: int,
    cfg,
    budgets,
    scalar: float | Tensor = 0.0,
    ingest: Tensor | None = None,
    sizes_gb: Tensor | None = None,
    alive: Tensor | None = None,
    device=None,
    mesh=None,
):
    """One-loop move-budget sweep of the two-timescale controller.

    The epoch structure (``cfg.epoch_slots``) is fixed; the per-epoch
    correction step alpha becomes a ``(B, 1)`` column against the (B, R)
    batch (the controller's ``move_budget`` override), so a whole
    ``placement_bench --sweep`` column runs as one controller loop — one
    kernel launch per slot for every (budget, run) lane. The traces are
    drawn once and expanded over the budgets (paired lanes, as in
    :func:`sweep_grid`). A policy that consumes the generator would draw one
    stream for all lanes where per-budget calls draw one each, so it
    raises. ``mesh`` runs the runs axis in chunks after the one draw,
    bitwise the unchunked call. Outputs: ``PlacedOutputs`` with leading
    ``(len(budgets), n_runs)``.
    """
    from repro_torch.placement.controller import simulate_placed

    if getattr(policy, "consumes_key", True):
        raise ValueError(
            "sweep_placed_budgets runs every budget lane in one loop; a "
            "policy that consumes the generator would draw one stream for "
            "all lanes where per-budget simulate_placed_many calls draw one "
            "each. Run it per budget instead."
        )
    inputs = build_runs(build_inputs, generator, n_runs, device)
    dev = inputs.arrivals.device
    budgets = torch.as_tensor(budgets, dtype=torch.float32, device=dev)
    if budgets.ndim != 1:
        raise ValueError(f"budgets must be 1-D, got shape {tuple(budgets.shape)}")
    n_b = budgets.shape[0]
    lanes = lambda x: x.expand((n_b,) + tuple(x.shape))
    batch = tuple(inputs.arrivals.shape[:-2])

    def one(sel):
        part = take_runs_inputs(inputs, sel)
        grid = part._replace(arrivals=lanes(part.arrivals), mu=lanes(part.mu))
        return simulate_placed(
            grid, up, down, policy, rule, None, cfg, scalar=scalar, ingest=ingest,
            sizes_gb=sizes_gb, alive=alive,
            move_budget=budgets.reshape((n_b,) + (1,) * len(batch)),
        )

    return sharded_runs(one, n_runs, mesh, axis=1)
