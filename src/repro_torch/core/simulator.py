"""Time-slotted trace-driven simulator (paper Sec. V).

One simulation replays T slots:

    observe (A(t), Q(t), mu(t), omega(t), PUE(t))
      -> policy picks f(t)                       (GMSA / DATA / RANDOM / ...)
      -> Cost(t) accrues                          (repro_torch.core.energy)
      -> queues update by Eq. 1                   (repro_torch.core.queues)

Monte-Carlo replication is a leading runs axis written out: ``arrivals`` and
``mu`` may carry it, and so does the carried backlog ``q`` (R, N, K), while
``r``, ``omega``, ``pue``, ``p_it`` and ``data_dist`` are shared by every
run. The slot loop is a Python loop; each slot runs every run at once.

Policies have the signature ``(generator, q, arrivals, mu, e, aux, scalar)
-> f``; ``scalar`` carries a control parameter (GMSA's V): 0-d, or with the
batch's leading shape and trailing ones, as a sweep's ``(V, 1)`` against a
(V, R) batch (:mod:`repro_torch.core.sweep`). Performance
structure kept from the reference engine:

  * the (T, K, N) energy tables are computed once, before the loop, and
    shared by all runs;
  * policies that declare ``state_independent = True`` (DATA, RANDOM,
    GREEDY) are evaluated for all slots and runs in one batched call;
  * policies that declare ``consumes_key = False`` get no generator and
    draw no per-slot randomness.

Policies that declare ``wants_wpue = True`` receive ``aux = (data_dist,
omega_t * pue_t)``; with ``wants_r = True`` as well, the slot's ratio
tensor is appended: ``aux = (data_dist, wpue_t, r_t)``. A policy marked
``static_r = True`` fed a time-varying (T, K, N, N) ratio trace raises.

``telemetry`` (a :class:`~repro_torch.telemetry.config.TelemetryConfig`)
at SUMMARY or above adds the per-slot per-site backlog stream and, with a
histogram spec, the per-site energy-cost histograms; ``None`` or OFF runs
exactly the operations of the engine without telemetry.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch import Tensor

from repro_torch.core.queues import queue_step
from repro_torch.core.reduce import run_sum
from repro_torch.device import resolve_device
from repro_torch.distributed.mesh import runs_parts, sharded_runs, take_runs
from repro_torch.telemetry.config import TelemetryConfig
from repro_torch.telemetry.config import enabled as _tel_enabled
from repro_torch.telemetry.config import histograms as _tel_hist
from repro_torch.telemetry.metrics import hist_series
from repro_torch.telemetry.ring import EventRing, TelemetryFrame, ring_init


class SimInputs(NamedTuple):
    """Trace bundle. T slots, N DCs, K job types, R Monte-Carlo runs.

    ``arrivals``/``mu`` may carry a leading runs axis; ``r`` and
    ``data_dist`` may carry a leading time axis — (T, K, N, N) and
    (T, K, N) — when the dataset layout evolves over the horizon.
    """

    arrivals: Tensor   # (T, K) or (R, T, K)   jobs arriving per slot
    mu: Tensor         # (T, N, K) or (R, T, N, K) service rates per slot
    omega: Tensor      # (T, N)   energy-price weights
    pue: Tensor        # (T, N)   PUE traces
    r: Tensor          # (K, N, N) or (T, K, N, N) task-allocation ratios
    p_it: Tensor       # (K,)     per-job IT energy
    data_dist: Tensor  # (K, N) or (T, K, N) dataset distribution (policy aux)


class SimOutputs(NamedTuple):
    """Per-slot columns, with the inputs' leading runs axis when present."""

    cost: Tensor           # ([R,] T) per-slot energy cost
    energy: Tensor         # ([R,] T) per-slot energy (PUE-weighted, unpriced)
    backlog_total: Tensor  # ([R,] T) sum of all queue backlogs
    backlog_avg: Tensor    # ([R,] T) mean backlog per (DC, type)
    q_final: Tensor        # ([R,] N, K)
    f_trace: Tensor        # ([R,] T, N, K) dispatch decisions


PolicyFn = Callable[..., Tensor]


def energy_tables(r: Tensor, wpue: Tensor, pue: Tensor, p_it: Tensor) -> tuple[Tensor, Tensor]:
    """(T, K, N) dispatch-cost and raw-energy tables, one einsum each.

    ``r`` is (K, N, N) broadcast over slots or (T, K, N, N) time-varying;
    ``wpue`` / ``pue`` are (T, N).
    """
    if r.ndim == 4:
        e_cost = torch.einsum("tkij,tj->tki", r, wpue)
        e_raw = torch.einsum("tkij,tj->tki", r, pue)
    else:
        e_cost = torch.einsum("kij,tj->tki", r, wpue)
        e_raw = torch.einsum("kij,tj->tki", r, pue)
    return e_cost * p_it[None, :, None], e_raw * p_it[None, :, None]


def energy_row(r: Tensor, wpue_t: Tensor, pue_t: Tensor, p_it: Tensor) -> tuple[Tensor, Tensor]:
    """(K, N) dispatch-cost and raw-energy tables for ONE slot; a
    (..., K, N, N) ``r`` with leading run dimensions gives (..., K, N), as
    products summed by :func:`repro_torch.core.reduce.run_sum` (a batched
    matmul's kernel may change with the number of runs)."""
    if r.ndim > 3:
        e_cost = run_sum(r * wpue_t, -1)
        e_raw = run_sum(r * pue_t, -1)
    else:
        e_cost = torch.einsum("...kij,j->...ki", r, wpue_t)
        e_raw = torch.einsum("...kij,j->...ki", r, pue_t)
    return e_cost * p_it[:, None], e_raw * p_it[:, None]


def slot_step(
    q: Tensor, f: Tensor, arrivals: Tensor, mu: Tensor, e_cost: Tensor, e_raw: Tensor
) -> tuple[Tensor, tuple]:
    """Advance one slot under dispatch ``f``: accrue cost/energy, step queues.

    Returns ``(q_next, (cost, energy, backlog_total, backlog_avg, f))``,
    the per-slot columns behind :class:`SimOutputs`. Leading run dimensions
    on q, f, arrivals and mu carry through; e_cost/e_raw are (K, N), or
    carry the run dimensions too (the placement controller's per-run rows).
    The per-run sums are :func:`repro_torch.core.reduce.run_sum`'s, the same
    bits whatever the number of runs in the call.
    """
    fa = f * arrivals.unsqueeze(-2)
    dims = (-2, -1)
    cost = run_sum(fa * e_cost.mT, dims)
    energy = run_sum(fa * e_raw.mT, dims)
    q_next = queue_step(q, f, arrivals, mu)
    total = run_sum(q_next, dims)
    return q_next, (cost, energy, total, total / float(q.shape[-2] * q.shape[-1]), f)


def _check_policy(policy: PolicyFn, r_varying: bool) -> None:
    if r_varying and getattr(policy, "static_r", False):
        raise ValueError(
            "policy binds a static (K, N, N) ratio tensor but inputs.r is "
            "time-varying (T, K, N, N) — the kernel would silently dispatch "
            "on stale ratios. Build it with make_kernel_policy(r=None) so "
            "the per-slot r reaches the kernel through the policy aux."
        )
    if getattr(policy, "wants_r", False) and not getattr(policy, "wants_wpue", False):
        raise ValueError(
            "wants_r policies must also declare wants_wpue: the aux "
            "contract is (data_dist, wpue_t, r_t)"
        )


def _scalar_for(scalar: float | Tensor, batch: tuple[int, ...], dev) -> Tensor:
    """The control parameter as fp32 on ``dev``: 0-d, or the batch's
    leading shape followed by ones (``(V, 1)`` for a (V, R) batch)."""
    scalar = torch.as_tensor(scalar, dtype=torch.float32, device=dev)
    lead = tuple(scalar.shape)
    fits = [batch[:j] + (1,) * (len(batch) - j) for j in range(len(batch) + 1)]
    if lead and lead not in fits:
        raise ValueError(
            f"scalar of shape {lead} does not fit the batch {batch}: pass a "
            "0-d scalar or the batch's leading dims followed by ones, e.g. "
            "(V, 1) for a (V, R) batch"
        )
    return scalar


def _stacked_ring(batch: tuple[int, ...], dev, capacity: int = 1) -> EventRing:
    """``ring_init(capacity)`` with the batch's leading dims, as a vmap
    stacks it."""
    return EventRing(*(x.expand(batch + tuple(x.shape)).clone()
                       for x in ring_init(capacity, device=dev)))


def _with_health(inputs: SimInputs, health: Tensor | None) -> SimInputs:
    """``inputs`` with service rates scaled by a (T, N) health trace."""
    if health is None:
        return inputs
    h = torch.as_tensor(health, dtype=inputs.mu.dtype, device=inputs.mu.device)
    return inputs._replace(mu=inputs.mu * h[:, :, None])


def _policy_aux(inputs: SimInputs, policy: PolicyFn, wpue_all: Tensor | None, t: int | None):
    """The policy's aux for slot ``t`` (``None``: every slot, slot axis
    leading): ``data_dist``, ``(data_dist, wpue)`` for ``wants_wpue``, and
    the ratio tensor appended for ``wants_r``."""
    if t is None or inputs.data_dist.ndim != 3:
        aux = inputs.data_dist
    else:
        aux = inputs.data_dist[t]
    if wpue_all is not None:
        aux = (aux, wpue_all if t is None else wpue_all[t])
    if getattr(policy, "wants_r", False):
        aux = aux + (inputs.r if (t is None or inputs.r.ndim != 4) else inputs.r[t],)
    return aux


def _all_slot_decisions(inputs: SimInputs, policy: PolicyFn, gen, scalar: Tensor,
                        e_cost_all: Tensor, wpue_all: Tensor | None) -> Tensor:
    """A state-independent policy's decisions for every slot and run in one
    call: per-slot operands keep their slot axis, the zero backlog gets a
    broadcastable one. Returns them expanded to (batch..., T, N, K)."""
    t_slots, k_types = inputs.arrivals.shape[-2:]
    batch = tuple(inputs.arrivals.shape[:-2])
    n = inputs.mu.shape[-2]
    q0 = torch.zeros(batch + (1, n, k_types), dtype=torch.float32, device=inputs.arrivals.device)
    f_all = policy(gen, q0, inputs.arrivals, inputs.mu, e_cost_all,
                   _policy_aux(inputs, policy, wpue_all, None), scalar)
    return f_all.expand(batch + (t_slots, n, k_types))


def simulate(
    inputs: SimInputs,
    policy: PolicyFn,
    generator: torch.Generator | None = None,
    scalar: float | Tensor = 0.0,
    health: Tensor | None = None,
    telemetry: TelemetryConfig | None = None,
) -> SimOutputs | tuple[SimOutputs, TelemetryFrame]:
    """Run the trace-driven simulation under ``policy`` for every run at once.

    ``generator`` feeds the policy's randomness (RANDOM) and is passed only
    to policies that consume it. ``health`` is an optional (T, N)
    degraded-mode factor: service rates scale as ``mu * health`` (0 = dead,
    interior = straggler), applied once before the loop; an all-ones trace
    is an exact identity.

    With ``telemetry`` at SUMMARY or above the call returns ``(outputs,
    TelemetryFrame)``: ``metrics["q_site"]`` is the ([R,] T, N) per-site
    backlog after each slot, ``metrics["site_cost_hist"]`` (with
    ``telemetry.hist``) the ([R,] N, n_buckets) histogram over slots of each
    site's energy bill, and the ring is ``ring_init(1)`` per run (this
    engine records no events in its loop).
    """
    tel_on = _tel_enabled(telemetry)
    inputs = _with_health(inputs, health)
    t_slots, k_types = inputs.arrivals.shape[-2:]
    batch = tuple(inputs.arrivals.shape[:-2])                  # (), (R,) or (V, R)
    n = inputs.mu.shape[-2]
    dev = inputs.arrivals.device
    q = torch.zeros(batch + (n, k_types), dtype=torch.float32, device=dev)
    e_cost_all, e_raw_all = energy_tables(
        inputs.r, inputs.omega * inputs.pue, inputs.pue, inputs.p_it
    )                                                          # (T, K, N)
    scalar = _scalar_for(scalar, batch, dev)

    _check_policy(policy, inputs.r.ndim == 4)
    gen = generator if getattr(policy, "consumes_key", True) else None
    wpue_all = inputs.omega * inputs.pue if getattr(policy, "wants_wpue", False) else None

    f_all = None
    if getattr(policy, "state_independent", False):
        f_all = _all_slot_decisions(inputs, policy, gen, scalar, e_cost_all, wpue_all)

    cols = []
    for t in range(t_slots):
        arrivals = inputs.arrivals[..., t, :]
        mu = inputs.mu[..., t, :, :]
        if f_all is None:
            f = policy(gen, q, arrivals, mu, e_cost_all[t], _policy_aux(inputs, policy, wpue_all, t),
                       scalar)
        else:
            f = f_all[..., t, :, :]
        q, out = slot_step(q, f, arrivals, mu, e_cost_all[t], e_raw_all[t])
        if tel_on:
            out = out + (q.sum(dim=-1),)                       # (..., N) per-site q
        cols.append(out)
    stacked = [torch.stack(c, dim=len(batch)) for c in zip(*cols)]
    cost, energy, btot, bavg, f_trace = stacked[:5]
    outs = SimOutputs(cost, energy, btot, bavg, q, f_trace)
    if not tel_on:
        return outs
    metrics = {"q_site": stacked[5]}
    if _tel_hist(telemetry):
        # Each site's bill per slot, sum_k (f·A) * e_cost, derived after the
        # loop from the stacked dispatch trace.
        site_cost = torch.einsum("...tnk,...tk,tkn->...tn", f_trace, inputs.arrivals,
                                 e_cost_all)
        metrics["site_cost_hist"] = hist_series(telemetry.hist, site_cost, axis=-2)
    return outs, TelemetryFrame(ring=_stacked_ring(batch, dev), metrics=metrics)


def build_runs(
    build_inputs: Callable[[torch.Generator, int], SimInputs],
    generator: torch.Generator,
    n_runs: int,
    device=None,
) -> SimInputs:
    """``build_inputs(generator, n_runs)``, checked to run on ``device``
    (``None``: CUDA): the generator and the built tensors must live there.

    The per-run traces are returned contiguous, each run's slots one block
    (a builder may draw them in another order): the order in which every
    operation downstream walks a run's elements, and so each reduction's
    sum order, is then the same whatever the number of runs in a call or
    chunk (:mod:`repro_torch.distributed.mesh`)."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator lives on {generator.device}, not {dev}")
    inputs = build_inputs(generator, n_runs)
    if inputs.arrivals.device.type != dev.type:
        raise ValueError(
            f"build_inputs made tensors on {inputs.arrivals.device}, not {dev}"
        )
    return inputs._replace(arrivals=inputs.arrivals.contiguous(), mu=inputs.mu.contiguous())


def take_runs_inputs(inputs: SimInputs, sel: Tensor | None) -> SimInputs:
    """The runs ``sel`` of a bundle built with a leading runs axis
    (``arrivals`` (R, T, K), ``mu`` (R, T, N, K)); the shared traces stay
    as they are. ``sel=None``: the bundle itself."""
    if sel is None:
        return inputs
    if inputs.arrivals.ndim != 3:
        raise ValueError("chunking the runs axis needs a bundle with one leading runs axis, "
                         f"got arrivals of shape {tuple(inputs.arrivals.shape)}")
    return inputs._replace(arrivals=take_runs(inputs.arrivals, sel),
                           mu=take_runs(inputs.mu, sel))


def take_runs_scalar(x, sel: Tensor | None, n_runs: int):
    """A per-run control parameter's runs ``sel``: a tensor whose leading
    axis is the runs axis (``n_runs`` > 1 long) is sliced; anything else
    (a number, a 0-d tensor, a broadcast axis) is shared."""
    if isinstance(x, Tensor) and x.ndim and x.shape[0] == n_runs > 1:
        return take_runs(x, sel)
    return x


def refuse_generator_in_chunks(policy: PolicyFn, mesh, where: str) -> None:
    """Raise when ``policy`` would draw from the generator inside a chunked
    call: its draws would have each chunk's shape, not the whole batch's,
    and the runs would differ from the unchunked call's."""
    if runs_parts(mesh) > 1 and getattr(policy, "consumes_key", True):
        raise ValueError(
            f"{where} with a runs mesh of {runs_parts(mesh)} parts: the policy consumes the "
            "generator, and drawing per chunk would give other runs than the unchunked call. "
            "Run it without a mesh."
        )


def _replayed(f_all: Tensor) -> PolicyFn:
    """A state-independent policy answering with decisions already drawn."""

    def policy(generator, q, arrivals, mu, e, aux, scalar):
        del generator, q, arrivals, mu, e, aux, scalar
        return f_all

    policy.state_independent = True
    policy.consumes_key = False
    return policy


def simulate_runs(
    inputs: SimInputs,
    policy: PolicyFn,
    generator: torch.Generator | None = None,
    scalar: float | Tensor = 0.0,
    health: Tensor | None = None,
    telemetry: TelemetryConfig | None = None,
    mesh=None,
) -> SimOutputs | tuple[SimOutputs, TelemetryFrame]:
    """:func:`simulate` on a bundle with a leading runs axis, the runs in
    ``mesh``'s chunks (:func:`repro_torch.distributed.mesh.sharded_runs`;
    ``None``: one call), bitwise the unchunked call's outputs.

    A state-independent policy that consumes the generator (RANDOM) is
    evaluated once on the whole batch, as without a mesh, and each chunk
    replays its runs' decisions; a state-dependent one raises.
    """
    n_runs = inputs.arrivals.shape[0]
    chunked = runs_parts(mesh) > 1
    if chunked and getattr(policy, "consumes_key", True):
        if not getattr(policy, "state_independent", False):
            refuse_generator_in_chunks(policy, mesh, "simulate_runs")
        whole = _with_health(inputs, health)
        dev = whole.arrivals.device
        wpue_all = whole.omega * whole.pue if getattr(policy, "wants_wpue", False) else None
        e_cost_all, _ = energy_tables(whole.r, whole.omega * whole.pue, whole.pue, whole.p_it)
        f_all = _all_slot_decisions(
            whole, policy, generator,
            _scalar_for(scalar, tuple(whole.arrivals.shape[:-2]), dev), e_cost_all, wpue_all)
        del whole, e_cost_all
        chunk_policy = lambda sel: _replayed(take_runs(f_all, sel))
    else:
        chunk_policy = lambda sel: policy
    return sharded_runs(
        lambda sel: simulate(take_runs_inputs(inputs, sel), chunk_policy(sel), generator,
                             take_runs_scalar(scalar, sel, n_runs), health, telemetry),
        n_runs, mesh)


def simulate_many(
    build_inputs: Callable[[torch.Generator, int], SimInputs],
    policy: PolicyFn,
    generator: torch.Generator,
    n_runs: int,
    scalar: float | Tensor = 0.0,
    health: Tensor | None = None,
    device=None,
    telemetry: TelemetryConfig | None = None,
    mesh=None,
) -> SimOutputs | tuple[SimOutputs, TelemetryFrame]:
    """Monte-Carlo replication: fresh stochastic traces + policy randomness
    per run, all runs in one batched simulation.

    ``build_inputs(generator, n_runs)`` draws the stacked (R, ...) arrivals
    and service rates; the deterministic traces (prices, PUE, ratios — and
    ``health``, when given) are shared. ``device=None`` means CUDA; the
    generator and the built inputs must live on that device. ``telemetry``
    as in :func:`simulate`: the frame's tensors carry the runs axis.

    ``mesh`` (:func:`repro_torch.distributed.mesh.runs_mesh`) runs the runs
    axis in chunks, one after another on the device, after one draw of the
    traces for every run (:func:`simulate_runs`): the outputs are bitwise
    identical at every chunk count, padded counts included.
    """
    inputs = build_runs(build_inputs, generator, n_runs, device)
    return simulate_runs(inputs, policy, generator, scalar, health, telemetry, mesh)


def summarize(outs: SimOutputs) -> dict:
    """Time-averaged scalars (averaged over runs if a runs axis is present)."""
    return {
        "time_avg_cost": float(outs.cost.mean()),
        "time_avg_energy": float(outs.energy.mean()),
        "time_avg_backlog": float(outs.backlog_avg.mean()),
        "final_backlog_total": float(outs.q_final.sum(dim=(-2, -1)).mean()),
    }
