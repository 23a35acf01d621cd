"""``simulate_staged`` — trace-driven engine for stage-structured jobs.

Generalizes :func:`repro_torch.core.simulator.simulate` from one queue per
(DC, type) to one per (DC, type, stage): per slot, each stage's inflow is
dispatched by the policy's (N, K, S) decision, Eq. 1 advances every stage
queue (the slot body evaluates :func:`repro_torch.core.simulator.slot_step`'s
own expression with the stage axis folded into the type axis, so the
single-stage dispatch and queues stay bitwise ``simulate``'s), completions
flow down the chain within the slot (a tandem of queues), and the
intermediate bytes each hop ships across the WAN are billed through
:func:`repro_torch.placement.wan.plan_cost` — the fused bilinear form of
``transfer_cost(transfer_plan(...))``: a stage whose destination mix equals
its source mix (a data-local map, a co-located reduce) moves nothing, and
no (K, N, N) plan is materialized.

The per-slot semantics, stage by stage (s = 0..S-1):

    in^{k,s}   = f^{k,s} * F^{k,s}          F^{k,0} = A^k(t), else the
                                            upstream completions
    Q^{k,s}    + Eq. 1 under (in, mu / c^{k,s})
    done^{k,s} = min(Q + in, mu/c)          flows to stage s+1 (or out)
    WAN bill   = plan_cost(src^{k,s}, f^{k,s}, F^{k,s} * G^{k,s})

Monte-Carlo replication is a leading runs axis written out, as in the
port's ``simulate``: ``arrivals``/``mu`` may carry it (and a sweep's
(V, R)), and every per-run tensor carries it through. The slot loop is a
Python loop holding only the sequential part (the policy's decision and the
tandem flow); everything derivable from the stacked ``(f, acc, in)``
columns — costs, backlogs, completions, source mixes and the WAN bill — is
computed after the loop, vectorized over all T slots.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch import Tensor

from repro_torch.core.reduce import run_sum
from repro_torch.core.simulator import (
    PolicyFn,
    SimInputs,
    _scalar_for,
    _stacked_ring,
    build_runs,
    energy_tables,
    refuse_generator_in_chunks,
    take_runs_inputs,
    take_runs_scalar,
)
from repro_torch.distributed.mesh import sharded_runs
from repro_torch.jobs.dag import StageDag
from repro_torch.jobs.scheduler import stage_oblivious, stage_service_rates_all
from repro_torch.placement.wan import WanModel, degraded_surcharge, plan_cost
from repro_torch.telemetry.config import TelemetryConfig
from repro_torch.telemetry.config import enabled as _tel_enabled
from repro_torch.telemetry.config import histograms as _tel_hist
from repro_torch.telemetry.metrics import hist_series
from repro_torch.telemetry.ring import TelemetryFrame

#: Zero-flow guard for the source-mix normalization — the same epsilon
#: :func:`repro_torch.jobs.scheduler.flow_step` uses, so the engine's
#: replayed mixes equal the policy lookahead's exactly.
_EPS = 1e-12


def hedged_mu(f: Tensor, g: Tensor, mu_stages: Tensor) -> Tensor:
    """First-completion service rates under the clone matrix ``g``.

    The boost the policy's flow walk applied, re-derived from the same
    inputs — ``mu + f · (Σ_n g·mu)`` — so the engine's Eq. 1 drains
    exactly the flow the scheduler exported. Selected per run: a run in
    which no hedge fired this slot keeps its unboosted rates bit for bit,
    whatever the other runs of the batch did.

    Args:
        f, g, mu_stages: (..., N, K, S).
    """
    boost = (g * mu_stages).sum(dim=-3)                            # (..., K, S)
    boosted = mu_stages + f * boost.unsqueeze(-3)
    fired = (g > 0.0).flatten(-3).any(dim=-1)                      # (...,)
    return torch.where(fired[..., None, None, None], boosted, mu_stages)


def staged_slot_update(
    dag: StageDag,
    q: Tensor,
    ret,
    arrivals: Tensor,
    mu_stages: Tensor,
    returns_flow: bool,
    returns_hedge: bool = False,
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """One slot of the staged engine: tandem flow + Eq. 1 for every stage.

    ``ret`` is the policy's output — ``(f, in_stack)`` for ``returns_flow``
    policies (the stage-aware scheduler already walked the within-slot flow
    via :func:`repro_torch.jobs.scheduler.flow_step`), bare ``f`` otherwise
    (the recursion is replayed here). ``returns_hedge`` policies append the
    (..., N, K, S) speculative-clone matrix ``g`` — the queues then drain
    at the first-completion boosted rates (:func:`hedged_mu`). This is the
    single definition of the per-slot staged update.

    Args:
        q, mu_stages: (..., N, K, S); arrivals: (..., K).

    Returns:
        (q_next, f, acc, in_stack): the advanced (..., N, K, S) queues, the
        dispatch decision, the landed mass ``q + f·in`` (the inside of
        Eq. 1's max) and the (..., K, S) per-stage inflows.
    """
    s_max = dag.s_max
    if returns_hedge:
        f, in_stack, g = ret
        acc = q + f * in_stack.unsqueeze(-3)                       # (..., N, K, S)
        mu_stages = hedged_mu(f, g, mu_stages)
    elif returns_flow:
        f, in_stack = ret
        acc = q + f * in_stack.unsqueeze(-3)
    else:
        f = ret
        total_in = arrivals                                        # (..., K)
        ins, accs = [], []
        for s in range(s_max):
            ins.append(total_in.expand(q.shape[:-3] + q.shape[-2:-1]))
            acc_s = q[..., s] + f[..., s] * total_in.unsqueeze(-2)
            accs.append(acc_s)
            if s + 1 < s_max:
                done_s = torch.minimum(acc_s, mu_stages[..., s])
                total_in = run_sum(done_s, -2) * dag.stage_mask[:, s + 1]
        acc = torch.stack(accs, dim=-1)                            # (..., N, K, S)
        in_stack = torch.stack(ins, dim=-1)                        # (..., K, S)

    # Eq. 1 for ALL stages at once, the stage axis folded into the type
    # axis (one queue per (DC, type·stage)). The expression is
    # ``queue_step``'s own — ``max((q + fa) - mu, 0)`` — so for S = 1 the
    # queues are bitwise the base engine's.
    q_next = torch.clamp_min(acc - mu_stages, 0.0)
    return q_next, f, acc, in_stack


def _skn(x: Tensor) -> Tensor:
    """(..., N, K, S) -> (..., S, K, N)."""
    return x.transpose(-3, -1)


def staged_shuffle_mixes(
    f_trace: Tensor,
    in_all: Tensor,
    done_all: Tensor,
    dd_all: Tensor,
    dag: StageDag,
) -> tuple[Tensor, Tensor, Tensor]:
    """Source/destination mixes + volumes for every (slot, stage) shuffle.

    Vectorized over the whole horizon from the stacked per-slot outputs:
    stage 0 pulls from ``data_dist``; stage s > 0 pulls from where stage
    s-1's completions actually ran (uniform fallback for zero flow — the
    volume is zero there, so the choice is billing-inert, the same
    ``flow_step`` contract the policy lookahead uses).

    Args:
        f_trace, done_all: (..., T, N, K, S); in_all: (..., T, K, S);
        dd_all: (T, K, N) data layout per slot.

    Returns:
        (src, dst, vol): (..., T, S, K, N), (..., T, S, K, N), (..., T, S, K).
    """
    n = f_trace.shape[-3]
    lead = f_trace.shape[:-3]                                      # (..., T)
    dd0 = dd_all[:, None].expand(lead + (1,) + tuple(dd_all.shape[-2:]))
    if dag.s_max == 1:
        src_all = dd0                                              # (..., T, 1, K, N)
    else:
        done_up = _skn(done_all[..., :-1])                         # (..., T, S-1, K, N)
        td_up = run_sum(done_all[..., :-1], -3).mT[..., None]      # (..., T, S-1, K, 1)
        src_up = torch.where(td_up > _EPS, done_up / torch.clamp_min(td_up, _EPS), 1.0 / n)
        src_all = torch.cat([dd0, src_up], dim=-3)
    dst_all = _skn(f_trace)                                        # (..., T, S, K, N)
    vol_all = (in_all * dag.shuffle_gb).mT                         # (..., T, S, K)
    return src_all, dst_all, vol_all


def staged_wan_bill(
    src_all: Tensor,
    dst_all: Tensor,
    vol_all: Tensor,
    wan: WanModel,
    omega: Tensor,
    pue: Tensor,
    link_health: Tensor | None = None,
) -> tuple[Tensor, Tensor, Tensor]:
    """The WAN bill of every (slot, stage) shuffle in one fused
    :func:`plan_cost` call, the stages folded into the type axis.

    With a (T, N, N) ``link_health`` the degraded-link premium is added on
    top of the untouched fused bill (exact zero on an all-nominal trace);
    it materializes (..., T, S·K, N, N) plans.

    Args:
        src_all, dst_all: (..., T, S, K, N); vol_all: (..., T, S, K), as
            :func:`staged_shuffle_mixes` returns them.

    Returns:
        (cost, energy, gb), (..., T) each.
    """
    n = src_all.shape[-1]
    fold = tuple(src_all.shape[:-3]) + (src_all.shape[-3] * src_all.shape[-2],)
    src, dst, vol = src_all.reshape(fold + (n,)), dst_all.reshape(fold + (n,)), vol_all.reshape(fold)
    wan_c, wan_e, wan_gb = plan_cost(src, dst, vol, wan, omega, pue)
    if link_health is not None:
        sur_c, sur_e = degraded_surcharge(src, dst, vol, wan, omega, pue, link_health)
        wan_c = wan_c + sur_c
        wan_e = wan_e + sur_e
    return wan_c, wan_e, wan_gb


def _hedge_bill(
    dag: StageDag,
    wan: WanModel,
    g_all: Tensor,
    acc_all: Tensor,
    mu_stage_all: Tensor,
    mu_eff_all: Tensor,
    ec_stage_all: Tensor,
    src_all: Tensor,
    wpue_all: Tensor,
) -> tuple[Tensor, Tensor, Tensor]:
    """Honest post-loop bill for speculative re-execution.

    In the fluid first-completion model the clone's contribution is the
    boost-attributable completions — ``min(acc, mu_eff) - min(acc, mu)`` —
    re-executed at the clone site. Each re-executed job-unit bills the clone
    site's per-stage energy cost (compute) plus the expected WAN pull of the
    stage's input shuffle from the upstream source mix to the clone site
    (the fused rank-2 expected-pull form the scheduler prices dispatch
    with). Vectorized over (..., T).

    Returns:
        (hedge_cost, hedge_gb, hedged_jobs) — (..., T) each: total $ billed
        (compute + WAN pull), GB pulled to clone sites, and re-executed
        job-units completed by clones.
    """
    extra = torch.minimum(acc_all, mu_eff_all) - torch.minimum(acc_all, mu_stage_all)
    extra_ks = extra.sum(dim=-3)                                   # (..., T, K, S)
    ec_clone = (g_all * ec_stage_all.permute(0, 3, 1, 2)).sum(dim=-3)   # (..., T, K, S)
    compute_bill = (extra_ks * ec_clone).sum(dim=(-2, -1))         # (..., T)
    g_skn = _skn(g_all)                                            # (..., T, S, K, N)
    w = wpue_all[:, None, None, :]                                 # (T, 1, 1, N)
    dot = (src_all * w).sum(dim=-1)                                # (..., T, S, K)
    pull = 0.5 * (dot[..., None] + w) - src_all * w                # (..., T, S, K, N)
    price_clone = (pull * g_skn).sum(dim=-1)                       # (..., T, S, K)
    vol = extra_ks.mT * dag.shuffle_gb.T                           # (..., T, S, K)
    wan_bill = wan.energy_per_gb * (price_clone * vol).sum(dim=(-2, -1))
    hedge_gb = vol.sum(dim=(-2, -1))
    hedged_jobs = extra_ks.sum(dim=(-2, -1))
    return compute_bill + wan_bill, hedge_gb, hedged_jobs


class StagedOutputs(NamedTuple):
    """Per-slot columns of staged runs, with the inputs' leading runs axis.

    The three hedge columns are all-zero for policies without the
    ``returns_hedge`` contract (and where the hedge never fires), so
    downstream consumers need no feature detection.
    """

    cost: Tensor           # ([R,] T) per-slot stage-compute energy cost
    energy: Tensor         # ([R,] T) PUE-weighted compute energy (unpriced)
    backlog_total: Tensor  # ([R,] T) sum over all (DC, type, stage) backlogs
    backlog_avg: Tensor    # ([R,] T) mean backlog per (DC, type, stage)
    q_final: Tensor        # ([R,] N, K, S)
    f_trace: Tensor        # ([R,] T, N, K, S) per-stage dispatch decisions
    wan_cost: Tensor       # ([R,] T) $ billed for intermediate-data movement
    wan_energy: Tensor     # ([R,] T) WAN energy (job-energy equivalents)
    wan_gb: Tensor         # ([R,] T) intermediate GB crossing the WAN
    completed: Tensor      # ([R,] T, K) jobs finishing their last stage per slot
    hedge_cost: Tensor     # ([R,] T) $ billed for speculative re-execution
    hedge_gb: Tensor       # ([R,] T) GB pulled to clone sites by hedges
    hedged_jobs: Tensor    # ([R,] T) job-units completed by speculative clones


def simulate_staged(
    inputs: SimInputs,
    dag: StageDag,
    wan: WanModel,
    policy: PolicyFn,
    generator: torch.Generator | None = None,
    scalar: float | Tensor = 0.0,
    telemetry: TelemetryConfig | None = None,
    health: Tensor | None = None,
    link_health: Tensor | None = None,
) -> StagedOutputs | tuple[StagedOutputs, TelemetryFrame]:
    """Run stage-structured trace-driven simulations under ``policy``, every
    run of the batch at once.

    Args:
        inputs: the usual trace bundle (``arrivals``/``mu`` may carry leading
            runs dims); ``r``/``data_dist`` may be static or time-varying
            exactly as in ``simulate``.
        dag: the (K, S) stage chain.
        wan: WAN model pricing the inter-stage shuffle bytes.
        policy: a staged policy (attribute ``staged = True``, signature
            ``(generator, q(..., N, K, S), arrivals, mu, e, (data_dist,
            wpue[, r_t]), scalar) -> f(..., N, K, S)``) or any base
            simulator policy, which is wrapped by
            :func:`repro_torch.jobs.scheduler.stage_oblivious`.
        generator: feeds the policy's randomness; passed only to policies
            that consume it (as in ``simulate``).
        scalar: control parameter forwarded to the policy (GMSA's V).
        telemetry: at SUMMARY or above the call returns ``(outputs,
            TelemetryFrame)`` whose metrics are per-(slot, stage) streams —
            ``q_site``, ``stage_backlog`` and the WAN bill split by stage
            (``stage_wan_cost``, ``stage_wan_gb``), plus ``queue_delay`` and
            its per-stage histogram with a histogram spec — all derived
            after the loop. ``None``/OFF runs the engine's own operations.
        health: optional (T, N) degraded-mode factor: per-slot service
            rates scale as ``mu * health``, applied before any table is
            derived (an all-ones trace is an exact identity).
        link_health: optional (T, N, N) link factor: the WAN bill gains the
            :func:`repro_torch.placement.wan.degraded_surcharge` premium,
            added on top of the untouched fused bill. It materializes
            (..., K, N, N) plans: small fleets only.
    """
    tel_on = _tel_enabled(telemetry)
    if health is not None:
        h = torch.as_tensor(health, dtype=inputs.mu.dtype, device=inputs.mu.device)
        inputs = inputs._replace(mu=inputs.mu * h[:, :, None])
    t_slots, k_types = inputs.arrivals.shape[-2:]
    batch = tuple(inputs.arrivals.shape[:-2])
    n = inputs.mu.shape[-2]
    s_max = dag.s_max
    dev = inputs.arrivals.device
    if dag.k_types != k_types:
        raise ValueError(f"dag is for K={dag.k_types} types, inputs carry K={k_types}")
    q = torch.zeros(batch + (n, k_types, s_max), dtype=torch.float32, device=dev)
    wpue_all = inputs.omega * inputs.pue                           # (T, N)
    e_cost_all, e_raw_all = energy_tables(inputs.r, wpue_all, inputs.pue, inputs.p_it)
    scalar = _scalar_for(scalar, batch, dev)

    # Everything per-slot-invariant is computed once before the loop: the
    # per-stage service rates (mu / c) and the per-stage energy tables
    # (e * c, laid out (T, K, S, N)). Stage padding uses the exact identity
    # c = 1.0, so single-stage tables are bitwise the base engine's.
    mu_stage_all = stage_service_rates_all(inputs.mu, dag)         # (..., T, N, K, S)
    ec_stage_all = e_cost_all[:, :, None, :] * dag.compute[None, :, :, None]
    er_stage_all = e_raw_all[:, :, None, :] * dag.compute[None, :, :, None]

    pol = policy if getattr(policy, "staged", False) else stage_oblivious(policy)
    gen = generator if getattr(pol, "consumes_key", True) else None
    returns_flow = getattr(pol, "returns_flow", False)
    returns_hedge = getattr(pol, "returns_hedge", False)
    dd_varying = inputs.data_dist.ndim == 3                        # (T, K, N)
    r_varying = inputs.r.ndim == 4                                 # (T, K, N, N)
    wants_r = getattr(pol, "wants_r", False)
    if r_varying and getattr(pol, "static_r", False):
        raise ValueError(
            "policy binds a static (K, N, N) ratio tensor but inputs.r is "
            "time-varying (T, K, N, N) — the kernel would silently dispatch "
            "on stale ratios. Build it with make_kernel_policy(r=None) so "
            "the per-slot r reaches the kernel through the policy aux."
        )
    state_independent = getattr(pol, "state_independent", False)
    if returns_flow and state_independent:
        raise ValueError(
            "returns_flow policies are state-dependent by construction "
            "(the exported inflows depend on the live backlog); do not "
            "also mark them state_independent"
        )

    def aux_for(t):
        """Policy aux for slot ``t`` (``None``: every slot, slot axis leading)."""
        dd = inputs.data_dist if (t is None or not dd_varying) else inputs.data_dist[t]
        aux = (dd, wpue_all if t is None else wpue_all[t])
        if wants_r:
            aux = aux + (inputs.r if (t is None or not r_varying) else inputs.r[t],)
        return aux

    f_all = None
    if state_independent:
        # All slots (and runs) at once: per-slot operands keep their slot
        # axis, the zero backlog gets a broadcastable one.
        f_all = pol(gen, q.unsqueeze(-4), inputs.arrivals, inputs.mu, e_cost_all,
                    aux_for(None), scalar)
        f_all = f_all.expand(batch + (t_slots, n, k_types, s_max))

    fs, accs, ins, gs = [], [], [], []
    for t in range(t_slots):
        arrivals = inputs.arrivals[..., t, :]
        if f_all is None:
            ret = pol(gen, q, arrivals, inputs.mu[..., t, :, :], e_cost_all[t], aux_for(t), scalar)
        else:
            ret = f_all[..., t, :, :, :]
        # Within-slot tandem flow — the only sequential part (acc = Q + f·F
        # is the inside of Eq. 1's max; completions min(acc, mu) seed the
        # next stage). Policies that walked this chain already
        # (``returns_flow``) export the inflows and the recursion is skipped.
        q, f, acc, in_stack = staged_slot_update(
            dag, q, ret, arrivals, mu_stage_all[..., t, :, :, :], returns_flow, returns_hedge
        )
        fs.append(f)
        accs.append(acc)
        ins.append(in_stack)
        if returns_hedge:
            gs.append(ret[2])
    tdim = len(batch)
    f_trace = torch.stack(fs, dim=tdim)                            # (..., T, N, K, S)
    acc_all = torch.stack(accs, dim=tdim)
    in_all = torch.stack(ins, dim=tdim)                            # (..., T, K, S)
    g_all = torch.stack(gs, dim=tdim) if returns_hedge else None
    del fs, accs, ins, gs
    q_final = q

    # Everything the loop did NOT compute, recovered vectorized over all T
    # slots from (f, acc, in) with ``slot_step``'s and ``flow_step``'s own
    # expressions:
    #   * cost/energy: sum(fa * e) with fa = f * in;
    #   * backlogs: q_next = max(acc - mu, 0) summed/averaged;
    #   * completions per stage: min(acc, mu) summed over sites;
    #   * source mixes + shuffle volumes + the WAN bill for ALL (slot,
    #     stage) pairs in one fused batched plan_cost call, stages folded
    #     into the type axis.
    fa_all = f_trace * in_all.unsqueeze(-3)                        # (..., T, N, K, S)
    dims = (-3, -2, -1)
    cost = (fa_all * ec_stage_all.permute(0, 3, 1, 2)).sum(dim=dims)       # (..., T)
    energy = (fa_all * er_stage_all.permute(0, 3, 1, 2)).sum(dim=dims)
    del fa_all
    if returns_hedge:
        # The queues drained at the first-completion boosted rates (per run
        # and slot); the replay applies the same boost everywhere — slots
        # without a hedge add an exact ``f * 0.0``.
        boost_all = (g_all * mu_stage_all).sum(dim=-3)             # (..., T, K, S)
        mu_eff_all = mu_stage_all + f_trace * boost_all.unsqueeze(-3)
    else:
        mu_eff_all = mu_stage_all
    q_next_all = torch.clamp_min(acc_all - mu_eff_all, 0.0)        # (..., T, N, K, S)
    btot = q_next_all.sum(dim=dims)
    bavg = btot / float(n * k_types * s_max)
    done_all = torch.minimum(acc_all, mu_eff_all)                  # (..., T, N, K, S)
    td_all = done_all.sum(dim=-3)                                  # (..., T, K, S)
    nxt = torch.cat([dag.stage_mask[:, 1:], torch.zeros_like(dag.stage_mask[:, :1])], dim=1)
    # Products summed over s, not an einsum: a batched matmul's kernel may
    # change with the number of runs, and with it the sum order.
    completed = (td_all * (dag.stage_mask - nxt)).sum(dim=-1)
    del td_all

    dd_all = (
        inputs.data_dist if dd_varying
        else inputs.data_dist.expand((t_slots,) + tuple(inputs.data_dist.shape))
    )                                                              # (T, K, N)
    src_all, dst_all, vol_all = staged_shuffle_mixes(f_trace, in_all, done_all, dd_all, dag)
    del done_all
    lh = None if link_health is None else torch.as_tensor(link_health, dtype=torch.float32,
                                                          device=dev)
    wan_c, wan_e, wan_gb = staged_wan_bill(src_all, dst_all, vol_all, wan, inputs.omega,
                                           inputs.pue, lh)        # (..., T) each
    if returns_hedge:
        hedge_cost, hedge_gb, hedged_jobs = _hedge_bill(
            dag, wan, g_all, acc_all, mu_stage_all, mu_eff_all, ec_stage_all, src_all, wpue_all,
        )
    else:
        zeros_t = torch.zeros(batch + (t_slots,), dtype=torch.float32, device=dev)
        hedge_cost = hedge_gb = hedged_jobs = zeros_t
    del acc_all, mu_eff_all
    outs = StagedOutputs(
        cost=cost, energy=energy, backlog_total=btot, backlog_avg=bavg,
        q_final=q_final, f_trace=f_trace,
        wan_cost=wan_c, wan_energy=wan_e, wan_gb=wan_gb,
        completed=completed,
        hedge_cost=hedge_cost, hedge_gb=hedge_gb, hedged_jobs=hedged_jobs,
    )
    if not tel_on:
        return outs
    # Per-stage streams from the same stacked columns: the per-(slot, stage)
    # WAN split is a second batched plan_cost call without the type-axis
    # fold, leaving the fused bill and its reduction order untouched.
    stage_backlog = q_next_all.sum(dim=(-3, -2))                   # (..., T, S)
    sw_c, _, sw_gb = plan_cost(
        src_all, dst_all, vol_all, wan, inputs.omega[:, None, :], inputs.pue[:, None, :],
    )                                                              # (..., T, S)
    metrics = {
        "q_site": q_next_all.sum(dim=(-2, -1)),                    # (..., T, N)
        "stage_backlog": stage_backlog,
        "stage_wan_cost": sw_c,
        "stage_wan_gb": sw_gb,
    }
    if _tel_hist(telemetry):
        # Per-(slot, stage) queue delay in slots — the stage's total backlog
        # over its fleet-wide service capacity — histogrammed per stage over
        # the horizon.
        cap_stage = mu_stage_all.sum(dim=(-3, -2))                 # (..., T, S)
        delay = stage_backlog / torch.clamp_min(cap_stage, _EPS)
        metrics["queue_delay"] = delay
        metrics["queue_delay_hist"] = hist_series(telemetry.hist, delay, axis=-2)   # (..., S, B)
    return outs, TelemetryFrame(ring=_stacked_ring(batch, dev), metrics=metrics)


def simulate_staged_many(
    build_inputs: Callable[[torch.Generator, int], SimInputs],
    dag: StageDag,
    wan: WanModel,
    policy: PolicyFn,
    generator: torch.Generator,
    n_runs: int,
    scalar: float | Tensor = 0.0,
    telemetry: TelemetryConfig | None = None,
    health: Tensor | None = None,
    link_health: Tensor | None = None,
    device=None,
    mesh=None,
) -> StagedOutputs | tuple[StagedOutputs, TelemetryFrame]:
    """Monte-Carlo replication of :func:`simulate_staged`: fresh stochastic
    traces + policy randomness per run, all runs in one batched simulation.

    ``build_inputs(generator, n_runs)`` draws the stacked (R, ...) arrivals
    and service rates; the deterministic traces (prices, PUE, the dag, the
    WAN model — and the degraded-mode health/link traces, when given) are
    shared. ``device=None`` means CUDA; the generator and the built inputs
    must live there. Telemetry frames carry the runs axis.

    ``mesh`` (:func:`repro_torch.distributed.mesh.runs_mesh`) runs the runs
    axis in chunks after the one draw, bitwise the unchunked call; it also
    bounds the memory a call holds, the degraded-link bill's (..., K, N, N)
    plans included. A policy that consumes the generator raises there.
    """
    inputs = build_runs(build_inputs, generator, n_runs, device)
    refuse_generator_in_chunks(policy, mesh, "simulate_staged_many")
    return sharded_runs(
        lambda sel: simulate_staged(take_runs_inputs(inputs, sel), dag, wan, policy, generator,
                                    take_runs_scalar(scalar, sel, n_runs), telemetry, health,
                                    link_health),
        n_runs, mesh)


def summarize_staged(outs: StagedOutputs) -> dict:
    """Time-averaged scalars incl. the shuffle WAN bill (any runs axis).

    The total includes the speculative re-execution bill (zero for
    hedge-free runs).
    """
    compute = outs.cost.mean()
    wan = outs.wan_cost.mean()
    hedge = outs.hedge_cost.mean()
    return {
        "time_avg_compute_cost": float(compute),
        "time_avg_wan_cost": float(wan),
        "time_avg_hedge_cost": float(hedge),
        "time_avg_total_cost": float(compute + wan + hedge),
        "time_avg_energy": float(outs.energy.mean()),
        "time_avg_backlog": float(outs.backlog_avg.mean()),
        "total_wan_gb": float(outs.wan_gb.sum(dim=-1).mean()),
        "jobs_completed": float(outs.completed.sum(dim=(-2, -1)).mean()),
        "hedged_jobs": float(outs.hedged_jobs.sum(dim=-1).mean()),
        "final_backlog_total": float(outs.q_final.sum(dim=(-3, -2, -1)).mean()),
    }
