"""Joint manager selection & stage placement (per-slot decision rules).

Extends GMSA's LP-vertex trick (:mod:`repro_torch.core.gmsa`) from one
decision per job type to one decision per *stage*: the map stage is pinned
to ``data_dist`` locality (the GDA premise — map tasks run where the data
lives, nothing crosses the WAN), and every downstream stage's site is
chosen by a drift-plus-penalty score that includes the intermediate-data
WAN energy term the base algorithm routes implicitly but never bills:

    score[k, s, i] = F^{k,s} * ( Q_i^{k,s} - mu_i^{k,s}
                                 + V * [ c^{k,s} e_i^k  +  G^{k,s} w_i^{k,s} ] )

with ``F`` the flow entering the stage this slot, ``c`` the stage compute
intensity, ``G`` the stage's shuffle volume, and
``w_i = sum_{j != i} src_j * price[j, i]`` the expected $-per-GB of
pulling the upstream output mix ``src`` to site i, priced exactly as
:func:`repro_torch.placement.wan.transfer_cost` bills it. For one-hot
decisions the score's WAN term equals the engine's bill to the byte, so the
argmin vertex remains the exact LP optimum of the per-stage relaxation.

Because downstream shuffle sources depend on upstream completions, the
policy replicates the engine's within-slot flow propagation
(:func:`flow_step` — the single definition shared with
:mod:`repro_torch.jobs.engine`) stage by stage: decide f^{k,0}, advance the
flow, decide f^{k,1} against the realized source mix, and so on.

``stage_oblivious`` adapts any base simulator policy (GMSA, the
``gmsa_score`` kernel policy, DATA, RANDOM, JSQ, GREEDY-COST) to the staged
engine: one manager choice per type from the aggregate backlog, applied to
every stage — the current, shuffle-blind dispatch the benchmarks compare
against.

Every function takes the Monte-Carlo batch as leading dims on its per-run
operands (q, arrivals, mu and what derives from them); axes are negative
throughout. Ties go to the lowest index (``torch.argmin``/``argmax``).
"""

from __future__ import annotations

import torch
from torch import Tensor

from repro_torch.core.baselines import _one_hot_nk
from repro_torch.core.gmsa import drift_plus_penalty_scores
from repro_torch.core.reduce import run_sum
from repro_torch.jobs.dag import StageDag
from repro_torch.placement.wan import WanModel, expected_pull

_EPS = 1e-12


def stage_service_rates(mu: Tensor, dag: StageDag) -> Tensor:
    """(..., N, K, S) effective per-stage service rates.

    A stage with compute intensity c occupies a server c job-units per
    completion, so the base (..., N, K) service-rate trace stretches to
    ``mu / c`` per stage. Padded stages carry intensity 1.0 (exact
    identity — the single-stage dag reproduces ``mu`` bit for bit).
    """
    return mu[..., None] / dag.compute


#: (..., T, N, K, S) per-stage service rates for a whole trace in one op:
#: the reference's hoisted name for the same ``mu / c`` divide, which takes
#: any leading dims here.
stage_service_rates_all = stage_service_rates


def flow_step(q_s: Tensor, f_s: Tensor, total_in: Tensor, mu_s: Tensor) -> tuple[Tensor, Tensor]:
    """Within-slot flow through one stage: completions and their locations.

    Stage s receives ``f_s * total_in`` on top of backlog ``q_s`` and
    serves at most ``mu_s`` — completions this slot are
    ``min(q_s + f_s * total_in, mu_s)`` (the served mass of Eq. 1's max).
    The single definition shared by the engine's billing and the
    stage-aware policy's lookahead, so the score's source mix is exactly
    the mix the engine bills.

    Args:
        q_s, f_s, mu_s: (..., N, K); total_in: (..., K).

    Returns:
        (total_done, src): (..., K) completions leaving the stage and their
        (..., K, N) site distribution (uniform fallback for zero flow — the
        downstream volume is zero there, so the choice is billing-inert).
    """
    n = q_s.shape[-2]
    done = torch.minimum(q_s + f_s * total_in.unsqueeze(-2), mu_s)    # (..., N, K)
    total_done = run_sum(done, -2)                                     # (..., K)
    tot = total_done[..., None]
    src = torch.where(tot > _EPS, done.mT / torch.clamp_min(tot, _EPS), 1.0 / n)
    return total_done, src


def staged_stage_scores(
    q_s: Tensor,
    total_in: Tensor,
    mu_s: Tensor,
    e: Tensor,
    compute_s: Tensor,
    shuffle_gb_s: Tensor,
    pull: Tensor,
    v: float | Tensor,
) -> Tensor:
    """(..., K, N) drift-plus-penalty scores for one stage's site choice.

    The base GMSA score (:func:`repro_torch.core.gmsa.drift_plus_penalty_scores`)
    with the per-job penalty extended by the stage's WAN pull term:
    ``e_stage[k, i] = compute_s[k] * e[k, i] + shuffle_gb_s[k] * pull[k, i]``
    where ``pull[k, i] = sum_j src[k, j] * price[j, i]`` — computed fused by
    :func:`repro_torch.placement.wan.expected_pull`.
    """
    e_stage = compute_s[:, None] * e + shuffle_gb_s[:, None] * pull
    return drift_plus_penalty_scores(q_s, total_in, mu_s, e_stage, v)


def hedge_clone_choice(
    f_s: Tensor, mu_s: Tensor, stage_mask_s: Tensor, hedge: float
) -> tuple[Tensor, Tensor]:
    """Speculative re-execution decision for one stage: clone site + boost.

    The straggler signal is *relative*: the dispatched sites' effective
    service rate ``mu_p = Σ_n f·mu`` against the best alternative site
    ``r = argmax_n mu·(1 - f)``. The hedge fires when ``mu_p < hedge·mu_r``
    and the stage is active: the stage is then cloned at r, and its drain
    rate rises by the clone's rate — ``mu_eff = mu + f·boost`` with
    ``boost = mu_r`` where the hedge fired, 0 elsewhere (an exact ``+ 0.0``
    identity when nothing fires).

    Args:
        f_s, mu_s: (..., N, K); stage_mask_s: (K,).

    Returns:
        (g_s, boost): the (..., N, K) one-hot clone matrix (zero columns
        where the hedge did not fire) and the (..., K) rate boost.
    """
    n = f_s.shape[-2]
    mu_p = (f_s * mu_s).sum(dim=-2)                                    # (..., K)
    alt = mu_s * (1.0 - f_s)                                           # (..., N, K)
    r_hot = _one_hot_nk(torch.argmax(alt, dim=-2), n, f_s.dtype)       # (..., N, K)
    mu_r = (r_hot * mu_s).sum(dim=-2)                                  # (..., K)
    fire = ((mu_p < hedge * mu_r) & (stage_mask_s > 0.0)).to(f_s.dtype)
    return r_hot * fire.unsqueeze(-2), mu_r * fire


def make_staged_policy(dag: StageDag, wan: WanModel, pin_map: bool = True,
                       hedge: float | None = None):
    """Stage-aware GMSA: per-stage LP-vertex dispatch with WAN pricing.

    Returns a policy with the staged signature
    ``(generator, q, arrivals, mu, e, aux, scalar) -> (f, in_stack)`` where
    ``q``/``f`` are (..., N, K, S), ``in_stack`` (..., K, S) the per-stage
    inflows, and ``aux = (data_dist, wpue)``; V rides in as ``scalar``
    exactly as in :func:`repro_torch.core.gmsa.gmsa_policy`.

    Args:
        dag: the stage chain.
        wan: WAN model pricing the shuffle pulls.
        pin_map: pin stage 0 to ``data_dist`` (data-local map). When
            False, stage 0 is score-chosen like any other stage.
        hedge: speculative re-execution threshold (``None`` disables).
            When set, each stage whose dispatched service rate falls below
            ``hedge`` times the runner-up site's rate is cloned there
            (:func:`hedge_clone_choice`), the flow walk runs on the boosted
            rates, and the policy additionally returns the (..., N, K, S)
            clone matrix (``returns_hedge`` contract of ``simulate_staged``).
    """

    def policy(generator, q, arrivals, mu, e, aux, scalar):
        del generator
        data_dist, wpue = aux[0], aux[1]
        n = q.shape[-3]
        lead = q.shape[:-1]                                        # (..., N, K)
        mu_stages = stage_service_rates(mu, dag)                   # (..., N, K, S)
        total_in = arrivals                                        # (..., K)
        src = data_dist                                            # (..., K, N)
        cols, ins, clones = [], [], []
        for s in range(dag.s_max):
            mu_s = mu_stages[..., s]
            if s == 0 and pin_map:
                f_s = data_dist.mT.expand(lead)                    # (..., N, K)
            else:
                # Fused expected-pull pricing; src is on the simplex by the
                # flow_step contract.
                pull = expected_pull(src, wpue, assume_simplex=True) * wan.energy_per_gb
                scores = staged_stage_scores(
                    q[..., s], total_in, mu_s, e,
                    dag.compute[:, s], dag.shuffle_gb[:, s], pull, scalar,
                )                                                  # (..., K, N)
                f_s = _one_hot_nk(torch.argmin(scores, dim=-1), n, q.dtype)
            cols.append(f_s)
            ins.append(total_in.expand(lead[:-2] + lead[-1:]))
            if hedge is not None:
                # Clone stragglers to the runner-up and walk the flow on the
                # boosted rates — the engine re-derives the identical boost
                # from g, so the exported inflows replay exactly.
                g_s, boost = hedge_clone_choice(f_s, mu_s, dag.stage_mask[:, s], hedge)
                clones.append(g_s)
                mu_s = mu_s + f_s * boost.unsqueeze(-2)
            total_done, src = flow_step(q[..., s], f_s, total_in, mu_s)
            if s + 1 < dag.s_max:
                total_in = total_done * dag.stage_mask[:, s + 1]
        # The lookahead walked the exact within-slot flow the engine would
        # re-derive (flow_step is the shared definition), so export the
        # per-stage inflows and let the engine skip its own recursion.
        f = torch.stack(cols, dim=-1)
        in_stack = torch.stack(ins, dim=-1)                        # (..., K, S)
        if hedge is not None:
            return f, in_stack, torch.stack(clones, dim=-1)
        return f, in_stack

    policy.staged = True
    policy.consumes_key = False
    policy.returns_flow = True
    policy.returns_hedge = hedge is not None
    return policy


def staged_dispatch_fn(dag: StageDag, wan: WanModel, v: float,
                       pin_map: bool = True, hedge: float | None = None):
    """:func:`make_staged_policy` binding a fixed V (the ``scalar`` is ignored)."""
    base = make_staged_policy(dag, wan, pin_map=pin_map, hedge=hedge)

    def policy(generator, q, arrivals, mu, e, aux, scalar):
        del scalar
        return base(generator, q, arrivals, mu, e, aux, v)

    policy.staged = True
    policy.consumes_key = False
    policy.returns_flow = True
    policy.returns_hedge = hedge is not None
    return policy


def stage_oblivious(policy, pin_map: bool = False):
    """Adapt a base simulator policy to the staged engine, shuffle-blind.

    The base policy sees the aggregate backlog ``sum_s Q`` and the plain
    per-job cost table — exactly what it sees in ``simulate`` — and its
    (..., N, K) decision applies to *every* stage: the job follows its
    manager, no per-stage queues, no WAN term. With a single-stage dag it
    reproduces ``simulate``'s dispatch and queues bit for bit.

    Args:
        policy: any base policy ``(generator, q(..., N, K), arrivals, mu, e,
            aux, scalar) -> f(..., N, K)``. Policies declaring
            ``wants_wpue = True`` (the ``gmsa_score`` kernel dispatch of
            :func:`repro_torch.core.gmsa.make_kernel_policy`) receive
            ``(data_dist, omega*PUE)``, exactly as
            :func:`repro_torch.core.simulator.simulate` hands it to them;
            those also declaring ``wants_r = True`` get the engine's
            ``(data_dist, wpue, r_t)`` triple verbatim. Other policies get
            ``data_dist``.
        pin_map: override stage 0 with data-local map placement (used when
            benchmarking against stage-aware policies under the same
            data-local-map premise; keep False for exact base semantics).
    """
    wants_wpue = getattr(policy, "wants_wpue", False)
    wants_r = getattr(policy, "wants_r", False)

    def staged(generator, q, arrivals, mu, e, aux, scalar):
        data_dist = aux[0]
        if wants_r:
            base_aux = aux                 # (data_dist, wpue, r_t) verbatim
        elif wants_wpue:
            base_aux = (data_dist, aux[1])
        else:
            base_aux = data_dist
        q_total = q.sum(dim=-1)                                    # (..., N, K)
        f_base = policy(generator, q_total, arrivals, mu, e, base_aux, scalar)
        s_max = q.shape[-1]
        f = f_base.unsqueeze(-1).expand(f_base.shape + (s_max,))
        if pin_map:
            local = data_dist.mT.unsqueeze(-1)                     # (..., N, K, 1)
            lead = torch.broadcast_shapes(f.shape[:-1], local.shape[:-1])
            f = torch.cat([local.expand(lead + (1,)), f[..., 1:].expand(lead + (s_max - 1,))],
                          dim=-1)
        return f

    staged.staged = True
    staged.state_independent = getattr(policy, "state_independent", False)
    staged.consumes_key = getattr(policy, "consumes_key", True)
    staged.wants_r = wants_r
    staged.static_r = getattr(policy, "static_r", False)
    return staged
