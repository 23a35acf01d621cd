"""Two-timescale placement controller: slow re-placement x fast GMSA dispatch.

The fast loop is the paper's per-slot GMSA (or any simulator policy); the
slow loop fires every ``epoch_slots`` (W) slots and may re-place / replicate
the datasets across sites under a WAN transfer-cost model and per-site
storage caps, after which the Iridium ratio tensor ``r`` is re-derived for
the new layout. Here both loops are Python loops — epochs, then the epoch's
W slots — and every Monte-Carlo run steps at once: the per-run state
(backlogs, layouts, ratios) carries the inputs' leading runs axis, so after
the first boundary each run holds its own (K, N) layout and (K, N, N)
ratios, and the ``gmsa_score`` kernel takes them per run in one launch.

Epoch 0 always runs the *given* placement untouched (no move, no rebuild),
so with ``W >= T`` the controller degenerates to a single epoch and
``simulate_placed`` reproduces plain ``simulate`` bit for bit.

Exogenous dataset drift enters through an optional per-epoch ``ingest``
trace; the controller observes the drifted layout and corrects it within
its per-epoch move budget, paying for every byte through
:mod:`repro_torch.placement.wan`.

Site loss enters through an optional per-slot ``alive`` mask, shared by
every run. Its death and revival edges are found once on the host before
the loop; on a death edge the controller runs an immediate off-schedule
recovery epoch — ``drop_site`` semantics via
:func:`repro_torch.checkpoint.fault.drop_site_mask`: the dead sites'
backlog re-injects as an arrival burst, their dataset share re-replicates
over the survivors, the slow rule re-places restricted to survivors, and the
emergency WAN burst is billed into ``PlacedOutputs.recovery_cost``. The
heavy branch is a host ``if`` on the edge, so it runs only on the slots
where a site dies, and no slot reads the device to decide. Every masking op
on the fault path is an exact identity when every site is alive (``* 1.0``,
``+ 0.0``, a select), so an all-ones mask reproduces the no-fault outputs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
from torch import Tensor

from repro_torch.checkpoint.fault import drop_site_mask
from repro_torch.core.iridium import make_allocation_rebuilder
from repro_torch.core.simulator import (
    PolicyFn,
    SimInputs,
    _scalar_for,
    _stacked_ring,
    build_runs,
    energy_row,
    refuse_generator_in_chunks,
    slot_step,
    take_runs_inputs,
    take_runs_scalar,
)
from repro_torch.device import as_float32
from repro_torch.distributed.mesh import sharded_runs
from repro_torch.placement.replica import replica_read_assignment
from repro_torch.placement.replica import sync_cost as replica_sync_cost
from repro_torch.placement.wan import (
    DEFAULT_ENERGY_PER_GB,
    degraded_surcharge,
    evacuation_cost,
    evacuation_plan,
    plan_cost,
    transfer_cost,
    transfer_latency,
    transfer_plan,
    wan_topology,
)
from repro_torch.telemetry.config import TelemetryConfig
from repro_torch.telemetry.config import enabled as _tel_enabled
from repro_torch.telemetry.config import histograms as _tel_hist
from repro_torch.telemetry.config import tracing as _tel_tracing
from repro_torch.telemetry.metrics import hist_series
from repro_torch.telemetry.ring import (
    EV_EPOCH,
    EV_INGEST_REDIRECT,
    EV_RECOVERY,
    EV_REPAIR,
    TelemetryFrame,
    ring_push,
)
from repro_torch.traces.datasets import io_slowdown_from_bandwidth
from repro_torch.traces.faults import failure_edges, repair_edges

_EPS = 1e-12


def survivor_renorm(masked: Tensor, fallback: Tensor, axis: int = -1) -> Tensor:
    """Renormalize a survivor-masked distribution back onto the simplex.

    ``masked`` is a distribution with dead sites already zeroed; rows whose
    mass sat entirely on dead sites are degenerate (zero sum) and take
    ``fallback`` instead. The single definition behind every
    mask-then-renormalize site in the fault path.
    """
    total = masked.sum(dim=axis, keepdim=True)
    return torch.where(total > _EPS, masked / torch.clamp_min(total, _EPS), fallback)


def region_averse_weights(alive: Tensor, regions: Tensor) -> Tensor:
    """Survivor weights that shy away from regions already seeing deaths.

    Each survivor's weight is ``alive * (1 - dead_fraction_of_its_region)``,
    computed with the O(N^2) same-region mask. With every site alive the
    dead fraction is zero and the weights are exactly ``alive``; a
    survivor's weight stays strictly positive.
    """
    regions = torch.as_tensor(regions, device=alive.device)
    same = (regions[:, None] == regions[None, :]).to(alive.dtype)
    dead_frac = (same @ (1.0 - alive)) / torch.clamp_min(same.sum(dim=1), 1.0)
    return alive * (1.0 - dead_frac)


@dataclasses.dataclass(frozen=True)
class PlacementConfig:
    """Static knobs of the two-timescale controller (frozen, hashable).

    Attributes:
        epoch_slots: W — slow-loop period in slots. The horizon T must be a
            multiple of min(W, T).
        move_budget: alpha in [0, 1] — per epoch, the placement moves at
            most this fraction of the way from the current layout to the
            rule's target (bounds the WAN burst per epoch).
        dataset_gb: per-type dataset sizes in GB (scalar broadcasts).
        capacity_gb: per-site storage caps in GB, or ``None`` = uncapped.
        energy_per_gb: WAN energy per GB (job-energy equivalents).
        growth: fraction of each dataset that is fresh ingest per epoch
            (only effective when an ``ingest`` trace is supplied).
        update_fraction: share of each dataset that every replica beyond the
            first must absorb as sync updates per epoch (the replication
            premium of :func:`repro_torch.placement.replica.sync_cost`).
        io_coupling: thread the *evolving* placement into the per-slot
            service rates: each epoch's mu is scaled by the current layout's
            I/O slowdown (:func:`repro_torch.traces.datasets
            .io_slowdown_from_bandwidth`) relative to the epoch-0 layout the
            mu trace was calibrated against. A recovery re-placement inside
            an epoch re-derives the scale per slot from the carried layout.
        io_compute_seconds / io_job_gb: the slowdown model's per-job
            compute time and intermediate pull volume.
        io_per_reader: resolve the I/O slowdown from the *actual*
            per-reader replica choices
            (:func:`repro_torch.placement.replica.replica_read_assignment`):
            the slowdown becomes (N, K) and scales mu per type.
        size / manager_share / map_share: Iridium rebuild parameters. Pass
            the inputs' own shares (e.g. ``facebook_4dc``'s
            manager_share=0.62) or the cost series jumps at the first
            rebuild for non-placement reasons.
    """

    epoch_slots: int = 48
    move_budget: float = 0.5
    dataset_gb: float | tuple = 100.0
    capacity_gb: tuple | None = None
    energy_per_gb: float = DEFAULT_ENERGY_PER_GB
    growth: float = 0.0
    update_fraction: float = 0.01
    io_coupling: bool = False
    io_compute_seconds: float = 300.0
    io_job_gb: float = 5.0
    io_per_reader: bool = False
    size: float = 1.0
    manager_share: float = 0.3
    map_share: float = 0.6


class SlowObs(NamedTuple):
    """What the slow-timescale rule sees at an epoch boundary.

    Prices/PUE are the *upcoming* epoch's averages. ``mu_bar`` and ``q``
    carry the runs' leading dimensions; the rest is shared.
    """

    wpue_bar: Tensor     # (N,)   epoch-average omega * PUE
    mu_bar: Tensor       # (..., N, K) epoch-average service rates
    q: Tensor            # (..., N, K) backlogs at the boundary
    sizes_gb: Tensor     # (K,)   dataset sizes this epoch
    capacity_gb: Tensor  # (N,)   storage caps
    alive: Tensor | None = None  # (N,) {0,1} survivors; None = no fault model


#: rule(d_current, obs) -> d_target, both (..., K, N) row-stochastic.
PlacementRule = Callable[[Tensor, SlowObs], Tensor]


class PlacedOutputs(NamedTuple):
    """Per-slot outputs plus the slow-loop audit trail, each with the
    inputs' leading runs dimensions."""

    cost: Tensor            # (..., T) per-slot dispatch energy cost
    energy: Tensor          # (..., T)
    backlog_total: Tensor   # (..., T)
    backlog_avg: Tensor     # (..., T)
    q_final: Tensor         # (..., N, K)
    f_trace: Tensor         # (..., T, N, K)
    placements: Tensor      # (..., E, K, N) layout in force during each epoch
    r_trace: Tensor         # (..., E, K, N, N) ratio tensor per epoch
    wan_cost: Tensor        # (..., E) $ spent moving data at each boundary
    wan_energy: Tensor      # (..., E) WAN energy (job-equivalents)
    wan_gb: Tensor          # (..., E) GB crossing the WAN
    wan_latency_s: Tensor   # (..., E) bottleneck completion time of each move
    sync_cost: Tensor       # (..., E) $ replication sync premium per epoch
    recovery_cost: Tensor   # (..., T) $ emergency WAN burst on site-loss edges
    recovery_gb: Tensor     # (..., T) GB evacuated/re-replicated on those edges
    mu_scale: Tensor        # (..., E, N) I/O service-rate scale per epoch (ones
                            # unless cfg.io_coupling)


def _per_run_r(r: Tensor, batch: tuple[int, ...]) -> Tensor:
    """A ratio tensor whose leading dims broadcast to ``batch`` without
    filling it (a sweep lane's (B, 1, K, N, N)) becomes one contiguous
    tensor per run, once, so the kernel reads it as a per-run r."""
    if r.ndim > 3 and tuple(r.shape[:-3]) != batch:
        return r.expand(batch + tuple(r.shape[-3:])).contiguous()
    return r


def _per_run_matmul(r: Tensor, w: Tensor) -> Tensor:
    """``Σ_j r[..., k, i, j] · w[t, j]`` -> (..., T, K, N) for a ratio tensor
    with leading run dimensions, as one batched product per run (``bmm``):
    each run's arithmetic is then the same whatever the number of runs,
    where an einsum folds the runs into one matmul whose kernel, and sum
    order, may change with it."""
    lead, (k, n) = r.shape[:-3], r.shape[-3:-1]
    rr = r.reshape(-1, k * n, n)
    out = torch.bmm(rr, w.mT.expand(rr.shape[0], n, w.shape[0]))
    return out.reshape(lead + (k, n, w.shape[0])).movedim(-1, -3)


def epoch_energy_tables(
    r: Tensor, wpue: Tensor, pue: Tensor, p_it: Tensor
) -> tuple[Tensor, Tensor]:
    """(..., W, K, N) dispatch-cost and raw-energy tables of one epoch's W
    slots: ``r`` is the shared (K, N, N) ratio tensor or one per run,
    (..., K, N, N) (:func:`_per_run_matmul`);
    ``wpue`` / ``pue`` are (W, N). On a shared r these are the simulator's
    ``energy_tables``, bitwise."""
    if r.ndim > 3:
        e_cost, e_raw = _per_run_matmul(r, wpue), _per_run_matmul(r, pue)
    else:
        e_cost = torch.einsum("...kij,tj->...tki", r, wpue)
        e_raw = torch.einsum("...kij,tj->...tki", r, pue)
    return e_cost * p_it[:, None], e_raw * p_it[:, None]


def simulate_placed(
    inputs: SimInputs,
    up: Tensor,
    down: Tensor,
    policy: PolicyFn,
    rule: PlacementRule,
    generator: torch.Generator | None,
    cfg: PlacementConfig,
    scalar: float | Tensor = 0.0,
    ingest: Tensor | None = None,
    sizes_gb: Tensor | None = None,
    alive: Tensor | None = None,
    move_budget: Tensor | None = None,
    telemetry: TelemetryConfig | None = None,
    health: Tensor | None = None,
    link_health: Tensor | None = None,
    regions: Tensor | None = None,
) -> PlacedOutputs | tuple[PlacedOutputs, TelemetryFrame]:
    """Run the two-timescale controller over a trace bundle, every run at once.

    Args:
        inputs: the usual trace bundle; ``arrivals``/``mu`` may carry
            leading run dimensions, ``data_dist`` must be the static (K, N)
            form (it becomes the epoch-0 layout) and ``r`` the static
            (K, N, N) form (used verbatim for epoch 0).
        up/down: (N,) site bandwidths — feed both the WAN transfer model
            and the per-epoch Iridium rebuild (pass the ones ``r`` was
            built from).
        policy: fast-loop dispatch policy (simulator signature).
        rule: slow-loop placement rule, e.g.
            :func:`repro_torch.placement.replica.make_adaptive_rule` or
            :func:`repro_torch.core.baselines.static_placement_rule`.
        generator: feeds the policy's randomness (RANDOM); passed only to
            policies that consume it.
        cfg: static controller knobs.
        scalar: control parameter forwarded to the policy (GMSA's V).
        ingest: optional (E, K, N) exogenous ingest distributions; mixed in
            with weight ``cfg.growth`` at every boundary after epoch 0.
        sizes_gb: optional (E, K) per-epoch dataset sizes (growth trace);
            defaults to ``cfg.dataset_gb`` for all epochs.
        alive: optional (T, N) per-slot {0,1} site-alive mask. On each death
            edge the controller runs an off-schedule recovery epoch; dead
            sites receive no dispatch and serve nothing while down.
        move_budget: optional tensor override of ``cfg.move_budget``: 0-d,
            or the batch's leading dims followed by ones — a (B, 1) column
            against a (B, R) batch is how
            :func:`repro_torch.core.sweep.sweep_placed_budgets` runs a whole
            move-budget sweep in one loop. ``None`` uses the config value.
        telemetry: flight-recorder config. ``None``/``OFF`` runs exactly
            the operations of the controller without telemetry. SUMMARY
            adds the per-slot per-site backlog stream (and, with a histogram
            spec, per-site bill histograms); TRACE also records every epoch
            boundary, recovery epoch, revival edge and ingest redirect in a
            per-run event ring. Enabled levels return ``(outputs,
            TelemetryFrame)``.
        health: optional (T, N) per-slot site health factor in [0, 1]; it
            scales the service rates before the loop (all-ones is exact).
        link_health: optional (T, N, N) per-link WAN health factor:
            degraded links surcharge every boundary move and stretch its
            latency; on a recovery edge the evacuation routes around
            severed links and bills the degraded premium.
        regions: optional (N,) int region assignment; requires ``alive``.
            Survivor renormalization becomes shared-fate averse.
    """
    tel_on = _tel_enabled(telemetry)
    tel_trace = _tel_tracing(telemetry)
    tel_hist = _tel_hist(telemetry)
    t_slots, k_types = inputs.arrivals.shape[-2:]
    batch = tuple(inputs.arrivals.shape[:-2])
    n = inputs.mu.shape[-2]
    dev = inputs.arrivals.device
    f32 = torch.float32
    if inputs.data_dist.ndim != 2 or inputs.r.ndim != 3:
        raise ValueError("simulate_placed owns the time axis: pass static "
                         "(K, N) data_dist and (K, N, N) r")
    w = min(cfg.epoch_slots, t_slots)
    if t_slots % w != 0:
        raise ValueError(f"T={t_slots} must be a multiple of W={w}")
    n_epochs = t_slots // w

    if health is not None:
        health = torch.as_tensor(health, dtype=f32, device=dev)
        if tuple(health.shape) != (t_slots, n):
            raise ValueError(f"health must be (T={t_slots}, N={n}), "
                             f"got {tuple(health.shape)}")
        # Stragglers serve slower everywhere downstream; all-ones is * 1.0.
        inputs = inputs._replace(mu=inputs.mu * health[:, :, None].to(inputs.mu.dtype))
    linky = link_health is not None
    if linky:
        link_health = torch.as_tensor(link_health, dtype=f32, device=dev)
        if tuple(link_health.shape) != (t_slots, n, n):
            raise ValueError(
                f"link_health must be (T={t_slots}, N={n}, N={n}), "
                f"got {tuple(link_health.shape)}"
            )
    if regions is not None and alive is None:
        raise ValueError("regions requires an alive mask (shared-fate "
                         "aversion only matters under site loss)")

    faulty = alive is not None
    if faulty:
        alive = torch.as_tensor(alive, dtype=f32, device=dev)
        if tuple(alive.shape) != (t_slots, n):
            raise ValueError(f"alive mask must be (T={t_slots}, N={n}), "
                             f"got {tuple(alive.shape)}")
        # Slot 0 compares against an all-alive fleet, so a trace that
        # starts dead fires its death edge (and recovery) at t=0. The edges
        # are read on the host once: the loop branches on them, never on
        # the device.
        alive_prev = torch.cat([torch.ones((1, n), dtype=f32, device=dev), alive[:-1]], dim=0)
        host_alive = alive.cpu()
        died_h = failure_edges(host_alive).bool().any(dim=1).tolist()
        revived_h = repair_edges(host_alive).bool().any(dim=1).tolist()
        dead_h = (host_alive < 0.5).any(dim=1).tolist()
        dead_prev_h = [False] + dead_h[:-1]
        regions = None if regions is None else torch.as_tensor(regions, device=dev)

    up = as_float32(up, dev)
    down = as_float32(down, dev)
    wan = wan_topology(up, down, cfg.energy_per_gb)
    rebuild = make_allocation_rebuilder(
        up, down, size=cfg.size,
        manager_share=cfg.manager_share, map_share=cfg.map_share,
    )
    cap = (
        torch.full((n,), torch.inf, dtype=f32, device=dev)
        if cfg.capacity_gb is None
        else torch.as_tensor(cfg.capacity_gb, dtype=f32, device=dev)
    )
    if sizes_gb is None:
        sizes_gb = torch.as_tensor(cfg.dataset_gb, dtype=f32, device=dev).broadcast_to(
            (n_epochs, k_types))
    sizes_gb = torch.as_tensor(sizes_gb, dtype=f32, device=dev)
    if ingest is not None:
        ingest = torch.as_tensor(ingest, dtype=f32, device=dev)
    scalar = _scalar_for(scalar, batch, dev)
    if move_budget is None:
        mb = cfg.move_budget
    else:
        mb = _scalar_for(move_budget, batch, dev)
        mb = mb.reshape(tuple(mb.shape) + (1, 1))                   # against (..., K, N)
    p_it = inputs.p_it

    state_ind = getattr(policy, "state_independent", False)
    wants_wpue = getattr(policy, "wants_wpue", False)
    wants_r = getattr(policy, "wants_r", False)
    if getattr(policy, "static_r", False):
        raise ValueError(
            "the controller re-derives r at every epoch boundary (and "
            "recovery edge) — a policy binding a static ratio tensor would "
            "dispatch on stale ratios; build it with "
            "make_kernel_policy(r=None) so the carried r reaches the kernel."
        )
    gen = generator if getattr(policy, "consumes_key", True) else None

    q = torch.zeros(batch + (n, k_types), dtype=f32, device=dev)
    d = torch.as_tensor(inputs.data_dist, dtype=f32)
    d0 = d
    r0 = inputs.r
    if cfg.io_coupling:
        if cfg.io_per_reader:
            ones_n = torch.ones((n,), dtype=f32, device=dev)

            def io_slow(dd):
                # The read pattern's diagonal (local vs remote) is price-
                # invariant — local reads are free — so a constant wpue
                # yields the actual per-reader local/remote choices.
                reads = replica_read_assignment(dd, wan, ones_n)
                return io_slowdown_from_bandwidth(
                    up, down, dd, cfg.io_compute_seconds, cfg.io_job_gb, reads=reads,
                )                                                    # (..., N, K)
        else:

            def io_slow(dd):
                return io_slowdown_from_bandwidth(
                    up, down, dd, cfg.io_compute_seconds, cfg.io_job_gb
                )                                                    # (..., N)

        # The mu trace is calibrated against the epoch-0 layout; the
        # coupling rescales it by the current layout's I/O slowdown.
        slow0 = io_slow(d0)

    ring = _stacked_ring(batch, dev, telemetry.capacity) if tel_trace else None
    full = lambda x, tail: x.expand(batch + tail)
    zero_b = torch.zeros(batch, dtype=f32, device=dev)
    cols, ep_cols = [], []
    for e in range(n_epochs):
        sl = slice(e * w, (e + 1) * w)
        arr_e, mu_e = inputs.arrivals[..., sl, :], inputs.mu[..., sl, :, :]
        om_e, pu_e = inputs.omega[sl], inputs.pue[sl]
        size_e = sizes_gb[e]
        if faulty:
            # Aliveness *entering* the epoch drives the boundary decision;
            # deaths inside the epoch are handled by the slot-level edges.
            alive_b = alive_prev[e * w]                               # (N,)
            any_dead_b = dead_prev_h[e * w]

        # -- slow timescale: drift, observe, re-place, pay the WAN bill.
        if ingest is not None and e > 0:
            g = torch.tensor(cfg.growth, dtype=f32, device=dev)
            ing_e = ingest[e]
            if faulty and any_dead_b:
                # Ingest cannot land at dead sites; it redirects to the
                # survivors (a row aimed entirely at dead sites spreads
                # uniformly over them).
                n_alive_b = torch.clamp_min(alive_b.sum(), 1.0)
                unif_b = (alive_b / n_alive_b).broadcast_to(ing_e.shape)
                ing_e_used = survivor_renorm(ing_e * alive_b[None, :], unif_b, axis=-1)
            else:
                ing_e_used = ing_e
            drifted = (1.0 - g) * d + g * ing_e_used
            d_drift = drifted / torch.clamp_min(drifted.sum(dim=-1, keepdim=True), _EPS)
        else:
            d_drift = d
        wpue_e = om_e * pu_e                                          # (W, N)
        wpue_bar = wpue_e.mean(dim=0)
        if e == 0:
            # Epoch 0 runs the given layout and ratios verbatim.
            d_new, target = d, d
        else:
            if cfg.io_coupling:
                # The rule observes service under the *drifted* layout (its
                # decision input); the realized scale follows its choice.
                scale_obs = io_slow(d_drift) / slow0
                if not cfg.io_per_reader:
                    scale_obs = scale_obs[..., None]
                mu_bar = mu_e.mean(dim=-3) * scale_obs
            else:
                mu_bar = mu_e.mean(dim=-3)
            if faulty:
                mu_bar = mu_bar * alive_b[:, None]   # dead sites serve nothing
            obs = SlowObs(
                wpue_bar=wpue_bar, mu_bar=mu_bar, q=q, sizes_gb=size_e,
                capacity_gb=cap, alive=alive_b if faulty else None,
            )
            target = rule(d_drift, obs)
            if faulty and any_dead_b:
                # Survivor-only targets whatever the plugged-in rule does;
                # with regions the weights are shared-fate averse too.
                surv_b = (alive_b if regions is None
                          else region_averse_weights(alive_b, regions))
                target = survivor_renorm(target * surv_b[None, :], d_drift, axis=-1)
            stepped = d_drift + mb * (target - d_drift)
            d_new = stepped / torch.clamp_min(stepped.sum(dim=-1, keepdim=True), _EPS)
        # Fused billing; the plan is materialized once per boundary for the
        # bottleneck latency, which needs the per-link bytes.
        wan_c, wan_e, wan_gb = plan_cost(d_drift, d_new, size_e, wan, om_e[0], pu_e[0])
        plan = transfer_plan(d_drift, d_new, size_e)
        if linky:
            lh_b = link_health[e * w]
            sur_c, sur_e = degraded_surcharge(d_drift, d_new, size_e, wan, om_e[0], pu_e[0],
                                              lh_b)
            wan_c, wan_e = wan_c + sur_c, wan_e + sur_e
            wan_lat = transfer_latency(plan, wan, link_health=lh_b)
        else:
            wan_lat = transfer_latency(plan, wan)
        del plan
        # Ongoing replication premium at the epoch-mean price.
        sync_c = replica_sync_cost(d_new, size_e, wan, wpue_bar, cfg.update_fraction)
        if tel_trace:
            churn = 0.5 * (d_new - d_drift).abs().sum(dim=(-2, -1))
            tgt_churn = 0.5 * (target - d_drift).abs().sum(dim=(-2, -1))
            ring = ring_push(ring, True, e * w, EV_EPOCH,
                             (wan_gb, wan_c, sync_c, churn,
                              churn / torch.clamp_min(tgt_churn, _EPS), float(e)))
            if ingest is not None and faulty and any_dead_b and e > 0:
                ring = ring_push(ring, True, e * w, EV_INGEST_REDIRECT,
                                 ((ingest[e] * (1.0 - alive_b)[None, :]).sum(),
                                  float(n) - alive_b.sum()))
        mu_e_raw = mu_e     # pre-scale rows: the fault path re-derives from these
        if cfg.io_coupling:
            scale_full = io_slow(d_new) / slow0                      # (..., N) or (..., N, K)
            if cfg.io_per_reader:
                mu_e = mu_e * scale_full.unsqueeze(-3)
                scale_e = scale_full.mean(dim=-1)
            else:
                mu_e = mu_e * scale_full[..., None, :, None]
                scale_e = scale_full
        else:
            scale_e = torch.ones((n,), dtype=f32, device=dev)
        if e == 0:
            r_e = r0
        else:
            r_e = _per_run_r(rebuild(d_new), batch)                   # (..., K, N, N)
        if faulty and any_dead_b:
            r_m = r_e * alive_b[None, None, :]
            r_e = r_m / torch.clamp_min(r_m.sum(dim=-1, keepdim=True), _EPS)

        # -- fast timescale: the simulator's slot body against (d_new, r_e).
        e_cost, e_raw = epoch_energy_tables(r_e, wpue_e, pu_e, p_it)
        f_pre = None
        if state_ind:
            # Once for the epoch's W slots under its layout; a recovery
            # re-places mid-epoch, after which its slots decide one by one.
            aux_e = d_new.unsqueeze(-3)
            if wants_wpue:
                aux_e = (aux_e, wpue_e)
            f_pre = policy(gen, q.unsqueeze(-3), arr_e, mu_e, e_cost, aux_e, scalar)
            f_pre = f_pre.expand(batch + (w, n, k_types))
        d_c, r_c, fired = d_new, r_e, False
        for i in range(w):
            t = e * w + i
            arrivals, mu = arr_e[..., i, :], mu_e[..., i, :, :]
            ec, er = e_cost[..., i, :, :], e_raw[..., i, :, :]
            wpue_t = wpue_e[i]
            rec_cost = rec_gb = zero_b
            any_dead = faulty and dead_h[t]
            if faulty:
                any_died = died_h[t]
                if any_dead or any_died:
                    alive_t = alive[t]
                    died = alive_prev[t] * (1.0 - alive_t)            # (N,)
                    # drop_site semantics, static-shape: wipe dead queues,
                    # form the re-injection burst, renormalize the layout.
                    q, d_masked, d_drop, burst = drop_site_mask(q, d_c, alive_t, died)
                    arrivals = arrivals + burst
                    mu = mu * alive_t[:, None]
                if any_died:
                    # ---- the off-schedule recovery epoch (host-gated).
                    obs_r = SlowObs(wpue_bar=wpue_t, mu_bar=mu, q=q, sizes_gb=size_e,
                                    capacity_gb=cap, alive=alive_t)
                    surv_t = (alive_t if regions is None
                              else region_averse_weights(alive_t, regions))
                    tgt = survivor_renorm(rule(d_drop, obs_r) * surv_t[None, :], d_drop,
                                          axis=-1)
                    d_rec = d_drop + mb * (tgt - d_drop)
                    d_rec = d_rec / torch.clamp_min(d_rec.sum(dim=-1, keepdim=True), _EPS)
                    om_t, pu_t = inputs.omega[t], inputs.pue[t]
                    # cost(evac + move) = cost(evac) + cost(move): pricing
                    # is linear in the plan.
                    ev_c, _, ev_g = evacuation_cost(d_masked, d_drop, size_e, wan, om_t, pu_t)
                    mv_c, _, mv_g = plan_cost(d_drop, d_rec, size_e, wan, om_t, pu_t)
                    if linky:
                        # Route the evacuation around severed links and bill
                        # the degraded premium of the routed burst plus the
                        # move's surcharge (each exactly 0.0 on nominal links).
                        lh_t = link_health[t]
                        plan_r = evacuation_plan(d_masked, d_drop, size_e, link_health=lh_t)
                        deg_c, _, _ = transfer_cost(plan_r, wan, om_t, pu_t, link_health=lh_t)
                        nom_c, _, _ = transfer_cost(plan_r, wan, om_t, pu_t)
                        del plan_r
                        msur_c, _ = degraded_surcharge(d_drop, d_rec, size_e, wan, om_t, pu_t,
                                                       lh_t)
                        ev_c = ev_c + (deg_c - nom_c) + msur_c
                    r_rec = rebuild(d_rec) * alive_t[None, None, :]
                    r_rec = r_rec / torch.clamp_min(r_rec.sum(dim=-1, keepdim=True), _EPS)
                    d_c, r_c = d_rec, _per_run_r(r_rec, batch)
                    rec_cost = (ev_c + mv_c).broadcast_to(batch)
                    rec_gb = (ev_g + mv_g).broadcast_to(batch)
                    fired = True
                    if tel_trace:
                        ring = ring_push(ring, True, t, EV_RECOVERY,
                                         (rec_gb, rec_cost, died.sum(),
                                          died.argmax().to(f32)))
                if tel_trace and revived_h[t]:
                    # Revival edge: the companion event the SLO clock
                    # anchors to.
                    revived = alive[t] * (1.0 - alive_prev[t])
                    ring = ring_push(ring, True, t, EV_REPAIR,
                                     (revived.sum(), revived.argmax().to(f32)))
                if fired:
                    # The epoch's rows are stale once a recovery re-placed
                    # mid-epoch: this slot's rows come from the carried r,
                    # and with io_coupling its service scale from the
                    # carried layout.
                    ec, er = energy_row(r_c, wpue_t, inputs.pue[t], p_it)
                    if cfg.io_coupling:
                        s = io_slow(d_c) / slow0
                        if not cfg.io_per_reader:
                            s = s[..., None]
                        mu = mu_e_raw[..., i, :, :] * s * alive[t][:, None]
            if f_pre is not None and not fired:
                f = f_pre[..., i, :, :]
            else:
                aux = d_c
                if wants_wpue:
                    # The kernel-dispatch aux contract: raw per-slot prices
                    # and (wants_r) the ratio tensor in force — the carried
                    # r after a recovery, the epoch rebuild otherwise.
                    aux = (aux, wpue_t)
                if wants_r:
                    aux = aux + (r_c,)
                f = policy(gen, q, arrivals, mu, ec, aux, scalar)
            if any_dead:
                # No dispatch mass to dead sites, whatever the policy says.
                alive_t = alive[t]
                f_fb = (alive_t / torch.clamp_min(alive_t.sum(), 1.0))[:, None].broadcast_to(
                    f.shape)
                f = survivor_renorm(f * alive_t[:, None], f_fb, axis=-2)
            q, out = slot_step(q, f, arrivals, mu, ec, er)
            out = out + (rec_cost, rec_gb)
            if tel_on:
                out = out + (q.sum(dim=-1),)                          # (..., N) per-site q
                if tel_hist:
                    # Per-site slice of this slot's bill, recorded in the
                    # loop because recovery epochs rewrite the energy rows.
                    out = out + ((f * arrivals.unsqueeze(-2) * ec.mT).sum(dim=-1),)
            cols.append(out)
        ep_cols.append((full(d_new, (k_types, n)), full(r_e, (k_types, n, n)),
                        full(wan_c, ()), full(wan_e, ()), full(wan_gb, ()), full(wan_lat, ()),
                        full(sync_c, ()), full(scale_e, (n,))))
        d = d_c
        del e_cost, e_raw, f_pre

    ax = len(batch)
    stacked = [torch.stack(c, dim=ax) for c in zip(*cols)]
    cost, energy, btot, bavg, f_trace, rec_cost, rec_gb = stacked[:7]
    d_tr, r_tr, wc, we, wgb, wlat, sc, msc = (torch.stack(c, dim=ax) for c in zip(*ep_cols))
    placed = PlacedOutputs(
        cost=cost, energy=energy, backlog_total=btot, backlog_avg=bavg,
        q_final=q, f_trace=f_trace,
        placements=d_tr, r_trace=r_tr,
        wan_cost=wc, wan_energy=we, wan_gb=wgb, wan_latency_s=wlat,
        sync_cost=sc, recovery_cost=rec_cost, recovery_gb=rec_gb,
        mu_scale=msc,
    )
    if not tel_on:
        return placed
    metrics = {"q_site": stacked[7]}
    if tel_hist:
        metrics["site_cost_hist"] = hist_series(telemetry.hist, stacked[8], axis=-2)
    return placed, TelemetryFrame(
        ring=ring if tel_trace else _stacked_ring(batch, dev), metrics=metrics,
    )


def simulate_placed_many(
    build_inputs: Callable[[torch.Generator, int], SimInputs],
    up: Tensor,
    down: Tensor,
    policy: PolicyFn,
    rule: PlacementRule,
    generator: torch.Generator,
    n_runs: int,
    cfg: PlacementConfig,
    scalar: float | Tensor = 0.0,
    ingest: Tensor | None = None,
    sizes_gb: Tensor | None = None,
    alive: Tensor | None = None,
    move_budget: Tensor | None = None,
    telemetry: TelemetryConfig | None = None,
    health: Tensor | None = None,
    link_health: Tensor | None = None,
    regions: Tensor | None = None,
    device=None,
    mesh=None,
) -> PlacedOutputs | tuple[PlacedOutputs, TelemetryFrame]:
    """Monte-Carlo replication of :func:`simulate_placed`: fresh stochastic
    traces + policy randomness per run, all runs in one batched controller.

    ``build_inputs(generator, n_runs)`` draws the stacked (R, ...) arrivals
    and service rates; the deterministic traces (prices, PUE, drift, the
    site-alive mask and the health/link-health factors) are shared.
    ``device=None`` means CUDA; the generator and the built inputs must
    live on that device. With telemetry the frame's tensors carry the runs
    axis: index one run before decoding it.

    ``mesh`` (:func:`repro_torch.distributed.mesh.runs_mesh`) runs the runs
    axis in chunks after the one draw, bitwise the unchunked call. A policy
    that consumes the generator raises there: the controller draws its
    decisions epoch by epoch, after a recovery slot by slot, each draw
    shaped by the batch.
    """
    inputs = build_runs(build_inputs, generator, n_runs, device)
    refuse_generator_in_chunks(policy, mesh, "simulate_placed_many")
    return sharded_runs(
        lambda sel: simulate_placed(
            take_runs_inputs(inputs, sel), up, down, policy, rule, generator, cfg,
            scalar=take_runs_scalar(scalar, sel, n_runs), ingest=ingest, sizes_gb=sizes_gb,
            alive=alive, move_budget=take_runs_scalar(move_budget, sel, n_runs),
            telemetry=telemetry, health=health, link_health=link_health, regions=regions,
        ),
        n_runs, mesh)


def summarize_placed(outs: PlacedOutputs) -> dict:
    """Time-averaged scalars incl. WAN/sync/recovery bills (any runs axis)."""
    t_slots = outs.cost.shape[-1]
    dispatch = outs.cost.mean()
    wan_per_slot = outs.wan_cost.sum(dim=-1).mean() / t_slots
    sync_per_slot = outs.sync_cost.sum(dim=-1).mean() / t_slots
    recovery_per_slot = outs.recovery_cost.mean()
    return {
        "time_avg_dispatch_cost": float(dispatch),
        "time_avg_wan_cost": float(wan_per_slot),
        "time_avg_sync_cost": float(sync_per_slot),
        "time_avg_recovery_cost": float(recovery_per_slot),
        "time_avg_total_cost": float(
            dispatch + wan_per_slot + sync_per_slot + recovery_per_slot
        ),
        "time_avg_energy": float(outs.energy.mean()),
        "time_avg_backlog": float(outs.backlog_avg.mean()),
        "total_wan_gb": float(outs.wan_gb.sum(dim=-1).mean()),
        "mean_mu_scale": float(outs.mu_scale.mean()),
        "total_recovery_gb": float(outs.recovery_gb.sum(dim=-1).mean()),
        "max_move_latency_s": float(outs.wan_latency_s.max()),
        "final_backlog_total": float(outs.q_final.sum(dim=(-2, -1)).mean()),
    }
