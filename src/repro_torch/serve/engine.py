"""FleetEngine — the serving control plane, driven by the simulation stack.

The paper's Sec. II framework serving live LLM traffic, on the port: the
front end draws stochastic requests per class (architecture × request
shape) from batched :mod:`repro_torch.traces.arrivals` tables, applies
per-class admission control, and every slot dispatches through the same
stage scheduler ``simulate_staged`` runs. Each request class is a 2-stage
prefill → decode :class:`~repro_torch.jobs.dag.StageDag` (the KV-cache
handoff is the shuffle volume billed when decode runs on another pod than
prefill), and prefill routes through a placement layout via
:func:`~repro_torch.placement.replica.replica_read_assignment`. Pods then
execute real prefill + decode steps for the jobs they drain.

The per-slot update is :func:`repro_torch.jobs.engine.staged_slot_update`,
the slot body of ``simulate_staged``, and the post-run bills evaluate that
engine's own expressions (:func:`~repro_torch.jobs.engine.staged_shuffle_mixes`,
:func:`~repro_torch.jobs.engine.staged_wan_bill`, the hedge bill), so a
dispatch-only :meth:`FleetEngine.run` replays ``simulate_staged`` on the
shared :class:`ServeScenario`: dispatch and WAN bill bitwise.

Pod death (an optional ``(T, N)`` alive mask) mirrors the placement
controller's fault path. The mask is known on the host, so the recovery
is a host ``if``: on slots where a pod is dead its queues are wiped (a
select, never ``* alive``), its service zeroed, its energy made
prohibitive and the prefill layout renormalized over the survivors; a
policy that cannot see those (the kernel dispatch) has its mass on dead
pods moved to the survivors. On a death edge the dead pod's backlog
re-enters as a prefill-stage arrival burst (the KV cache died with the
pod, so decode work re-executes) and a recovery event lands in the
history and the stream. Slots with every pod alive run the no-fault step,
so an all-ones mask is bitwise no mask.

Energy follows the reference's accounting: per-job energy from the
model's active parameter count and tokens (6·N_active·tokens FLOPs at the
pricing model's chip efficiency), weighted by per-pod PUE and price; the
history prices jobs actually served (``min(q + f·A, mu)`` per stage,
compute-weighted), not jobs dispatched.

Each slot's host-bound values (completions, queues, the decode stage's
dispatch) come back in one transfer, which is the slot's one wait for the
device; ``run`` reports where its wall time went (``out["timing"]``).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from repro_torch.configs.base import ModelConfig
from repro_torch.core.gmsa import make_kernel_policy
from repro_torch.core.simulator import SimInputs, _scalar_for, energy_tables
from repro_torch.device import as_float32, resolve_device
from repro_torch.jobs.dag import StageDag, chain_dag
from repro_torch.jobs.engine import (
    _hedge_bill,
    hedged_mu,
    staged_shuffle_mixes,
    staged_slot_update,
    staged_wan_bill,
)
from repro_torch.jobs.scheduler import (
    make_staged_policy,
    stage_oblivious,
    stage_service_rates_all,
)
from repro_torch.models.lm import init_params
from repro_torch.placement.controller import survivor_renorm
from repro_torch.placement.replica import replica_read_assignment
from repro_torch.placement.wan import WanModel, wan_topology
from repro_torch.serve.step import make_local_exec
from repro_torch.telemetry.config import TelemetryConfig
from repro_torch.telemetry.config import histograms as _tel_hist
from repro_torch.telemetry.metrics import percentile_table, sojourn_init, sojourn_step
from repro_torch.traces.arrivals import (
    admission_split,
    poisson_pair_from_tables,
    serve_rate_tables,
)

# The energy model's per-chip constants, the reference's (DESIGN.md §7: a
# TPU v5e-class pod chip). They price a job's energy in the simulated
# fleet; they are not measurements of any card this port runs on.
CHIP_PEAK_FLOPS = 197e12
CHIP_TDP_W = 200.0
CHIP_EFFICIENCY = 0.45

#: Pod throughput skew cycled to any fleet size (FleetConfig.__post_init__).
DEFAULT_CAPACITY_SHARES = (0.3, 0.2, 0.9, 0.6)


@dataclasses.dataclass(frozen=True)
class RequestClass:
    """One workload class k: an architecture at a request shape.

    ``cfg`` is the model actually executed; ``energy_cfg`` (default: cfg)
    is the architecture whose parameter count prices the job — pass the
    full config to price production-scale energy while executing a
    smaller one.
    """

    name: str
    cfg: ModelConfig
    energy_cfg: ModelConfig | None = None
    prompt_len: int = 32
    gen_len: int = 8
    arrival_rate: float = 6.0     # jobs / slot (Poisson)

    def flops_per_job(self) -> float:
        toks = self.prompt_len + self.gen_len
        ecfg = self.energy_cfg or self.cfg
        return 6.0 * ecfg.active_param_count() * toks

    def energy_per_job_j(self) -> float:
        """IT-side energy per job (Joules): chip-seconds × TDP."""
        chip_seconds = self.flops_per_job() / (CHIP_PEAK_FLOPS * CHIP_EFFICIENCY)
        return chip_seconds * CHIP_TDP_W

    def stage_compute(self) -> tuple[float, float]:
        """(prefill, decode) compute shares — token-proportional split."""
        toks = float(self.prompt_len + self.gen_len)
        return self.prompt_len / toks, self.gen_len / toks

    def kv_gb(self) -> float:
        """Prefill → decode handoff volume per job (GB): the KV cache.

        Priced at ``energy_cfg``, bf16: 2 (K and V) × layers × kv_heads ×
        head_dim × prompt tokens. Attention-free (SSM) backbones hand off
        the recurrent state snapshot instead.
        """
        ecfg = self.energy_cfg or self.cfg
        if ecfg.has_attention:
            by = (2 * ecfg.num_layers * ecfg.num_kv_heads
                  * ecfg.resolved_head_dim * self.prompt_len * 2)
        else:
            by = ecfg.num_layers * ecfg.d_inner * ecfg.ssm_state * 2
        return by / 1e9


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Static serving-fleet knobs.

    ``capacity_shares`` shorter (or longer) than ``n_pods`` is completed in
    ``__post_init__`` by cycling the given tuple; an empty tuple raises.
    """

    n_pods: int = 4
    horizon_slots: int = 32
    v: float = 1.0
    seed: int = 0
    batch_per_exec: int = 4       # jobs executed per model invocation
    capacity_shares: tuple = DEFAULT_CAPACITY_SHARES   # pod throughput skew
    admit_max: float | None = None    # per-class per-slot admission cap
    slo_backlog: float = 50.0     # per-class backlog SLO threshold
    exec_cap: int | None = 8      # real-execution throttle per (class, slot)
                                  # (None = every drained job executes)
    dispatch: str = "staged"      # "staged" (joint stage scheduler) or
                                  # "kernel" (gmsa_score every slot)
    hedge_threshold: float | None = None
                                  # speculative re-execution: clone a
                                  # dispatched stage to the runner-up pod
                                  # when its effective service rate falls
                                  # below this fraction of the runner-up's
                                  # (staged dispatch only; None = off)

    def __post_init__(self):
        shares = tuple(float(s) for s in self.capacity_shares)
        if not shares:
            raise ValueError("capacity_shares must not be empty")
        if len(shares) != self.n_pods:
            shares = tuple(itertools.islice(itertools.cycle(shares), self.n_pods))
            object.__setattr__(self, "capacity_shares", shares)
        if self.dispatch not in ("staged", "kernel"):
            raise ValueError(f"unknown dispatch impl {self.dispatch!r}")
        if self.hedge_threshold is not None:
            if self.dispatch != "staged":
                raise ValueError("hedge_threshold requires the staged dispatcher")
            if not self.hedge_threshold > 0.0:
                raise ValueError(f"hedge_threshold must be > 0, got {self.hedge_threshold}")


class ServeScenario(NamedTuple):
    """The shared scenario a serving run and ``simulate_staged`` agree on.

    ``inputs.arrivals`` is the admitted trace (after admission control) and
    ``inputs.data_dist`` the replica-read serving distribution: feed this
    bundle to ``simulate_staged(inputs, dag, wan, policy, ...)`` and a
    dispatch-only ``FleetEngine.run`` replays it.
    """

    inputs: SimInputs       # arrivals (T, K) admitted, mu (T, N, K), ...
    dag: StageDag           # (K, 2) prefill -> decode chain
    wan: WanModel           # KV-handoff pricing
    raw_arrivals: Tensor    # (T, K) pre-admission request counts
    rejected: Tensor        # (T, K) load shed at the door
    layout: Tensor          # (K, N) dataset/KV-prefix placement layout
    reads: Tensor           # (K, N, N) replica-read assignment (one-hot)


def build_serve_scenario(
    fcfg: FleetConfig,
    classes: list[RequestClass],
    omega,
    pue,
    r,
    *,
    up=None,
    down=None,
    layout=None,
    device=None,
) -> ServeScenario:
    """Build the scenario bundle the engine and the simulator share, on
    ``device`` (``None``: CUDA).

    Arrivals and straggler-noise capacities for the whole horizon come from
    one batched inverse-CDF draw (:func:`poisson_pair_from_tables`) of a
    generator seeded with ``fcfg.seed`` on the device; admission control
    splits them exactly; prefill routing is the placement layer's
    cheapest-live-replica read assignment averaged over (uniform) reader
    locations. ``omega``/``pue`` (T', N) are tiled to the horizon.
    """
    dev = resolve_device(device)
    n, k = fcfg.n_pods, len(classes)
    t_slots = fcfg.horizon_slots
    gen = torch.Generator(device=dev).manual_seed(fcfg.seed)

    omega, pue = as_float32(omega, dev), as_float32(pue, dev)
    idx = torch.arange(t_slots, device=dev)
    omega_t = omega[idx % omega.shape[0]]
    pue_t = pue[idx % pue.shape[0]]

    rates = np.asarray([rc.arrival_rate for rc in classes], np.float64)
    arr_cdf, mu_cdf = serve_rate_tables(rates, fcfg.capacity_shares)
    raw_arrivals, mu = poisson_pair_from_tables(
        gen, torch.from_numpy(arr_cdf).to(dev), torch.from_numpy(mu_cdf).to(dev), t_slots
    )
    admitted, rejected = admission_split(raw_arrivals, fcfg.admit_max)

    if up is None or down is None:
        up = torch.full((n,), 10.0, dtype=torch.float32, device=dev)
        down = torch.full((n,), 10.0, dtype=torch.float32, device=dev)
    wan = wan_topology(as_float32(up, dev), as_float32(down, dev))
    if layout is None:
        layout = torch.full((k, n), 1.0 / n, dtype=torch.float32, device=dev)
    layout = as_float32(layout, dev)

    # Replica reads pick the serving pod: each (uniformly located) reader
    # pulls from its cheapest live replica at the horizon-mean energy price.
    wpue_bar = (omega_t * pue_t).mean(dim=0)                       # (N,)
    reads = replica_read_assignment(layout, wan, wpue_bar)         # (K, N, N)
    serve_dist = reads.mean(dim=1)                                 # (K, N)

    # Prefill -> decode as a 2-stage chain: compute split token-proportional,
    # the KV cache as the inter-stage shuffle volume.
    comp = [rc.stage_compute() for rc in classes]
    shuf = [[0.0, rc.kv_gb()] for rc in classes]
    dag = chain_dag(comp, shuf, device=dev)

    # kWh per job, priced by omega in $/MWh.
    p_it = torch.tensor([rc.energy_per_job_j() / 3.6e6 for rc in classes],
                        dtype=torch.float32, device=dev)
    inputs = SimInputs(arrivals=admitted, mu=mu, omega=omega_t, pue=pue_t,
                       r=as_float32(r, dev), p_it=p_it, data_dist=serve_dist)
    return ServeScenario(inputs=inputs, dag=dag, wan=wan, raw_arrivals=raw_arrivals,
                         rejected=rejected, layout=layout, reads=reads)


def serve_policy(fcfg: FleetConfig, scenario: ServeScenario):
    """The dispatch policy of a serving run — the simulator's own.

    ``"staged"`` is the joint stage scheduler (prefill pinned to the
    replica-read layout, decode scored drift-plus-penalty with the KV pull
    priced); ``"kernel"`` sends every slot's decision through the
    ``gmsa_score`` kernel on the scenario's static r (one launch per slot),
    adapted by ``stage_oblivious`` (prefill stays layout-pinned).
    """
    if fcfg.dispatch == "kernel":
        base = make_kernel_policy(scenario.inputs.r, p_it=scenario.inputs.p_it)
        return stage_oblivious(base, pin_map=True)
    return make_staged_policy(scenario.dag, scenario.wan, pin_map=True,
                              hedge=fcfg.hedge_threshold)


def _host_mask(name: str, x, shape: tuple) -> np.ndarray:
    """A (T, N[, N]) fault trace as fp32 numpy, its shape checked."""
    x = np.asarray(x.cpu() if isinstance(x, Tensor) else x, np.float32)
    if x.shape != shape:
        dims = ", ".join(f"{d}={s}" for d, s in zip(("T", "N", "N"), shape))
        raise ValueError(f"{name} must be ({dims}), got {x.shape}")
    return x


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class FleetEngine:
    """Slot-driven serving loop, dispatched by the simulation stack, on
    ``device`` (``None``: CUDA).

    ``scenario`` replaces the scenario the engine would build from
    ``(omega, pue, r, up, down, layout)`` and ``fcfg.seed`` (a bridged one,
    :func:`repro_torch.bridge.serve_scenario_from_numpy`); ``health`` still
    applies on top of it.
    """

    def __init__(
        self,
        fcfg: FleetConfig,
        classes: list[RequestClass],
        omega,                      # (T, N) price traces
        pue,                        # (T, N)
        r,                          # (K, N, N) task-allocation ratios
        *,
        up=None,                    # (N,) access bandwidths (KV pricing)
        down=None,
        layout=None,                # (K, N) placement layout
        alive=None,                 # (T, N) pod-alive mask
        telemetry: TelemetryConfig | None = None,
        health=None,                # (T, N) pod health in [0, 1]
        link_health=None,           # (T, N, N) WAN link factor
        scenario: ServeScenario | None = None,
        device=None,
    ):
        dev = resolve_device(device)
        self.device = dev
        self.fcfg = fcfg
        t_slots, n = fcfg.horizon_slots, fcfg.n_pods
        # The histogram layer threads a per-class FIFO sojourn clock through
        # the step; OFF/None runs the step's own operations only.
        self.telemetry = telemetry
        self._hist_on = _tel_hist(telemetry)
        self.classes = classes
        self.omega, self.pue, self.r = omega, pue, r
        # One generator for the weights (class by class) and then the prompt
        # tokens of every executed batch.
        self.generator = torch.Generator(device=dev).manual_seed(fcfg.seed)
        self.params, self._prefill, self._decode = {}, {}, {}
        for rc in classes:
            self.params[rc.name] = init_params(rc.cfg, self.generator, torch.float32, device=dev)
            self._prefill[rc.name], self._decode[rc.name] = make_local_exec(
                rc.cfg, rc.gen_len, device=dev)
        if scenario is None:
            scenario = build_serve_scenario(fcfg, classes, omega, pue, r, up=up, down=down,
                                            layout=layout, device=dev)
        elif tuple(scenario.inputs.mu.shape) != (t_slots, n, len(classes)):
            raise ValueError(
                f"scenario mu is {tuple(scenario.inputs.mu.shape)}, expected "
                f"(T={t_slots}, N={n}, K={len(classes)})"
            )
        self.scenario = scenario
        self.health = None
        if health is not None:
            self.health = _host_mask("health", health, (t_slots, n))
            # Hoisted as the scan engines hoist it: stragglers serve slower
            # everywhere downstream (dispatch, the hedge trigger, the drain).
            # All-ones health is the * 1.0 identity.
            inputs = scenario.inputs
            h = torch.from_numpy(self.health).to(dev)
            self.scenario = scenario._replace(inputs=inputs._replace(mu=inputs.mu * h[:, :, None]))
        self.link_health = None
        if link_health is not None:
            self.link_health = _host_mask("link_health", link_health, (t_slots, n, n))
        self.p_it = self.scenario.inputs.p_it
        self.policy = serve_policy(fcfg, self.scenario)
        if getattr(self.policy, "consumes_key", True):
            raise ValueError(
                "FleetEngine dispatch policies must be key-free "
                "(consumes_key=False) so the serving loop carries no random "
                "stream — both built-in dispatch impls are"
            )
        self.alive = None if alive is None else _host_mask("alive mask", alive, (t_slots, n))

    def _execute_jobs(self, rc: RequestClass, n_jobs: int) -> tuple[int, float]:
        """Run real prefill + decode for exactly ``n_jobs``; returns
        ``(done, seconds)``. The last batch is sliced to the remainder."""
        if n_jobs <= 0:
            return 0, 0.0
        dev, b = self.device, self.fcfg.batch_per_exec
        prefill_fn, decode_fn = self._prefill[rc.name], self._decode[rc.name]
        params, vocab = self.params[rc.name], rc.cfg.vocab_size
        _sync(dev)
        t0 = time.perf_counter()
        tokens = torch.randint(0, vocab, (b, rc.prompt_len), generator=self.generator,
                               device=dev)
        done = 0
        while done < n_jobs:
            nb = min(b, n_jobs - done)
            logits, cache = prefill_fn(params, tokens[:nb])
            tok = torch.argmax(logits[:, -1:, :vocab], dim=-1)
            for _ in range(rc.gen_len):
                logits, cache = decode_fn(params, cache, tok)
                tok = torch.argmax(logits[:, :, :vocab], dim=-1)
            done += nb
        _sync(dev)
        return done, time.perf_counter() - t0

    def run(self, execute_real: bool = True, stream=None) -> dict:
        """Run the serving loop. Returns per-slot traces + summary.

        Args:
            execute_real: run real prefill + decode for drained jobs (only
                completed decode drains execute, throttled at
                ``fcfg.exec_cap`` per class per slot).
            stream: optional callable receiving one JSON-ready dict per
                slot, called in slot order as the run progresses: a metric
                record every slot, then a ``{"type": "event", "code":
                "recovery", ...}`` record on every pod-death edge.

        The dict has the reference's keys (``cost``, ``backlog``,
        ``dispatch``, ``exec_seconds``, ``exec_jobs``, ``mean_cost``,
        ``final_backlog``, ``history``, ``q_final``, the WAN and hedge
        bills, ``total_billed_cost``, the admission split, ``served``,
        ``completed``, ``slo_viol_frac``, ``events``; the sojourn histogram
        with the histogram layer) and ``timing``: the run's wall seconds by
        part — ``enqueue`` (the host enqueueing each slot's device work),
        ``readback`` (each slot's one transfer, the wait for the device
        included), ``record`` (the host's per-slot bookkeeping),
        ``execute`` and the post-run ``bill``.
        """
        fcfg, scn, dev = self.fcfg, self.scenario, self.device
        inputs, dag = scn.inputs, scn.dag
        n, k = fcfg.n_pods, len(self.classes)
        s_max = dag.s_max
        t_slots = fcfg.horizon_slots
        nks = n * k * s_max
        v = _scalar_for(fcfg.v, (), dev)
        pol = self.policy
        returns_flow = getattr(pol, "returns_flow", False)
        hedging = getattr(pol, "returns_hedge", False)
        timing = dict.fromkeys(("enqueue", "readback", "record", "execute", "bill"), 0.0)

        # Hoisted tables: simulate_staged's own expressions.
        wpue_all = inputs.omega * inputs.pue                       # (T, N)
        e_cost_all, _ = energy_tables(inputs.r, wpue_all, inputs.pue, inputs.p_it)
        mu_stage_all = stage_service_rates_all(inputs.mu, dag)     # (T, N, K, S)
        ec_stage_all = e_cost_all[:, :, None, :] * dag.compute[None, :, :, None]

        e_per_job = np.asarray([rc.energy_per_job_j() for rc in self.classes], np.float64)
        compute_np = dag.compute.cpu().numpy()                     # (K, S)
        admitted_np = inputs.arrivals.cpu().numpy()
        rejected_np = scn.rejected.cpu().numpy()
        faulty = self.alive is not None
        if faulty:
            alive_prev = np.concatenate([np.ones((1, n), np.float32), self.alive[:-1]], axis=0)
            died_np = alive_prev * (1.0 - self.alive)
            alive_dev = torch.from_numpy(self.alive).to(dev)
            died_dev = torch.from_numpy(died_np).to(dev)

        hist_on = self._hist_on
        if hist_on:
            # Per-class FIFO sojourn clock, its age ring bounded by the horizon.
            spec = self.telemetry.hist
            age, soj_hist = sojourn_init(spec, k, t_slots, device=dev)
        q = torch.zeros((n, k, s_max), dtype=torch.float32, device=dev)
        f_slots, in_slots, done_slots, g_slots, acc_slots = [], [], [], [], []
        history: list[dict] = []
        events: list[dict] = []
        backlogs = []
        exec_secs, exec_jobs = 0.0, 0
        served_np = np.zeros((t_slots, k))
        completed_np = np.zeros((t_slots, k))

        for t in range(t_slots):
            t0 = time.perf_counter()
            arrivals, mu, e_cost = inputs.arrivals[t], inputs.mu[t], e_cost_all[t]
            mu_stages, dd_t = mu_stage_all[t], inputs.data_dist
            admitted_t = arrivals           # the sojourn inflow: admitted mass only
            died_t = faulty and died_np[t].sum() > 0.5
            burst = None
            if died_t:
                # The dead pods' backlog, read before the wipe, re-enters as
                # a prefill-stage burst: the KV cache died with the pod.
                burst = (q * died_dev[t][:, None, None]).sum(dim=(0, 2))     # (K,)
                arrivals = arrivals + burst
            dead_t = faulty and (self.alive[t] < 0.5).any()
            if dead_t:
                # Route around the dead pods by what the policy sees — zero
                # service, prohibitive energy, a survivor-renormalized
                # prefill layout — so its flow walk stays consistent with
                # the dispatch it returns.
                a_t = alive_dev[t]
                q = torch.where(a_t[:, None, None] > 0.5, q, 0.0)
                mu = mu * a_t[:, None]
                mu_stages = mu_stages * a_t[:, None, None]
                e_cost = torch.where(a_t[None, :] < 0.5, 1e30, e_cost)
                unif = (a_t / a_t.sum().clamp_min(1.0))[None, :].expand(dd_t.shape)
                dd_t = survivor_renorm(dd_t * a_t[None, :], unif, axis=1)
            ret = pol(None, q, arrivals, mu, e_cost, (dd_t, wpue_all[t]), v)
            if dead_t and not returns_flow:
                # No dispatch mass on a dead pod, whatever the policy says, as
                # the placement controller rules: the kernel policy prices
                # from the raw (r, wpue) and never sees the 1e30 energy, so
                # under overload a dead pod's zero backlog wins its argmin.
                # Only columns with mass on a dead pod change.
                on_dead = (ret * (1.0 - a_t)[:, None, None]).sum(dim=0) > 0.0     # (K, S)
                fb = (a_t / a_t.sum().clamp_min(1.0))[:, None, None].expand(ret.shape)
                ret = torch.where(on_dead, survivor_renorm(ret * a_t[:, None, None], fb, axis=0),
                                  ret)
            q, f, acc, in_stack = staged_slot_update(dag, q, ret, arrivals, mu_stages,
                                                     returns_flow, hedging)
            if hedging:
                # Queues drained at the first-completion boosted rates;
                # ``done`` drains the same flow.
                mu_stages = hedged_mu(f, ret[2], mu_stages)
                g_slots.append(ret[2])
                acc_slots.append(acc)
            done = torch.minimum(acc, mu_stages)
            if hist_on:
                age, soj_hist = sojourn_step(spec, age, soj_hist, admitted_t,
                                             done[:, :, -1].sum(dim=0))
            f_slots.append(f)
            in_slots.append(in_stack)
            done_slots.append(done)

            # Everything the host needs this slot, in one transfer.
            parts = [done.reshape(-1), q.reshape(-1), f[:, :, -1].reshape(-1)]
            if stream is not None:
                parts.append(((f * in_stack[None]) * ec_stage_all[t].permute(2, 0, 1))
                             .sum().reshape(1))
            if died_t:
                parts.append(burst.sum().reshape(1))
            t1 = time.perf_counter()
            host = torch.cat(parts).cpu().numpy()
            t2 = time.perf_counter()
            done_np = host[:nks].reshape(n, k, s_max)
            q_np = host[nks:2 * nks].reshape(n, k, s_max)
            f_last = host[2 * nks:2 * nks + n * k].reshape(n, k)
            served_k = (done_np * compute_np[None]).sum(axis=(0, 2))
            completed_k = done_np[:, :, -1].sum(axis=0)
            served_np[t] = served_k
            completed_np[t] = completed_k
            energy_j = served_k * e_per_job                        # served-priced
            q_class = q_np.sum(axis=(0, 2))                        # (K,)
            slo_viol = q_class > fcfg.slo_backlog
            backlogs.append(float(q_np.sum()))
            rec = {
                "t": t,
                # Manager pod per class: where the decode (response) stage
                # landed this slot.
                "choice": np.argmax(f_last, axis=0).tolist(),
                "q_pod": q_np.sum(axis=(1, 2)).tolist(),
                "energy_j": energy_j.tolist(),
                "admitted": admitted_np[t].tolist(),
                "rejected": rejected_np[t].tolist(),
                "served": served_k.tolist(),
                "completed": completed_k.tolist(),
                "slo_viol": slo_viol.tolist(),
            }
            ev = None
            if died_t:
                ev = {
                    "type": "event", "code": "recovery", "t": t,
                    "pod": int(np.argmax(died_np[t])),
                    "n_died": int(died_np[t].sum()),
                    "drained": float(host[-1]),
                }
                events.append(ev)
                rec["recovery"] = ev
            history.append(rec)
            if stream is not None:
                f32 = lambda x: float(np.float32(x))
                stream({
                    "type": "metric", "engine": "serve", "t": t,
                    "cost": float(host[2 * nks + n * k]), "backlog": f32(backlogs[-1]),
                    "admitted": f32(admitted_np[t].sum()), "rejected": f32(rejected_np[t].sum()),
                    "served": f32(served_k.sum()), "slo_viol": int(slo_viol.sum()),
                })
                if ev is not None:
                    stream({"type": "event", "engine": "serve", "code": "recovery", "t": t,
                            "drained": ev["drained"], "pod": ev["pod"], "n_died": ev["n_died"]})
            t3 = time.perf_counter()
            timing["enqueue"] += t1 - t0
            timing["readback"] += t2 - t1
            timing["record"] += t3 - t2

            if execute_real:
                for ki, rc in enumerate(self.classes):
                    njobs = int(round(completed_k[ki]))
                    if fcfg.exec_cap is not None:
                        njobs = min(njobs, fcfg.exec_cap)
                    ndone, secs = self._execute_jobs(rc, njobs)
                    exec_secs += secs
                    exec_jobs += ndone
        timing["execute"] = exec_secs

        # Post-run billing: simulate_staged's post-loop expressions over the
        # stacked per-slot outputs, in its reduction order.
        t0 = time.perf_counter()
        f_trace = torch.stack(f_slots)                             # (T, N, K, S)
        in_all = torch.stack(in_slots)                             # (T, K, S)
        done_all = torch.stack(done_slots)                         # (T, N, K, S)
        fa_all = f_trace * in_all.unsqueeze(-3)
        cost = (fa_all * ec_stage_all.permute(0, 3, 1, 2)).sum(dim=(-3, -2, -1))   # (T,)
        dd_all = inputs.data_dist.expand((t_slots,) + tuple(inputs.data_dist.shape))
        src_all, dst_all, vol_all = staged_shuffle_mixes(f_trace, in_all, done_all, dd_all, dag)
        # With link_health, the degraded-link premium on the KV-handoff
        # traffic (exact zero on an all-nominal trace).
        lh = None if self.link_health is None else torch.from_numpy(self.link_health).to(dev)
        wan_c, wan_e, wan_gb = staged_wan_bill(src_all, dst_all, vol_all, scn.wan,
                                               inputs.omega, inputs.pue, lh)
        if hedging:
            # The speculation bill, simulate_staged's: boost-attributable
            # completions at the clone pod's stage energy plus the KV pull.
            g_all = torch.stack(g_slots)                           # (T, N, K, S)
            acc_all = torch.stack(acc_slots)
            mu_used = mu_stage_all
            if faulty:
                mu_used = mu_used * alive_dev[:, :, None, None]
            boost_all = (g_all * mu_used).sum(dim=-3)              # (T, K, S)
            mu_eff_all = mu_used + f_trace * boost_all.unsqueeze(-3)
            hedge_c, hedge_gb, hedged_jobs = _hedge_bill(
                dag, scn.wan, g_all, acc_all, mu_used, mu_eff_all, ec_stage_all, src_all,
                wpue_all,
            )
        else:
            hedge_c = hedge_gb = hedged_jobs = torch.zeros((t_slots,), dtype=torch.float32,
                                                           device=dev)
        hedge_costs = hedge_c.cpu().numpy()
        hedged_np = hedged_jobs.cpu().numpy()
        for t, h in enumerate(history):
            h["hedged_jobs"] = float(hedged_np[t])
        costs = cost.cpu().numpy()
        wan_costs = wan_c.cpu().numpy()
        slo_viol_frac = np.mean([h["slo_viol"] for h in history], axis=0)

        out_tel = {}
        if hist_on:
            counts = soj_hist.cpu().numpy()                        # (K, B)
            names = [rc.name for rc in self.classes]
            out_tel = {
                "sojourn_hist": counts,
                "sojourn_spec": dataclasses.asdict(spec),
                "class_names": names,
                "sojourn_percentiles": percentile_table(counts, spec, names=names),
            }
        out = {
            **out_tel,
            "cost": costs,
            "backlog": np.asarray(backlogs),
            "dispatch": f_trace.cpu().numpy(),
            "exec_seconds": exec_secs,
            "exec_jobs": exec_jobs,
            "mean_cost": float(np.mean(costs)),
            "final_backlog": backlogs[-1],
            "history": history,
            "q_final": q.cpu().numpy(),
            "wan_cost": wan_costs,
            "wan_gb": wan_gb.cpu().numpy(),
            "wan_energy": wan_e.cpu().numpy(),
            "hedge_cost": hedge_costs,
            "hedge_gb": hedge_gb.cpu().numpy(),
            "hedged_jobs": hedged_np,
            "total_billed_cost": float(costs.sum() + wan_costs.sum() + hedge_costs.sum()),
            "raw_arrivals": scn.raw_arrivals.cpu().numpy(),
            "admitted": admitted_np,
            "rejected": rejected_np,
            "served": served_np,
            "completed": completed_np,
            "slo_viol_frac": slo_viol_frac,
            "events": events,
        }
        timing["bill"] = time.perf_counter() - t0
        out["timing"] = timing
        return out
