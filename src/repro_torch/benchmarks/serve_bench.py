"""Serving control-plane bench: the port's FleetEngine on the simulation stack.

Times the serving loop (staged prefill → decode dispatch, replica-read
routing, admission control) dispatch-only, asserts its two invariants, and
runs the fleet-scale kernel path, as the JAX package's
``benchmarks/serve_bench.py`` does:

* **replay** — a dispatch-only ``FleetEngine.run`` reproduces the port's
  ``simulate_staged`` on the shared scenario (:func:`check_replay`);
* **request conservation** — admitted = completed + final backlog per
  class, the admission split exact, the sojourn histogram's mass the
  completed mass (:func:`check_conservation`);
* **fleet grid** — an N = 256 pod grid from
  :func:`repro_torch.configs.fleet_256.make_serve_grid` where every slot's
  decision launches ``gmsa_score`` (its plain version on the CPU).

The staged run carries the sojourn-histogram layer; ``--flight OUT.jsonl``
saves its flight record and ``--trace OUT.json`` the Chrome trace.
``--chaos`` adds the degraded-mode pair (straggler + link brown-out,
without and with speculative re-execution). Without ``--quick`` a
real-execution row runs prefill + decode for drained jobs (smoke model).

    PYTHONPATH=src python -m repro_torch.benchmarks.serve_bench [--quick]
        [--chaos] [--device cuda] [--flight PATH] [--trace PATH] [--record PATH]

``--record PATH`` appends the CSV records under the ``torch_serve_bench``
label. The classes are the JAX bench's: ``qwen2-0.5b`` for the staged and
execution rows, the ``qwen2-0.5b`` + ``mamba2-2.7b`` pair for the fleet grid
and the chaos pair (each executes its smoke variant, priced on the full).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.benchmarks.common import emit, sync, write_record
from repro_torch.configs import get_arch
from repro_torch.configs.fleet_256 import FleetConfig as GridConfig
from repro_torch.configs.fleet_256 import make_serve_grid
from repro_torch.device import resolve_device
from repro_torch.jobs.engine import simulate_staged
from repro_torch.launch.serve import build_engine
from repro_torch.serve.engine import FleetConfig, FleetEngine, RequestClass
from repro_torch.telemetry import (
    SUMMARY,
    HistogramSpec,
    SloSpec,
    TelemetryConfig,
    fleet_records,
    spans_from_records,
    write_chrome_trace,
    write_jsonl,
)

ARCH = "qwen2-0.5b"
#: The two-class mix of the fleet grid and the chaos pair.
PAIR = ("qwen2-0.5b", "mamba2-2.7b")
#: The replay pin, port against port (the same slot body and post-run
#: expressions on the same device): dispatch and WAN bill bitwise; the cost
#: series within COST_RTOL and the total bill within TOTAL_RTOL (the same
#: fp32 values, reduced per slot here and after the loop there); the
#: backlog within BACKLOG_ATOL + BACKLOG_RTOL relative (numpy's fp32 sum of
#: the queues against torch's: the reference's own pin).
COST_RTOL = 1e-5
TOTAL_RTOL = 1e-6
BACKLOG_RTOL = BACKLOG_ATOL = 1e-5
#: Conservation: fp32 queues summed over a horizon (relative to admitted).
CONSERVE_RTOL = 1e-5


def _timed_run(engine: FleetEngine, execute_real: bool):
    sync(engine.device)
    t0 = time.perf_counter()
    out = engine.run(execute_real=execute_real)
    sync(engine.device)
    return out, (time.perf_counter() - t0) * 1e6


def check_replay(engine: FleetEngine, out: dict) -> dict:
    """Raise AssertionError unless the dispatch-only ``out`` replays the
    port's ``simulate_staged`` on the engine's scenario and policy; returns
    the largest deviations."""
    scn = engine.scenario
    outs = simulate_staged(scn.inputs, scn.dag, scn.wan, engine.policy, None, engine.fcfg.v)
    if not np.array_equal(out["dispatch"], outs.f_trace.cpu().numpy()):
        raise AssertionError("serving dispatch trace diverged from simulate_staged")
    if not np.array_equal(out["wan_cost"], outs.wan_cost.cpu().numpy()):
        raise AssertionError("serving WAN bill diverged from simulate_staged")
    cost = outs.cost.cpu().numpy()
    cost_rel = float(np.max(np.abs(out["cost"] - cost) / np.maximum(np.abs(cost), 1e-30)))
    sim_total = float(cost.sum() + outs.wan_cost.cpu().numpy().sum()
                      + outs.hedge_cost.cpu().numpy().sum())
    total_rel = abs(out["total_billed_cost"] - sim_total) / max(abs(sim_total), 1e-30)
    sim_backlog = outs.backlog_total.cpu().numpy()
    backlog_err = np.abs(out["backlog"] - sim_backlog)
    backlog_rel = float(np.max(backlog_err / np.maximum(np.abs(sim_backlog), 1.0)))
    if (cost_rel > COST_RTOL or total_rel > TOTAL_RTOL
            or (backlog_err > BACKLOG_ATOL + BACKLOG_RTOL * np.abs(sim_backlog)).any()):
        raise AssertionError(
            f"serving bills diverged from simulate_staged: cost {cost_rel:.3e} "
            f"(tol {COST_RTOL}), total {total_rel:.3e} (tol {TOTAL_RTOL}), backlog "
            f"{backlog_rel:.3e} relative (tol {BACKLOG_RTOL} + {BACKLOG_ATOL})")
    return {"cost_rel": cost_rel, "total_rel": total_rel, "backlog_rel": backlog_rel}


def check_conservation(out: dict) -> float:
    """Raise AssertionError unless admitted = completed + final backlog per
    class (within CONSERVE_RTOL of admitted), the admission split is exact
    and a sojourn histogram holds the completed mass; returns the largest
    relative imbalance."""
    adm = out["admitted"].sum(axis=0)
    comp = out["completed"].sum(axis=0)
    qf = out["q_final"].astype(np.float64).sum(axis=(0, 2))
    rel = float(np.max(np.abs(adm - comp - qf) / np.maximum(adm, 1.0)))
    if rel > CONSERVE_RTOL:
        raise AssertionError(f"request conservation violated: admitted {adm} != completed "
                             f"{comp} + backlog {qf}")
    if not np.array_equal(out["raw_arrivals"], out["admitted"] + out["rejected"]):
        raise AssertionError("admission split is not exact")
    if "sojourn_hist" in out:
        mass = out["sojourn_hist"].astype(np.float64).sum(axis=-1)
        if np.max(np.abs(mass - comp) / np.maximum(comp, 1.0)) > CONSERVE_RTOL:
            raise AssertionError(f"sojourn histogram lost mass: {mass} vs completed {comp}")
    return rel


def _sojourn_p99(out: dict) -> float:
    from repro_torch.telemetry.metrics import fifo_sojourn_replay, weighted_percentile

    soj, wgt = fifo_sojourn_replay(out["admitted"], out["completed"])
    return float(weighted_percentile(soj, wgt, [99.0])[0])


def _chaos_arm(dev) -> list[dict]:
    """Degraded-mode pair: pod 2 (the dominant-capacity pod) at 12% of its
    rate from slot 4, link 0 <-> 1 at half capacity over slots 8-15; the
    hedged arm clones starved stages at threshold 0.35."""
    slots, n_pods, hedge = 24, 4, 0.35
    common = dict(slots=slots, v=1.0, seed=3, arrival=4.0, admit_max=5.0, device=dev)
    health = np.ones((slots, n_pods), np.float32)
    health[4:, 2] = 0.12
    link_health = np.ones((slots, n_pods, n_pods), np.float32)
    link_health[8:16, 0, 1] = link_health[8:16, 1, 0] = 0.5

    base = build_engine(list(PAIR), health=health, link_health=link_health, **common)
    bout, bus = _timed_run(base, execute_real=False)
    check_conservation(bout)
    hedged = build_engine(list(PAIR), health=health, link_health=link_health, hedge=hedge,
                          **common)
    hout, hus = _timed_run(hedged, execute_real=False)
    check_conservation(hout)

    p99_b, p99_h = _sojourn_p99(bout), _sojourn_p99(hout)
    overhead = float(hout["hedge_cost"].sum()) / max(
        float(hout["cost"].sum()) + float(hout["hedge_cost"].sum()), 1e-12)
    return [
        emit(f"torch_serve_chaos_nohedge_{slots}slots", bus,
             f"sojourn_p99={p99_b:.2f};backlog={bout['final_backlog']:.1f};"
             f"completed={bout['completed'].sum():.1f}"),
        emit(f"torch_serve_chaos_hedge_{slots}slots", hus,
             f"sojourn_p99={p99_h:.2f};backlog={hout['final_backlog']:.1f};"
             f"completed={hout['completed'].sum():.1f};"
             f"hedged_jobs={hout['hedged_jobs'].sum():.2f};"
             f"hedge_overhead={overhead:.4f};"
             f"p99_cut={(p99_b - p99_h) / max(p99_b, 1e-12):.3f}"),
    ]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--quick", action="store_true",
                        help="dispatch-only, fewer slots (no real-execution row)")
    parser.add_argument("--chaos", action="store_true",
                        help="add the degraded-mode pair (stragglers + link faults, "
                             "speculation off and on)")
    parser.add_argument("--flight", default=None, metavar="OUT.jsonl",
                        help="write the staged run's flight-record stream here")
    parser.add_argument("--trace", default=None, metavar="OUT.json",
                        help="write the staged run's Chrome trace (Perfetto) here")
    parser.add_argument("--device", default=None, help="default: cuda")
    parser.add_argument("--record", default=None,
                        help="append the CSV records to this JSON list")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    records = []
    slots = 16 if args.quick else 32

    # Staged dispatch on 8 pods with the sojourn-histogram layer on (the
    # histogram must not perturb the replay or conservation pins).
    tcfg = TelemetryConfig(level=SUMMARY, hist=HistogramSpec())
    eng = build_engine([ARCH], slots, v=1.0, seed=3, arrival=6.0, n_pods=8, admit_max=10.0,
                       telemetry=tcfg, device=dev)
    out, us = _timed_run(eng, execute_real=False)
    check_replay(eng, out)
    check_conservation(out)
    p99 = out["sojourn_percentiles"][0]["p99"]
    records.append(emit(
        f"torch_serve_staged_8pods_{slots}slots", us,
        f"mean_cost={out['mean_cost']:.3e};wan_cost={out['wan_cost'].sum():.3e};"
        f"backlog={out['final_backlog']:.1f};admitted={out['admitted'].sum():.0f};"
        f"rejected={out['rejected'].sum():.0f};sojourn_p99={p99:.2f}",
    ))
    if args.flight or args.trace:
        slo = SloSpec(target=8.0, percentile=99.0)
        recs = fleet_records(out, meta={"slo_backlog": eng.fcfg.slo_backlog}, slo=slo)
        if args.flight:
            write_jsonl(recs, args.flight)
            print(f"flight record -> {args.flight}")
        if args.trace:
            write_chrome_trace(spans_from_records(recs), args.trace)
            print(f"chrome trace  -> {args.trace}")

    # Fleet-scale kernel dispatch: the N = 256 pod grid, one gmsa_score
    # launch per slot.
    grid_slots = 4 if args.quick else 8
    gc = GridConfig()
    omega, pue, r, up, down, layout, shares = make_serve_grid(gc, 2, grid_slots, device=dev)
    rcs = [RequestClass(name=a, cfg=get_arch(a, "smoke"), energy_cfg=get_arch(a, "full"),
                        arrival_rate=40.0) for a in PAIR]
    fc = FleetConfig(n_pods=gc.n_sites, horizon_slots=grid_slots, v=gc.v, seed=1,
                     capacity_shares=shares, dispatch="kernel", admit_max=64.0)
    keng = FleetEngine(fc, rcs, omega, pue, r, up=up, down=down, layout=layout, device=dev)
    kout, kus = _timed_run(keng, execute_real=False)
    check_replay(keng, kout)
    check_conservation(kout)
    records.append(emit(
        f"torch_serve_kernel_{gc.n_sites}pods_{grid_slots}slots", kus,
        f"mean_cost={kout['mean_cost']:.3e};backlog={kout['final_backlog']:.1f};"
        f"admitted={kout['admitted'].sum():.0f}",
    ))

    if args.chaos:
        records.extend(_chaos_arm(dev))

    if not args.quick:
        # Real execution: drained jobs run prefill + decode (smoke model).
        ex = build_engine([ARCH], 8, v=1.0, seed=3, arrival=4.0, device=dev)
        xout, xus = _timed_run(ex, execute_real=True)
        records.append(emit(
            "torch_serve_exec_4pods_8slots", xus,
            f"exec_jobs={xout['exec_jobs']};exec_seconds={xout['exec_seconds']:.2f}",
        ))
    if args.record:
        write_record(args.record, "torch_serve_bench", records, dev)
    return records


if __name__ == "__main__":
    main()
