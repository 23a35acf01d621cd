"""Stage-aware vs. stage-oblivious dispatch on the multi-stage scenario, on the port.

The scenario the base algorithm cannot see: the K = 3 shuffle-heavy
analytics mix of :mod:`repro_torch.configs.facebook_4dc_stages`, where every
job is a 2–3 stage chain and 30–60 GB of intermediate data per job must
cross the WAN between consecutive stages' sites. Both arms run the same
staged engine, pay the same bills and keep the map stage data-local, as the
JAX package's ``benchmarks/jobs_bench.py`` runs them:

* **oblivious** — ``stage_oblivious(gmsa_policy, pin_map=True)``: base GMSA
  picks one manager per type per slot from the aggregate backlog and every
  post-map stage follows it;
* **aware** — ``make_staged_policy(dag, wan)``: each stage's site chosen by
  the drift-plus-penalty score extended with the stage's WAN pull term.

Reports, per arm, the time-averaged total cost (stage compute + shuffle
WAN), the WAN bill and intermediate GB, backlog, jobs completed and the wall
time per Monte-Carlo run, and asserts the reference's two checks: the aware
arm's total cost below the oblivious arm's, and intermediate WAN GB > 0.

    PYTHONPATH=src python -m repro_torch.benchmarks.jobs_bench [--quick]
        [--device cuda] [--telemetry PATH] [--record PATH]

``--quick`` runs 4 runs (else 200, the scenario's own count);
``--telemetry PATH`` writes the TRACE flight record of one aware-arm run
(the scenario's template run) as JSONL, readable with
``python -m repro_torch.telemetry.report PATH --check``; ``--record PATH``
appends the CSV records under the ``torch_jobs_bench`` label.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.benchmarks.common import N_RUNS, emit, timed_compile_sweep, write_record
from repro_torch.configs.facebook_4dc_stages import StagedPaperConfig, make_staged_builder
from repro_torch.core.gmsa import gmsa_policy
from repro_torch.device import resolve_device
from repro_torch.jobs import (
    make_staged_policy,
    simulate_staged,
    simulate_staged_many,
    stage_oblivious,
    summarize_staged,
)

SEED = 0


def run(n_runs: int, device=None) -> dict:
    """Both arms through ``simulate_staged_many`` on ``device`` (``None``:
    CUDA): per arm its summary, µs per run (best of four warm calls) and the
    first call's extra µs; plus the aware arm's saving."""
    dev = resolve_device(device)
    cfg = StagedPaperConfig()
    _, dag, wan, build = make_staged_builder(cfg, device=dev)
    out = {"n_runs": n_runs, "arms": {}}
    arms = {"oblivious": stage_oblivious(gmsa_policy, pin_map=True),
            "aware": make_staged_policy(dag, wan)}
    for name, pol in arms.items():
        outs, us_per_run, first_us = timed_compile_sweep(
            lambda: simulate_staged_many(build, dag, wan, pol,
                                         torch.Generator(device=dev).manual_seed(SEED),
                                         n_runs, cfg.v, device=dev),
            n_runs, dev,
        )
        out["arms"][name] = {"summary": summarize_staged(outs), "us_per_run": us_per_run,
                             "first_call_us": first_us}
    aware, obl = (out["arms"][a]["summary"] for a in ("aware", "oblivious"))
    out["saving_frac"] = 1.0 - aware["time_avg_total_cost"] / obl["time_avg_total_cost"]
    out["wan_gb_saved"] = obl["total_wan_gb"] - aware["total_wan_gb"]
    return out


def verify(result: dict) -> None:
    """The reference's asserts; raises AssertionError (also under ``python -O``)."""
    if not result["saving_frac"] > 0.0:
        raise AssertionError("stage-aware dispatch must beat stage-oblivious total cost on "
                             "the multi-stage scenario")
    if not result["arms"]["aware"]["summary"]["total_wan_gb"] > 0.0:
        raise AssertionError("the multi-stage scenario must report intermediate WAN GB")


def report(result: dict) -> list[dict]:
    """The bench's CSV lines, named as the JAX package names them; returns
    them as records."""
    records = []
    n = result["n_runs"]
    for name, arm in result["arms"].items():
        s = arm["summary"]
        records.append(emit(
            f"jobs_{name}_{n}runs_per_run", arm["us_per_run"],
            f"total_cost={s['time_avg_total_cost']:.1f};"
            f"compute_cost={s['time_avg_compute_cost']:.1f};"
            f"wan_cost={s['time_avg_wan_cost']:.1f};"
            f"wan_gb={s['total_wan_gb']:.0f};"
            f"backlog={s['time_avg_backlog']:.3f};"
            f"completed={s['jobs_completed']:.0f};"
            f"first_call_us={arm['first_call_us']:.0f}",
        ))
    records.append(emit("jobs_aware_saving", 0.0,
                        f"saving_frac={result['saving_frac']:.4f};"
                        f"wan_gb_saved={result['wan_gb_saved']:.0f}"))
    return records


def flight_record(path, device=None, hist=None) -> list[dict]:
    """The aware arm on the scenario's template run at TRACE level -> JSONL
    flight record at ``path``; returns the records. ``hist`` (a
    :class:`~repro_torch.telemetry.HistogramSpec`) adds the per-stage
    queue-delay histograms."""
    from repro_torch.telemetry import TRACE, TelemetryConfig, collect_records, write_jsonl

    dev = resolve_device(device)
    cfg = StagedPaperConfig()
    template, dag, wan, _ = make_staged_builder(cfg, device=dev)
    tcfg = TelemetryConfig(level=TRACE, hist=hist)
    outs, frame = simulate_staged(template, dag, wan, make_staged_policy(dag, wan), None, cfg.v,
                                  telemetry=tcfg)
    records = collect_records(outs, frame, cfg=tcfg, summary=summarize_staged(outs),
                              meta={"bench": "jobs_bench", "arm": "aware"})
    write_jsonl(records, path)
    print(f"# flight record: {len(records)} records -> {path}", flush=True)
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="4 runs")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--telemetry", default=None, metavar="PATH",
                    help="write a TRACE-level JSONL flight record of one aware-arm run to PATH")
    ap.add_argument("--record", default=None, help="append the CSV records to this JSON list")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n_runs = 4 if args.quick else min(N_RUNS, StagedPaperConfig().n_runs)
    result = run(n_runs, dev)
    records = report(result)
    verify(result)
    if args.telemetry:
        flight_record(args.telemetry, dev)
    if args.record:
        write_record(args.record, "torch_jobs_bench", records, dev)
    return result


if __name__ == "__main__":
    main()
