"""The port's benches (``repro_torch.benchmarks``) on the CPU at a small size.

``fig5.run`` / ``fig6.run`` return the JAX package's output keys, and the
paper's checks (the reference's asserts) hold on the port's own traces at
``RUNS`` = 16 Monte-Carlo runs: on the CPU fig5 gives GMSA cheapest in
99.7% of slots and a V=1 backlog of 6.8, fig6 a 24.7% reduction with both
monotonicity checks, at 16 runs as at 32 and 64. Nothing is written under
``benchmarks/`` or to ``BENCH_sim.json``; a file is written only where the
caller names one.

Each bench's arithmetic is held to the JAX package's bench on the same
inputs: ``python_loop_reference`` on one bridged numpy template, bitwise
(both sides are the same numpy code); fig5's and fig6's derived checks by
feeding the port's own series through the JAX bench's ``run`` with its
simulator stubbed to return them, exactly (both derive the checks in numpy
and Python floats from the same fp32 values). Importing the JAX benches
makes their gitignored ``benchmarks/artifacts/`` directory (their
``common.py`` does so at import); the fixture removes it again when it made
it and it is still empty, and the snapshot counts files.
"""

import collections
import dataclasses
import importlib
import json
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.benchmarks import common, fig5, fig5_traces, fig6, paper_repro, sim_bench
from repro_torch.configs.facebook_4dc import PaperSimConfig, make_sim_builder
from repro_torch.core.gmsa import dispatch_fn
from repro_torch.core.simulator import simulate

ROOT = Path(__file__).resolve().parents[1]
ART = ROOT / "benchmarks" / "artifacts"
RUNS = 16
CPU = "cpu"

FIG5_KEYS = {"n_runs", "per_policy_us", "checks", "series"}
FIG5_CHECKS = {"frac_slots_gmsa_cheapest", "gmsa_v1_max_avg_backlog", "slope_data",
               "slope_random", "slope_gmsa_v1"}
FIG6_KEYS = {"n_runs", "v_grid", "gmsa", "baselines", "sweep_grid", "checks", "total_us"}
FIG6_CHECKS = {"cost_monotone_nonincreasing", "backlog_monotone_nondecreasing",
               "baseline_cost", "best_gmsa_cost", "reduction_at_v100", "greedy_floor_cost",
               "backlog_crossing_v"}
FIG6_SWEEP = {"grid_us_per_run", "grid_compile_us", "percell_us_per_run", "percell_compile_us"}


def _snapshot():
    """Every file under benchmarks/ and BENCH_sim.json: (size, mtime)."""
    files = sorted(p for p in (ROOT / "benchmarks").rglob("*") if p.is_file())
    files.append(ROOT / "BENCH_sim.json")
    return {str(p): (p.stat().st_size, p.stat().st_mtime_ns) for p in files if p.exists()}


@pytest.fixture
def untouched():
    before = _snapshot()
    yield
    assert _snapshot() == before, "a port bench wrote under benchmarks/ or to BENCH_sim.json"


@pytest.fixture(scope="module")
def jax_benches():
    """The JAX package's bench modules (fig5, fig6, sim_bench), imported
    from the repo root."""
    made_art = not ART.exists()
    sys.path.insert(0, str(ROOT))
    try:
        yield types.SimpleNamespace(**{
            name: importlib.import_module(f"benchmarks.{name}")
            for name in ("fig5", "fig6", "sim_bench")})
    finally:
        sys.path.remove(str(ROOT))
        if made_art and ART.is_dir() and not any(ART.iterdir()):
            ART.rmdir()


#: The fields of the simulator's outputs that the figures read.
_Outs = collections.namedtuple("_Outs", "cost backlog_avg")


def _jax_outs(cost, backlog):
    """Outputs whose mean over the leading runs axis is (cost, backlog)."""
    as_runs = lambda x: jnp.asarray(np.asarray(x, np.float32))[None]
    return _Outs(as_runs(cost), as_runs(backlog))


def test_fig5_checks_match_jax_bench(untouched, jax_benches, tmp_path, monkeypatch):
    result = fig5.run(RUNS, device=CPU)
    jfig5 = jax_benches.fig5
    name_of = {id(pol): name for name, pol in jfig5.POLICIES.items()}
    series = result["series"]
    monkeypatch.setattr(jfig5, "ART", tmp_path)
    monkeypatch.setattr(jfig5, "make_sim_builder", lambda cfg: (None, None))
    monkeypatch.setattr(jfig5, "simulate_many", lambda build, pol, key, n: _jax_outs(
        series[name_of[id(pol)]]["cost"], series[name_of[id(pol)]]["backlog"]))
    want = jfig5.run(1)["checks"]
    assert result["checks"] == want
    assert fig5.derived_checks(
        {k: {kk: np.asarray(vv, np.float32) for kk, vv in v.items()} for k, v in series.items()},
        PaperSimConfig().t_slots) == want


def test_fig6_checks_match_jax_bench(untouched, jax_benches, tmp_path, monkeypatch):
    result = fig6.run(RUNS, device=CPU)
    jfig6 = jax_benches.fig6
    rows, base = result["gmsa"], result["baselines"]
    name_of = {id(jfig6.data_dispatch): "DATA", id(jfig6.random_dispatch): "RANDOM",
               id(jfig6.greedy_cost_dispatch): "GREEDY"}

    def sweep_grid(build, policy, key, n_runs, v_grid):
        return _Outs(*(jnp.asarray([[rows[v][f]] for v in v_grid], jnp.float32)
                       for f in ("cost", "backlog")))

    def simulate_many(build, policy, key, n_runs, scalar=None):
        # GMSA at one V (the per-cell pass) or a baseline
        row = rows[scalar] if scalar is not None else base[name_of[id(policy)]]
        return _jax_outs([row["cost"]], [row["backlog"]])

    monkeypatch.setattr(jfig6, "ART", tmp_path)
    monkeypatch.setattr(jfig6, "make_sim_builder", lambda cfg: (None, None))
    monkeypatch.setattr(jfig6, "sweep_grid", sweep_grid)
    monkeypatch.setattr(jfig6, "simulate_many", simulate_many)
    want = jfig6.run(1)["checks"]
    assert result["checks"] == want
    assert fig6.derived_checks(rows, base) == want


def test_fig5_keys_and_paper_checks(untouched, tmp_path):
    out = tmp_path / "fig5.json"
    result = fig5.run(RUNS, device=CPU, out=out)
    assert set(result) == FIG5_KEYS and set(result["checks"]) == FIG5_CHECKS
    assert set(result["series"]) == set(fig5.POLICIES) == {"GMSA_V1", "GMSA_V10", "DATA", "RANDOM"}
    for s in result["series"].values():
        assert set(s) == {"cost", "backlog"} and len(s["cost"]) == PaperSimConfig().t_slots
    assert result["n_runs"] == RUNS
    fig5.verify(result)
    assert json.loads(out.read_text())["checks"] == result["checks"]
    names = [r["name"] for r in fig5.report(result)]
    assert names == ["fig5a_cost_along_time", "fig5b_backlog_along_time"]


def test_fig5_traces_cross_and_seeds(untouched):
    """On one engine the cross is fig5.run itself; another trace_seed draws
    other traces."""
    [row] = fig5_traces.cross(RUNS, engines=(CPU,))
    assert (row["source"], row["engine"]) == (CPU, CPU) and row["asserts_hold"]
    assert row["checks"] == fig5.run(RUNS, device=CPU)["checks"]
    own, other = fig5_traces.seeds(RUNS, [PaperSimConfig().trace_seed, 1], engines=(CPU,))
    assert own["checks"] == row["checks"] and own["mean_cost"] == row["mean_cost"]
    assert other["trace_seed"] == 1 and other["mean_cost"] != own["mean_cost"]


def test_fig6_keys_and_paper_checks(untouched):
    result = fig6.run(RUNS, device=CPU)
    assert set(result) == FIG6_KEYS and set(result["checks"]) == FIG6_CHECKS
    assert set(result["sweep_grid"]) == FIG6_SWEEP
    assert result["v_grid"] == list(fig6.V_GRID) == [0.001, 0.01, 0.1, 1.0, 10.0, 100.0, 1000.0]
    assert set(result["gmsa"]) == set(fig6.V_GRID)
    assert set(result["baselines"]) == {"DATA", "RANDOM", "GREEDY"}
    fig6.verify(result)
    names = [r["name"] for r in fig6.report(result)]
    assert names == ["fig6a_cost_vs_V", "fig6b_backlog_vs_V", "fig6_grid_vs_percell"]
    bad = {**result, "checks": {**result["checks"], "reduction_at_v100": 0.1}}
    with pytest.raises(AssertionError, match="30% reduction"):
        fig6.verify(bad)


def test_python_loop_reference_matches_jax_bench(untouched, jax_benches):
    from repro.configs.facebook_4dc import PaperSimConfig as JaxPaperSimConfig
    from repro.configs.facebook_4dc import make_sim_builder as jax_make_sim_builder

    template, _ = jax_make_sim_builder(dataclasses.replace(JaxPaperSimConfig(), t_slots=96))
    bridged = types.SimpleNamespace(**{f: np.asarray(getattr(template, f)) for f in
                                       ("arrivals", "mu", "omega", "pue", "r", "p_it")})
    for v in (0.1, 1.0, 100.0):
        assert sim_bench.python_loop_reference(bridged, v) == \
            jax_benches.sim_bench.python_loop_reference(bridged, v)


def test_sim_bench_rows_and_python_loop_reference(untouched):
    records = sim_bench.run((4,), device=CPU)
    assert [r["name"] for r in records] == [
        "sim_python_loop_1run", "sim_jit_scan_1run", "sim_vmap_4runs_per_run"]
    assert all(r["us_per_call"] > 0 for r in records)
    # The numpy loop is the engine's arithmetic: same decisions, same bill.
    cfg = dataclasses.replace(PaperSimConfig(), t_slots=96)
    template, _ = make_sim_builder(cfg, device=CPU)
    cost, backlog = sim_bench.python_loop_reference(template, 1.0)
    outs = simulate(template, dispatch_fn(1.0), None, 1.0)
    np.testing.assert_allclose(cost, float(outs.cost.double().mean()), rtol=1e-5)
    np.testing.assert_allclose(backlog, float(outs.q_final.sum()), rtol=1e-5)


def test_paper_repro_and_record_writer(untouched, tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    paper_repro.main(["--runs", "8", "--device", CPU])
    text = capsys.readouterr().out
    assert "device: cpu" in text and "reduction" in text and "GMSA cheapest in" in text
    assert list(tmp_path.iterdir()) == []
    path = tmp_path / "records.json"
    rec = common.emit("x_bench", 12.5, "a=1.5;b=on;c=30%")
    assert rec == {"name": "x_bench", "us_per_call": 12.5,
                   "derived": {"a": 1.5, "b": "on", "c": 30.0}}
    for label in ("torch_a", "torch_b"):
        common.write_record(path, label, [rec], torch.device(CPU))
    history = json.loads(path.read_text())
    assert [h["label"] for h in history] == ["torch_a", "torch_b"]
    assert history[0]["backend"] == "cpu" and history[0]["torch_version"] == torch.__version__
    assert history[0]["benches"] == [rec] and "git_sha" in history[0]
    assert list(tmp_path.iterdir()) == [path]


def test_jobs_bench_quick_asserts_records_and_flight_record(untouched, tmp_path, capsys):
    """``python -m repro_torch.benchmarks.jobs_bench --device cpu --quick``:
    the JAX bench's rows, its two asserts, a flight record that passes
    ``report --check`` and a record under the ``torch_jobs_bench`` label."""
    from repro_torch.benchmarks import jobs_bench
    from repro_torch.telemetry import report

    fr, rec = tmp_path / "fr.jsonl", tmp_path / "records.json"
    result = jobs_bench.main(["--device", CPU, "--quick", "--telemetry", str(fr),
                              "--record", str(rec)])
    assert result["n_runs"] == 4 and set(result["arms"]) == {"oblivious", "aware"}
    assert result["saving_frac"] > 0.0
    history = json.loads(rec.read_text())
    assert [h["label"] for h in history] == ["torch_jobs_bench"]
    assert [b["name"] for b in history[0]["benches"]] == [
        "jobs_oblivious_4runs_per_run", "jobs_aware_4runs_per_run", "jobs_aware_saving"]
    assert report.main([str(fr), "--check"]) == 0
    assert "cross-check [OK] kind=staged" in capsys.readouterr().out
    bad = {**result, "saving_frac": -0.01}
    with pytest.raises(AssertionError, match="stage-aware"):
        jobs_bench.verify(bad)
    no_gb = {**result, "arms": {**result["arms"], "aware": {
        **result["arms"]["aware"],
        "summary": {**result["arms"]["aware"]["summary"], "total_wan_gb": 0.0}}}}
    with pytest.raises(AssertionError, match="WAN GB"):
        jobs_bench.verify(no_gb)
