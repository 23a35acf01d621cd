"""The serving control plane with dense attention classes, against the
reference engine.

``FleetEngine`` with ``qwen2-0.5b`` classes (the smoke model executes, the
full one prices), on the scenario ``tests/test_engine.py``'s fixture builds
(``["qwen2-0.5b"]``, 12 slots, V = 1, seed 3, 4 requests per slot): the
reference's ``build_engine`` draws it, ``bridge.serve_scenario_from_numpy``
carries it into the port's engine. Both dispatch modes run with real
execution, so every drained job is prefilled and decoded through the
port's attention path. The weights differ (threefry against a torch
generator); what execution must agree on is how many jobs ran.

Tolerances are ``tests/test_torch_serve.py``'s (its ``_compare``): dispatch
exact (up to a near-tie of the port's deciding scores), costs, backlogs and
the history's floats RTOL = 1e-5 relative, the WAN bill 1e-6; here no
divergence is allowed at all, since ``exec_jobs`` must be exact; the stream
records' order exact, their floats 1e-5 relative.
"""

import numpy as np
import pytest
import torch

from repro.launch.serve import build_engine as j_build_engine
from repro_torch.bridge import serve_scenario_from_numpy
from repro_torch.configs import get_arch
from repro_torch.launch import serve as tl
from repro_torch.serve import engine as te
from test_torch_serve import RTOL, T, _compare, _np_scenario

torch.set_float32_matmul_precision("highest")

CPU = "cpu"
ARCH = "qwen2-0.5b"


def _engine_pair(dispatch: str, arch: str = ARCH):
    """(reference engine, port engine) on the reference fixture's scenario,
    one class of ``arch`` (smoke executes, full prices)."""
    jeng = j_build_engine([arch], slots=T, v=1.0, seed=3, arrival=4.0, dispatch=dispatch)
    rcs = [te.RequestClass(name=arch, cfg=get_arch(arch, "smoke"),
                           energy_cfg=get_arch(arch, "full"), arrival_rate=4.0)]
    fcfg = te.FleetConfig(n_pods=4, horizon_slots=T, v=1.0, seed=3, dispatch=dispatch)
    teng = te.FleetEngine(fcfg, rcs, np.asarray(jeng.omega), np.asarray(jeng.pue),
                          np.asarray(jeng.r),
                          scenario=serve_scenario_from_numpy(_np_scenario(jeng.scenario), CPU),
                          device=CPU)
    return jeng, teng


@pytest.mark.parametrize("dispatch", ["staged", "kernel"])
def test_dense_engine_matches_reference_with_real_execution(dispatch):
    jeng, teng = _engine_pair(dispatch)
    assert "wq" in teng.params[ARCH]["blocks"]
    j_stream, t_stream = [], []
    jout = jeng.run(execute_real=True, stream=j_stream.append)
    tout = teng.run(execute_real=True, stream=t_stream.append)
    assert _compare(teng, tout, jout) == T
    assert tout["exec_jobs"] == jout["exec_jobs"] > 0
    assert tout["exec_seconds"] > 0.0
    assert [(r["type"], r["t"]) for r in t_stream] == [(r["type"], r["t"]) for r in j_stream]
    for r_t, r_j in zip(t_stream, j_stream):
        assert r_t.keys() == r_j.keys()
        for key, val in r_t.items():
            if isinstance(val, float):
                assert val == pytest.approx(r_j[key], rel=RTOL, abs=1e-12), (r_t["t"], key)
            else:
                assert val == r_j[key], (r_t["t"], key)


def test_dense_classes_execute_every_drained_job_through_attention():
    """``_execute_jobs`` on a qwen2-0.5b class: exactly n_jobs, the last
    batch sliced to the remainder; each prefill fills a KV ring of
    prompt + gen_len slots, and decode advances it gen_len times."""
    _, teng = _engine_pair("kernel")
    rc = teng.classes[0]
    pre = teng._prefill[ARCH]
    seen = []

    def prefill(params, tokens):
        logits, cache = pre(params, tokens)
        seen.append((tokens.shape[0], cache["k"].shape[2], bool(torch.isfinite(logits).all())))
        return logits, cache

    teng._prefill[ARCH] = prefill
    b = teng.fcfg.batch_per_exec
    for n_jobs in (1, b, b + 3):
        seen.clear()
        assert teng._execute_jobs(rc, n_jobs)[0] == n_jobs
        assert seen == [(min(b, n_jobs - i), rc.prompt_len + rc.gen_len, True)
                        for i in range(0, n_jobs, b)]


def test_launcher_default_classes_run_on_the_cpu(capsys):
    """The reference's default ``--classes qwen2-0.5b,granite-3-2b``,
    executing the drained jobs on both smoke models."""
    out = tl.main(["--slots", "4", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "classes=qwen2-0.5b,granite-3-2b" in text and "device=cpu" in text
    assert out["exec_jobs"] > 0 and out["dispatch"].shape == (4, 4, 2, 2)


def test_high_v_prefers_cheap_pods_with_the_reference_class():
    """The reference's ``test_engine::test_high_v_prefers_cheap_pods`` with
    its own ``qwen2-0.5b`` class, on the port's traces."""
    o1 = tl.build_engine([ARCH], slots=24, v=0.001, seed=5, arrival=4.0,
                         device=CPU).run(execute_real=False)
    o2 = tl.build_engine([ARCH], slots=24, v=1000.0, seed=5, arrival=4.0,
                         device=CPU).run(execute_real=False)
    assert o2["mean_cost"] <= o1["mean_cost"] * 1.001
