"""repro_torch.jobs — stage-structured geo-analytics jobs.

The paper's GMSA treats a job as one indivisible unit: a single dispatch
fraction per slot, the (K, N, N) ratio tensor silently absorbing where the
map/reduce/aggregation work lands, and the intermediate-data transfer it
implies never modeled or billed. This subsystem makes jobs multi-stage
chains and schedules them jointly with GMSA:

* :mod:`repro_torch.jobs.dag`       — padded stage-DAG representation
  (per-stage compute intensity, shuffle volume/selectivity, chain
  precedence via monotone masks).
* :mod:`repro_torch.jobs.scheduler` — per-slot joint decision rules: map
  pinned to ``data_dist`` locality, downstream stages chosen by the GMSA
  drift-plus-penalty score extended with the intermediate-data WAN energy
  term (priced via :class:`repro_torch.placement.wan.WanModel`); plus the
  ``stage_oblivious`` adapter exposing every base policy — the
  ``gmsa_score`` kernel policy included — to the staged engine.
* :mod:`repro_torch.jobs.engine`    — ``simulate_staged``: per-stage queues
  generalizing Eq. 1, batched over Monte-Carlo runs.

Shuffle-volume/selectivity traces live in :mod:`repro_torch.traces.stages`;
the multi-stage Facebook-4DC scenario in
:mod:`repro_torch.configs.facebook_4dc_stages`; the stage-aware vs.
stage-oblivious comparison in :mod:`repro_torch.benchmarks.jobs_bench`.
"""

from repro_torch.jobs.dag import (
    StageDag,
    chain_dag,
    map_reduce_dag,
    pad_chains,
    shuffle_volumes_from_selectivity,
    single_stage_dag,
    validate_dag,
)
from repro_torch.jobs.engine import (
    StagedOutputs,
    simulate_staged,
    simulate_staged_many,
    summarize_staged,
)
from repro_torch.jobs.scheduler import (
    flow_step,
    hedge_clone_choice,
    make_staged_policy,
    stage_oblivious,
    stage_service_rates,
    stage_service_rates_all,
    staged_dispatch_fn,
    staged_stage_scores,
)

__all__ = [
    "StageDag",
    "chain_dag",
    "map_reduce_dag",
    "pad_chains",
    "shuffle_volumes_from_selectivity",
    "single_stage_dag",
    "validate_dag",
    "StagedOutputs",
    "simulate_staged",
    "simulate_staged_many",
    "summarize_staged",
    "flow_step",
    "hedge_clone_choice",
    "make_staged_policy",
    "stage_oblivious",
    "stage_service_rates",
    "stage_service_rates_all",
    "staged_dispatch_fn",
    "staged_stage_scores",
]
