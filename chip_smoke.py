#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one line or more; any failure exits non-zero:

1. device  — require CUDA; print the card's name and power limit.
2. build   — compile every kernel from ``src/repro_torch/kernels/*/csrc``
             with nvcc (all sources at once) into ``build/torch_kernels/``.
3. kernels — each kernel against its plain PyTorch version on the card,
             at the test shapes and each main path's (fleet, fleet V-sweep,
             the serving engine's one-run (K, N) = (8, 256)):
             accuracy, argmin agreement up to near-ties, exact ties to the
             lowest index, bitwise-repeatable launches; ``gmsa_score``'s
             cost workspace against the plain two-phase version at every
             shape; device time per launch (CUDA-graph replay, CUDA events)
             beside the plain version and the bound, each of its two
             kernels' mean time over five profiled calls beside that
             phase's own bound, and the wrapper's host cost per call; the
             edges of a captured call (is the programmatic launch kept?);
             and with one ratio tensor per run at the placement controller's
             (R, K, N) = (100, 8, 256): scores, cost workspace and argmin
             against both plain versions, a non-contiguous r, each kernel's
             time against its bound, the matvec's ``torch.matmul`` time.
4. lockstep — full fleet_256 (N=256, K=8, T=288, 100 runs): every slot,
             kernel and plain decisions on the same state; decisions that
             differ off a near-tie must number 0. Queues step with the
             kernel's decision.
5. end to end — ``simulate_many`` at full fleet_256 through
             ``make_kernel_policy(None)``: the kernel's launch count must
             rise by exactly T; outputs finite; wall time per call; the
             same run with ``impl="ref"`` for agreement.
6. paper   — facebook_4dc, 200 runs: GMSA V=1, GMSA V=100, DATA, RANDOM,
             and GMSA V=1 through the kernel policy.
7. ssd_scan — the Mamba-2 SSD chain against its plain sequential version
             (and the plain chunked form where the loop is too slow): the
             test shapes in fp32 and bf16 on unit-normal inputs, then with
             the model's own input ranges a ragged S, chunk 24, the serving
             shape, a prefill_32k sequence and the serving engine's 32-token
             prefills (timed at B = 4); bitwise-repeatable launches;
             at the serving shape every workspace of the chain (cum, CBᵀ,
             entering states) against the plain phase-by-phase version;
             device time beside the plain versions and the bound, and each
             of the chain's five kernels' mean time over three profiled calls.
8. mamba2  — full-width, full-depth mamba2-2.7b (random fp32 weights from a
             seeded generator) served through ``make_local_exec`` as the
             reference's ``FleetEngine._execute_jobs`` does: 4 x 2048-token
             prompts + 16 greedy tokens, then 1 x 1000 + 8. Exactly 64
             kernel launches per prefill, finite logits, prefill + decode
             agreeing with a one-token-longer prefill, layer 0's real SSD
             operands through the kernel against the plain version; wall
             times, the kernel's share of prefill device time, peak memory.
9. sweep   — full fleet_256 through ``sweep_grid(make_kernel_policy(None))``
             over fig6's seven V: the V x R = 700 lanes fold into the
             kernel's runs axis, so its launch count must rise by exactly T
             per call; each lane's decisions and final queues bitwise equal
             to ``simulate_many`` at its V with the same seed, its sums
             within 1e-6; mean cost non-increasing in V (1% slack, as
             fig6); wall per call beside the seven per-point calls, device
             busy share, the kernel's time in the call, the stride-0 mu
             copy per slot, peak memory.
10. figures — the paper's Figs. 5 and 6 at the paper's 1000 runs through
             ``repro_torch.benchmarks.fig5`` / ``fig6``, gated by the
             reference's asserts; each check printed beside the value the
             JAX package recorded (BENCH_sim.json; read, not gated), and
             fig6's grid-vs-per-cell timing.
11. telemetry — fleet_256 ``simulate_many`` with SUMMARY telemetry and
             histograms: outputs bitwise equal to the OFF call, per-site
             backlog summing to the total backlog, every (run, site)
             histogram counting T slots; the wall it adds.
12. staged — stage-structured jobs (``repro_torch.jobs``): (a) the staged
             paper scenario (facebook_4dc_stages, canonical mix, 200 runs)
             through ``repro_torch.benchmarks.jobs_bench``, gated by the
             reference's asserts (aware cheaper than oblivious, WAN GB > 0),
             each arm beside the JAX package's recorded values (read, not
             gated); (b) full fleet_256 (R = 100) with a drawn K = 8, S = 3
             mix on the fleet's backbone through
             ``stage_oblivious(make_kernel_policy(None), pin_map=True)``:
             exactly T kernel launches per ``simulate_staged_many`` call, 0
             off-tie decision mismatches against the plain version in
             lockstep, ``single_stage_dag`` through the kernel equal to
             ``simulate`` (dispatch and queues bitwise, sums within 1e-6),
             wall per call, device busy share, peak memory, and the
             stage-aware arm at the same size; (c) one aware-arm paper run's
             TRACE flight record through ``collect_records`` ->
             ``write_jsonl`` -> ``python -m repro_torch.telemetry.report
             --check``, which must exit 0.
13. placement — the two-timescale controller (``repro_torch.placement``):
             (a) the paper scenario (facebook_4dc, N = 4, the table path)
             through ``repro_torch.benchmarks.placement_bench`` at 1000 runs,
             drifting and under the ForestCity loss, gated by the reference's
             assert (adaptive cheaper than static), each saving beside the
             JAX package's CPU record (read, not gated), and its
             epoch x move-budget sweep at 64 runs per cell; (b) full
             fleet_256 placed (N = 256, K = 8, T = 288, R = 100, W = 48,
             drifting ingest toward the priciest sites) through
             ``make_kernel_policy(None)``: drifting, a permanent site loss at
             slot 144, and one call with stragglers, link faults and regions
             at once — exactly T kernel launches per call, 0 off-tie
             mismatches in lockstep against the plain version and against
             the table policy (``gmsa_policy`` on the controller's energy
             rows) with and without the loss, W = T equal to ``simulate``,
             an all-ones alive mask bitwise equal to none, every bill
             finite; wall per call, device busy share, peak memory, static
             against adaptive; (c) ``sweep_placed_budgets`` over three move
             budgets (T launches per call, each lane's decisions, queues and
             layouts bitwise the per-budget call's, sums within 1e-6); (d)
             one fleet run's TRACE flight record through ``report --check``.
14. serve  — the serving control plane (``repro_torch.serve.FleetEngine``):
             (a) the fleet serving grid (``make_serve_grid``: N = 256 pods,
             K = 8 mamba2-2.7b classes priced on the full model, 40
             requests per class per slot capped at 64, T = 288) with
             ``dispatch="kernel"``, dispatch only: exactly T ``gmsa_score``
             launches per run, the replay pin against ``simulate_staged``
             (dispatch and WAN bill bitwise), 0 off-tie mismatches in
             lockstep against the plain version, request conservation, a pod
             death at slot 144 (the recovery event in the history and the
             stream in slot order, drained > 0, the dead pod's queues 0
             after it), an all-ones alive mask bitwise equal to none, the
             sojourn histogram holding the completed mass with outputs
             bitwise the OFF run's, a flight record through ``report
             --check``; wall per run, device busy share, the host's time per
             slot, peak memory; (b) full-width mamba2-2.7b (random fp32
             weights) executing the drained jobs of a 4-pod, 6-slot run:
             exact ``exec_jobs``, 64 ``ssd_scan`` launches per executed
             prefill batch, finite logits, tokens in vocabulary; seconds per
             job and per slot, ``ssd_scan``'s share of an executed batch's
             device time; (c) ``python -m repro_torch.launch.serve --classes
             mamba2-2.7b --slots 24 --pods 8 --dispatch kernel`` as a
             subprocess, exit 0.
15. dense — the dense attention family (``repro_torch.models.attention``,
             plain PyTorch as in the JAX package; no kernel of its own):
             (a) ``attend_blockwise`` against ``attend_naive`` on the card at
             granite-3-2b's prefill shape (4 x 2048, 32 heads on 8 KV heads,
             d 64, causal) and at a ragged padded one (S 1000, bidirectional,
             window 256), within ATTN_TOL; each one's time beside
             ``F.scaled_dot_product_attention``'s at the same shape
             (measured, not used by the port); (b) full-width, full-depth
             qwen2-0.5b and granite-3-2b (random fp32 weights), one after the
             other, served through ``make_local_exec``: exact parameter
             counts, 4 x 2048-token prompts + 16 greedy tokens and 1 x 1000
             + 8, no NaN logit, prefill + decode against a one-token-longer
             prefill within DECODE_REL_TOL; prefill wall per batch, decode
             wall per token, device busy share, the top kernels and
             attention's share of prefill device time, peak memory; (c)
             ``FleetEngine`` with the launcher's default classes at full
             width, ``dispatch="kernel"``, executing the drained jobs of a
             4-pod, 6-slot run: one ``gmsa_score`` launch per slot, no
             ``ssd_scan``, exact ``exec_jobs``, conservation; seconds per job
             and per slot; (d) ``python -m repro_torch.launch.serve`` with
             its default classes as a subprocess, exit 0.
16. moe_hybrid — the MoE and hybrid families (``repro_torch.models.moe``,
             plain PyTorch as in the JAX package; the hybrid's SSM through
             ``ssd_scan`` at 50 heads x 64, state 16): (a) full-width,
             full-depth deepseek-moe-16b (random fp32 weights, 62.9 GiB)
             served through ``make_local_exec``: 4 x 2048-token prompts + 16
             greedy tokens, finite logits, pos 2064, no kernel launched, the
             summed router aux of a forward finite and > 0; prefill wall,
             decode wall per token and launches per token, the GEMM kernels'
             share of prefill device time, one MoE layer's expert GEMMs and
             routing/dispatch by kernel name, peak memory; then layer 0's
             ``moe_ffn`` on 1 x 256 tokens on the card and on the CPU with
             the same weights (expert indices equal off near-ties, the same
             dropped pairs, output within MODEL_TOL, aux within AUX_RTOL,
             bitwise-repeatable on the card); (b) phi3.5-moe at its
             published widths, 8 of its 32 layers, 4 x 2048 + 8, the same
             records and (a)'s first gates; (c) full-width, full-depth
             hymba-1.5b, 4 x 2048 + 16 (its 1024-slot ring wraps): 32
             ``ssd_scan`` launches per prefill, decode consistent with a
             one-token-longer prefill within DECODE_REL_TOL, ``ssd_scan``'s
             share of prefill device time; (d) ``FleetEngine`` on phase 14's
             N = 4, T = 6 execution run, ``dispatch="kernel"``, once with
             deepseek-moe-16b alone and once with hymba-1.5b and qwen2-0.5b,
             the card freed between: one ``gmsa_score`` launch per slot,
             ``ssd_scan`` 32 per hymba batch, exact ``exec_jobs``,
             conservation; seconds per job. Phase 7 holds ``ssd_scan`` at
             hymba's three shapes and times its 4 x 2048 prefill.
17. results — one JSON line of per-kernel numbers, then the device line.

Numbers are measured on whatever card runs this; the bound uses the H100
SXM's published peaks (3.35 TB/s, 67 TFLOP/s fp32) at its 700 W limit.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12

#: (R runs or None, K, N, r per run): the test shape set, the fleet
#: main-path shape, the largest kernel-bench shape, the fleet V-sweep's (7 V
#: x 100 runs folded into one runs axis) and, last, the placement
#: controller's per-run ratios. Each later shape is appended, so that the
#: shapes before it draw the same operands as before it was added.
SCORE_SHAPES = [
    (None, 1, 4, False), (None, 4, 17, False), (None, 8, 128, False), (None, 8, 256, False),
    (None, 9, 129, False), (None, 16, 256, False), (100, 8, 256, False), (1, 128, 1024, False),
    (700, 8, 256, False), (100, 8, 256, True),
]
MAIN_SHAPE = (100, 8, 256, False)
#: The serving engine's kernel dispatch: one run, no runs axis (phase 14).
SCORE_SERVE_SHAPE = (None, 8, 256, False)
SWEEP_SHAPE = (700, 8, 256, False)
#: (R, K, N) with one (K, N, N) ratio tensor per run: the placement
#: controller's fleet shape after its first epoch boundary.
PER_RUN_SHAPE = (100, 8, 256, True)
BENCH_SHAPE = (1, 128, 1024, False)
#: Scores against the one-phase gmsa_score_ref, at every shape: within
#: SCORE_RTOL of the size of the terms, a * (|q| + |mu| + |vp * cost|). Where
#: q - mu + vp * cost cancels, each side's fp32 rounding is an ulp of those
#: terms, not of the score (at 700 x 8 x 256 draws the plain version itself
#: is 1.5e-3 off the fp64 value there), so a bound relative to |s| cannot
#: hold. Against gmsa_score_phases_ref (the kernel's own arithmetic: cost
#: bitwise, one rounding of vp * cost + q - mu) the scores are held to
#: SCORE_RTOL + SCORE_RTOL * |s| as well.
SCORE_RTOL = 1e-4   # fp32, different summation order (test_kernels.py's tolerance)
#: The cost workspace against gmsa_score_phases_ref: both sum in fp64 and
#: round once to fp32, so they differ by an ulp at most (1e-6 relative).
SCORE_COST_RTOL = 1e-6
#: gmsa_score's two kernels, in launch order (``gmsa_<phase>_kernel``).
SCORE_PHASES = ("cost", "pick")
TIE_RTOL = 1e-5     # a differing argmin is a near-tie if its plain score is this close
TIE_ATOL = 1e-4

#: (B, S, H, P, N, chunk) of tests/test_kernels.py's ssd_scan tests, on
#: unit-normal inputs: fp32 3e-4, bf16 5e-2 (that file's tolerances; the
#: chunked and sequential forms round differently in fp32, bf16 rounds y).
SSD_TEST_SHAPES = [
    (1, 32, 2, 8, 16, 8), (2, 128, 3, 64, 128, 128), (1, 72, 2, 32, 64, 16),
    (2, 64, 2, 16, 32, 16),
]
SSD_TEST_TOL = {"float32": 3e-4, "bfloat16": 5e-2}
#: With the model's input ranges (dt in [1e-3, 0.1], A in [-16, -1], silu'd
#: x, B, C): a ragged S, chunk 24, the serving shape of phase 8, one
#: prefill_32k sequence (checked against the plain chunked form only: the
#: 32768-step loop is too slow), and the serving engine's 32-token prompts
#: (phase 14) at B = 1 and 4 with the chunk the model uses, min(256, S) =
#: 32, and B = 4 padded to chunk 256; then hymba-1.5b's SSM branch (50 heads
#: x 64, state 16: phase 16): its 4 x 2048 prefill, a ragged S and the
#: serving engine's 32-token prompts. fp32, summation orders differ: 1e-4.
SSD_MODEL_SHAPES = [
    (1, 2000, 80, 64, 128, 256), (2, 200, 80, 64, 128, 24),
    (4, 2048, 80, 64, 128, 256), (1, 32768, 80, 64, 128, 256),
    (1, 32, 80, 64, 128, 32), (4, 32, 80, 64, 128, 32), (4, 32, 80, 64, 128, 256),
    (4, 2048, 50, 64, 16, 256), (1, 2000, 50, 64, 16, 256), (4, 32, 50, 64, 16, 32),
]
SSD_SERVE_SHAPE = (4, 2048, 80, 64, 128, 256)
#: The serving engine's executed prefill batch (phase 14): 4 x 32 tokens,
#: chunk min(256, 32).
SSD_ENGINE_SHAPE = (4, 32, 80, 64, 128, 32)
#: Shapes timed beside the plain sequential version and the bound, each
#: with its tag in the kernels line and CUDA-graph (reps, replays): the
#: serving engine's prefill batch, and hymba-1.5b's 4 x 2048 prefill
#: (phase 16).
SSD_TIMED = {SSD_ENGINE_SHAPE: ("serve", 20, 10), (4, 2048, 50, 64, 16, 256): ("hybrid", 5, 4)}
SSD_MODEL_TOL = 1e-4
#: The chain's kernels, in launch order (``ssd_scan_<phase>_kernel``).
SSD_PHASES = ("cumsum", "chunk_cb", "chunk_state", "state_pass", "chunk_scan")
#: Workspaces against ssd_scan_phases_ref: the fp64 cumsum differs only in
#: summation order (1e-12 relative); CBᵀ and the entering states are fp32
#: sums in another order (1e-4 relative to max(|plain|, 1)).
SSD_CUM_RTOL = 1e-12
SSD_WORKSPACE_TOL = 1e-4
MAMBA_ARCH = "mamba2-2.7b"
MAMBA_PARAMS = 2_702_640_640
DECODE_REL_TOL = 1e-3   # prefill+decode vs longer prefill, relative to max |logit|
#: A sweep lane's per-slot sums against simulate_many at its V: the same
#: elementwise arithmetic, reduced over a larger batch (relative to max(|x|, 1)).
SWEEP_SUM_RTOL = 1e-6
#: The paper's checks as the JAX package recorded them on the CPU
#: (BENCH_sim.json, labels fig5/fig6), printed beside the port's for reading;
#: the random streams differ, so they are not gates.
RECORDED_CHECKS = {"frac_slots_gmsa_cheapest": 0.986, "gmsa_v1_max_avg_backlog": 4.7,
                   "reduction_at_v100": 0.276}
FIGURE_RUNS = 1000
#: The staged paper scenario's figures as the JAX package recorded them on
#: the CPU (BENCH_sim.json, jobs_*_50runs): printed beside the port's for
#: reading; the card draws its own traces, so they are not gates.
RECORDED_JOBS = {"saving_frac": 0.0131, "oblivious": 3827.2, "aware": 3777.2}
#: The fleet staged mix: K = 8 job types of up to S = 3 stages, drawn from
#: this seed; 100 GB inputs; shuffle WAN at 0.03 job-energy per GB.
STAGED_MIX_SEED = 17
STAGED_S_MAX = 3
#: simulate_staged over single_stage_dag against simulate: the per-slot sums
#: are the same fp32 values reduced over (N, K, 1) after the loop instead of
#: (N, K) per slot (relative to max(|x|, 1)).
STAGED_IDENTITY_RTOL = 1e-6
#: The placement scenario as the JAX package's placement_bench recorded it
#: on the CPU (BENCH_sim.json, placement_adaptive_saving and
#: placement_fault_adaptive_saving): printed beside the port's, not gated.
RECORDED_PLACEMENT = {"drifting": 0.154, "fault": 0.091}
PLACEMENT_PAPER_RUNS = 1000
PLACEMENT_SWEEP_RUNS = 64
#: fleet_256 placed: W = 48 slots per epoch, a drifting ingest walk (seed 7,
#: pull 0.5 toward the day-mean omega * PUE), 25% fresh ingest and 5% growth
#: per epoch, the biggest attractor lost at slot 144 for good; the degraded
#: call's straggler / link-fault seed (sites die with 5% of straggler
#: onsets; links degrade, none is severed); the budget sweep.
PLACED_W = 48
PLACED_INGEST_SEED = 7
PLACED_FAULT_SLOT = 144
PLACED_DEGRADED_SEED = 23
PLACED_REGIONS = 8
PLACED_BUDGETS = (0.25, 0.5, 1.0)
#: PlacedOutputs fields that do not depend on dispatch under the adaptive
#: rule: the layouts, their ratios and every WAN, sync and recovery bill.
PLACED_LAYOUT_FIELDS = ("placements", "r_trace", "wan_cost", "wan_energy", "wan_gb",
                        "wan_latency_s", "sync_cost", "recovery_cost", "recovery_gb", "mu_scale")
#: Controller sums against simulate (W = T) and budget lanes against their
#: per-budget calls: the same fp32 values reduced over another shape.
PLACED_SUM_RTOL = 1e-6
#: The fleet serving grid (phase 14): fleet_256's K = 8 classes of
#: mamba2-2.7b (smoke executes, full prices) at 40 requests per slot each,
#: admission capped at 64, a day of slots; a pod dies at slot 144. The
#: full-width execution run: one class, N = 4 pods, 6 slots.
SERVE_ARRIVAL = 40.0
SERVE_ADMIT_MAX = 64.0
SERVE_FAULT_SLOT = 144
SERVE_EXEC = {"pods": 4, "slots": 6, "seed": 3, "arrival": 4.0, "admit_max": 5.0}
#: Phase 15, the dense attention family: the serving launcher's default
#: classes at their published widths, with their exact parameter counts.
DENSE_ARCHS = {"qwen2-0.5b": 494_032_768, "granite-3-2b": 2_533_787_648}
#: (B, S, H, Hkv, d, causal, window): granite-3-2b's prefill shape, then a
#: ragged one (S = 1000: 24 padded keys in the last chunk), bidirectional
#: and windowed.
DENSE_ATTN_SHAPES = [(4, 2048, 32, 8, 64, True, 0), (4, 1000, 32, 8, 64, False, 256)]
#: Blockwise against naive attention on the card, both fp32 with TF32 off:
#: outputs are convex mixes of unit-normal values, only the reduction order
#: differs (online rescaling over 1024-key chunks against one softmax over
#: every key); bf16 would miss this by two orders of magnitude.
ATTN_TOL = 5e-5
#: (requests, prompt tokens, generated tokens) per served batch, as phase 8.
DENSE_BATCHES = [(4, 2048, 16), (1, 1000, 8)]
#: Phase 16, the MoE and hybrid families at their published widths: arch ->
#: (exact parameter count at full depth, layers run, (requests, prompt
#: tokens, generated tokens)). phi3.5-moe is 156 GiB in fp32 at its 32
#: layers: it runs 8 (4.84 GiB a layer); the others run at full depth.
MOE_HYBRID_ARCHS = {
    "deepseek-moe-16b": (16_879_568_896, 28, (4, 2048, 16)),
    "phi3.5-moe-42b-a6.6b": (41_873_051_648, 8, (4, 2048, 8)),
    "hymba-1.5b": (1_641_432_320, 32, (4, 2048, 16)),
}
#: The one-layer card-against-CPU MoE gate: deepseek-moe-16b's layer 0
#: (2.06 GiB of experts, copied to the CPU) on 1 x 256 tokens (C = 32: pairs
#: drop). Expert indices equal off near-ties (two router probabilities among
#: a token's top k + 1 within TOPK_TIE: fp32 softmax of logits summed in
#: another order differs by ulps of 1); dropped pairs equal; output within
#: MODEL_TOL (relative to max(|y|, 1): tests/test_models.py's model
#: tolerance); aux within AUX_RTOL relative (the same fp32 sums).
MOE_GATE_TOKENS = 256
TOPK_TIE = 1e-6
MODEL_TOL = 2e-4
AUX_RTOL = 1e-6
#: Phase 16 (d): the serving execution run of phase 14 with these classes,
#: one run each, the card freed between them (deepseek's 62.9 GiB of
#: weights fill it).
MOE_HYBRID_SERVE = (("deepseek-moe-16b",), ("hymba-1.5b", "qwen2-0.5b"))


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def device_time_ms(fn, reps: int = 20, iters: int = 20) -> float:
    """Device time per call of ``fn()``: ``reps`` calls captured in one CUDA
    graph, replayed ``iters`` times between CUDA events, so the host's
    per-call launch cost is out of the measurement."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def call_time_ms(fn, iters: int = 200) -> float:
    """Host wall time per back-to-back call of ``fn()``, as a Python loop
    pays it (launch cost included), ending in a synchronize."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def bound_ms(nbytes: int, flops: int) -> tuple[float, str]:
    """The larger of bytes over the H100's memory rate and fp32 operations
    over its fp32 rate, in ms, and which of the two it is."""
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def score_bound_ms(runs: int, k: int, n: int, r_runs: int = 1) -> tuple[float, str]:
    """Least time for one gmsa_score launch: each input (``r_runs`` ratio
    tensors: 1 shared or one per run) read once, each output written once,
    against the H100's memory rate and fp32 rate."""
    nbytes = (4 * (r_runs * k * n * n + 2 * runs * k * n + runs * k + k + n)
              + 4 * (runs * k * n + runs * k))
    return bound_ms(nbytes, 2 * r_runs * k * n * n + 4 * runs * k * n)


def score_phase_bounds_ms(runs: int, k: int, n: int, r_runs: int = 1) -> dict[str, tuple[float, str]]:
    """Each of gmsa_score's phases on its own bytes, read and written once:
    cost reads r and wpue and writes the (r_runs, K, N) workspace; pick
    reads q, mu, a, vp and the workspace and writes scores and best."""
    ws = r_runs * k * n
    return {
        "cost": bound_ms(4 * (r_runs * k * n * n + n + ws), 2 * r_runs * k * n * n),
        "pick": bound_ms(4 * (2 * runs * k * n + runs * k + k + ws + runs * k * n + runs * k),
                         4 * runs * k * n),
    }


def ssd_bound_ms(b: int, s: int, h: int, p: int, n: int, q: int,
                 itemsize: int) -> tuple[float, str]:
    """Least time for one ssd_scan call: x, dt, a, B, C read once, y and
    h_final written once; the work the function needs — CBᵀ once per
    (b, chunk) (all heads share it), the causal half of W @ x, C @ h_inᵀ and
    the state update — against the H100's memory rate and fp32 rate."""
    full, rem = divmod(s, q)
    pairs = full * q * (q + 1) // 2 + rem * (rem + 1) // 2   # (t, s') with s' <= t
    nbytes = itemsize * (2 * b * s * h * p + 2 * b * s * n) + 4 * (b * s * h + h + b * h * p * n)
    flops = 2 * pairs * b * n + 2 * pairs * b * h * p + 4 * b * s * h * p * n
    return bound_ms(nbytes, flops)


def rel_err(got, want) -> float:
    """max |got - want| / max(|want|, 1), elementwise, in fp32."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / want.abs().clamp_min(1.0)).max())


def kernel_counters():
    """Every kernel's launch counter, by name (what a main path reads)."""
    from repro_torch.kernels.gmsa_score.kernel import gmsa_score_cuda
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda

    return {"gmsa_score": gmsa_score_cuda, "ssd_scan": ssd_scan_cuda}


def reset_counts() -> None:
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in kernel_counters().items()}


def off_tie_mismatches(best, best_ref, s_ref):
    """Count decisions that differ where the plain scores are not a near-tie."""
    import torch

    picked = torch.gather(s_ref, -1, best.long().unsqueeze(-1)).squeeze(-1)
    low = s_ref.min(dim=-1).values
    near = (picked - low).abs() <= TIE_ATOL + TIE_RTOL * low.abs()
    return int(((best != best_ref) & ~near).sum())


def score_inputs(gen, runs, k, n, device, per_run_r: bool = False):
    """Operands in the simulator's layout: q, mu are (R, N, K) read through
    a transposed (R, K, N) view, a is a strided slot column; r is (K, N, N),
    or (R, K, N, N) with ``per_run_r``."""
    import torch

    batch = () if runs is None else (runs,)
    rand = lambda *s: torch.rand(s, generator=gen, device=device)
    q = (rand(*batch, n, k) * 100).mT
    mu = (rand(*batch, n, k) * 50).mT
    a = (rand(*batch, 2, k) * 40)[..., 1, :]
    vp = rand(k) * 10
    r_shape = (batch if per_run_r else ()) + (k, n, n)
    g = torch._standard_gamma(torch.ones(r_shape, device=device), generator=gen)
    r = g / g.sum(-1, keepdim=True)
    wpue = rand(n) * 20
    return q, mu, a, vp, r, wpue


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return smi


def ptxas_usage(text: str) -> list[str]:
    """One line per kernel function from an ``nvcc -Xptxas -v`` log: its
    name (with ``<bf16>`` for the bf16 instantiation, ``<true>`` or ``<2>``
    for a bool or int template argument), registers, spill stores and
    loads, shared memory."""
    import re

    rows = []
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            mangled = m.group(1)
            short = re.search(r"\d+((?:ssd_scan|gmsa)\w*?_kernel)(?:IL([bi])(\d+)E)?", mangled)
            name = short.group(1) if short else mangled
            if short and short.group(2):
                arg = short.group(3)
                name += f"<{('false', 'true')[int(arg)] if short.group(2) == 'b' else arg}>"
            rows.append({"name": name + ("<bf16>" if "bfloat16" in mangled else "")})
        elif rows and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            rows[-1]["spills"] = f"spill stores {m.group(1)} B, spill loads {m.group(2)} B"
        elif rows and (m := re.search(r"Used (\d+) registers", line)):
            smem = re.search(r"(\d+) bytes smem", line)
            rows[-1]["regs"] = f"{m.group(1)} registers"
            rows[-1]["smem"] = f"{smem.group(1) if smem else 0} B static smem"
    return [", ".join(r.get(k, f"{k} not reported") for k in ("name", "regs", "spills", "smem"))
            for r in rows]


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    secs = time.perf_counter() - t0
    for name, text in logs.items():
        for usage in ptxas_usage(text):
            log(f"[build] {name}: ptxas {usage}")
    log(f"[build] {len(logs)} kernel(s) built in {secs:.2f} s -> {_build.BUILD_DIR}")


def phase_times(fn, calls: int, kernels: dict[str, str]) -> tuple[dict[str, float | None], float]:
    """``calls`` calls of ``fn()`` under torch.profiler: for each phase, the
    mean device time per launch (ms) of the kernels whose name holds
    ``kernels[phase]``, None where the trace shows none, and the sum of
    those means."""

    def run():
        for _ in range(calls):
            fn()

    _, events = device_profile(run)
    phase = {}
    for ph, name in kernels.items():
        hits = [(us, c) for k, us, c in events if name in k]
        count = sum(c for _, c in hits)
        phase[ph] = sum(us for us, _ in hits) / count / 1e3 if count else None
    return phase, sum(v for v in phase.values() if v is not None)


def graph_edges(fn) -> str:
    """Capture two calls of ``fn()`` in a CUDA graph, as ``device_time_ms``
    does, and count the graph's edges by type (``cuGraphGetEdges_v2`` from
    libcuda): whether stream capture kept a programmatic dependent launch
    as a programmatic edge. "not measured" where this torch or libcuda
    lacks the calls."""
    import ctypes

    import torch

    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        get_edges = ctypes.CDLL("libcuda.so.1").cuGraphGetEdges_v2
    except (TypeError, OSError, AttributeError) as exc:
        return f"not measured ({exc})"

    class EdgeData(ctypes.Structure):
        _fields_ = [("from_port", ctypes.c_ubyte), ("to_port", ctypes.c_ubyte),
                    ("type", ctypes.c_ubyte), ("reserved", ctypes.c_ubyte * 5)]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        fn()
        fn()
    handle, count = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    get_edges.restype = ctypes.c_int
    rc = get_edges(handle, None, None, None, ctypes.byref(count))
    frm, to = (ctypes.c_void_p * count.value)(), (ctypes.c_void_p * count.value)()
    data = (EdgeData * count.value)()
    rc = rc or get_edges(handle, frm, to, data, ctypes.byref(count))
    if rc:
        return f"not measured (cuGraphGetEdges_v2 returned {rc})"
    kinds = [(d.type, d.from_port) for d in data[:count.value]]
    prog = sum(t == 1 for t, _ in kinds)
    return (f"{count.value} edges, {prog} programmatic (type, from_port): "
            + ", ".join(f"({t}, {p})" for t, p in kinds))


def phase_kernels(dev):
    import torch

    from repro_torch.configs.fleet_256 import FleetConfig, make_score_operands
    from repro_torch.kernels.gmsa_score.kernel import _gmsa_score_cuda_phases, gmsa_score_cuda
    from repro_torch.kernels.gmsa_score.ref import gmsa_score_phases_ref, gmsa_score_ref

    gen = torch.Generator(device=dev).manual_seed(0)
    worst_rel, worst_cost, main, sweep, bench, per_run = 0.0, 0.0, None, None, None, None
    serve = None
    for runs, k, n, per_run_r in SCORE_SHAPES:
        key = (runs, k, n, per_run_r)
        r_runs = runs if per_run_r else 1
        shape = f"R={runs} K={k} N={n}" + (f", r per run ({runs}, {k}, {n}, {n})"
                                           if per_run_r else "")
        ops = score_inputs(gen, runs, k, n, dev, per_run_r=per_run_r)
        cost, s, b = _gmsa_score_cuda_phases(*ops)
        s2, b2 = gmsa_score_cuda(*ops)
        s_ref, b_ref = gmsa_score_ref(*ops)
        cost_ref, s_ph, _ = gmsa_score_phases_ref(*ops)
        torch.cuda.synchronize()
        if not (torch.equal(s, s2) and torch.equal(b, b2)):
            fail(f"gmsa_score launches differ bitwise at {shape}")
        if per_run_r:
            if tuple(cost.shape) != (runs, k, n):
                fail(f"gmsa_score per-run r: cost workspace shape {tuple(cost.shape)}")
            r = ops[4]
            r_strided = r.transpose(0, 1).contiguous().transpose(0, 1)   # same values, not contiguous
            s3, b3 = gmsa_score_cuda(*ops[:4], r_strided, ops[5])
            if not (torch.equal(s, s3) and torch.equal(b, b3)):
                fail(f"gmsa_score: a non-contiguous per-run r differs from its contiguous copy "
                     f"at {shape}")
            del r_strided, s3, b3, r
        cost_rel = float(((cost - cost_ref).abs() / cost_ref.abs().clamp_min(1.0)).max())
        worst_cost = max(worst_cost, cost_rel)
        if cost_rel > SCORE_COST_RTOL:
            fail(f"gmsa_score cost workspace off gmsa_score_phases_ref by {cost_rel:.3e} "
                 f"(relative) at {shape}")
        err_ph = (s - s_ph).abs()
        if bool((err_ph > SCORE_RTOL + SCORE_RTOL * s_ph.abs()).any()):
            fail(f"gmsa_score scores off gmsa_score_phases_ref by {float(err_ph.max())} at {shape}")
        err = (s - s_ref).abs()
        q, mu, a, vp = ops[:4]
        terms = a.abs().unsqueeze(-1) * (q.abs() + mu.abs()
                                         + (vp.unsqueeze(-1) * cost_ref).abs())
        err_terms = float((err / terms.clamp_min(1e-30)).max())
        if bool((err > SCORE_RTOL * terms).any()):
            fail(f"gmsa_score scores off by {float(err.max())}, {err_terms:.3e} of the terms' "
                 f"size, at {shape}")
        rel = float((err / s_ref.abs().clamp_min(1.0)).max())
        worst_rel = max(worst_rel, rel)
        mism = off_tie_mismatches(b, b_ref, s_ref)
        if mism:
            fail(f"gmsa_score argmin differs off near-ties ({mism}) at {shape}")
        if key == MAIN_SHAPE:
            log(f"[kernels] gmsa_score {shape}, two calls captured in a CUDA graph: "
                f"{graph_edges(lambda: gmsa_score_cuda(*ops))}")
        t_k = device_time_ms(lambda: gmsa_score_cuda(*ops))
        t_p = device_time_ms(lambda: gmsa_score_ref(*ops))
        c_k = call_time_ms(lambda: gmsa_score_cuda(*ops))
        bound, bound_by = score_bound_ms(runs or 1, k, n, r_runs=r_runs)
        phase, total = phase_times(lambda: gmsa_score_cuda(*ops), 5,
                                   {ph: f"gmsa_{ph}_kernel" for ph in SCORE_PHASES})
        phase_bounds = score_phase_bounds_ms(runs or 1, k, n, r_runs=r_runs)
        log(f"[kernels] gmsa_score {shape}: max_abs_err {float(err.max()):.3e} "
            f"max_rel_err {rel:.3e}, {err_terms:.3e} of the terms' size (tol {SCORE_RTOL:g})"
            f", vs gmsa_score_phases_ref max_abs_err {float(err_ph.max()):.3e}, "
            f"cost workspace {cost_rel:.3e} (tol "
            f"{SCORE_COST_RTOL:g}) | device: kernels {t_k * 1e3:.2f} us, plain "
            f"{t_p * 1e3:.2f} us, bound {bound * 1e3:.3f} us ({bound_by}; at "
            f"{100 * bound / t_k:.1f}% of it) | host wall per wrapper call {c_k * 1e3:.2f} us")
        log(f"[kernels] gmsa_score {shape}: five calls under torch.profiler, mean per launch: "
            + ", ".join(f"{ph} " + ("not measured" if phase[ph] is None else
                                    f"{phase[ph] * 1e3:.2f} us (bound {phase_bounds[ph][0] * 1e3:.3f}"
                                    f" us, {phase_bounds[ph][1]})") for ph in SCORE_PHASES)
            + f"; sum {total * 1e3:.2f} us. The pick kernel launches under the cost kernel "
            f"(programmatic launch), so its span includes its wait; the call's device time "
            f"beyond the cost kernel is "
            + ("not measured" if phase["cost"] is None else f"{(t_k - phase['cost']) * 1e3:.2f} us"))
        if key == MAIN_SHAPE:
            r_mat, w = ops[4], ops[5]
            t_mv = device_time_ms(lambda: torch.mv(r_mat.view(k * n, n), w))
            log(f"[kernels] yardstick for the matvec part alone, torch.mv((K*N, N), N) "
                f"at K={k} N={n}: {t_mv * 1e3:.2f} us (not the same function)")
            main = {"max_abs_err": float(err.max()), "ms": t_k, "plain_ms": t_p,
                    "bound_ms": bound, "bound_by": bound_by, "phase_ms": phase}
        if key == SWEEP_SHAPE:
            sweep = {"ms_sweep": t_k, "plain_ms_sweep": t_p, "bound_ms_sweep": bound,
                     "phase_ms_sweep": phase}
        if key == BENCH_SHAPE:
            bench = {"ms_bench": t_k, "plain_ms_bench": t_p, "bound_ms_bench": bound,
                     "phase_ms_bench": phase}
        if key == SCORE_SERVE_SHAPE:
            serve = {"ms_serve": t_k, "plain_ms_serve": t_p, "bound_ms_serve": bound,
                     "phase_ms_serve": phase, "host_ms_serve": c_k}
        if key == PER_RUN_SHAPE:
            r_mat = ops[4].view(runs * k * n, n)
            t_lib = device_time_ms(lambda: torch.matmul(r_mat, ops[5]))
            nbytes = 4 * runs * k * n * n
            log(f"[kernels] gmsa_score {shape}: r alone {nbytes / 1e6:.1f} MB, "
                f"{nbytes / (t_k * 1e-3) / 1e9:.0f} GB/s over the call; a non-contiguous r gives "
                f"the same bits; library matvec torch.matmul(r.view(R*K*N, N), wpue) "
                f"{t_lib * 1e3:.2f} us")
            per_run = {"ms_per_run_r": t_k, "plain_ms_per_run_r": t_p,
                       "bound_ms_per_run_r": bound, "bound_by_per_run_r": bound_by,
                       "library_ms_per_run_r": t_lib, "phase_ms_per_run_r": phase,
                       "max_abs_err_per_run_r": float(err.max())}
            del r_mat
        del ops, q, mu, a, vp, terms, cost, s, b, s2, b2, s_ref, b_ref, cost_ref, s_ph
    torch.cuda.empty_cache()

    # Exact ties go to the lowest index; a = 0 rows pick index 0.
    q, mu, a, vp, r, wpue = (x.contiguous() for x in score_inputs(gen, 4, 8, 256, dev))
    lo, hi = 37, 201
    q[..., lo] = -1e4
    q[..., hi], mu[..., hi], r[:, hi, :] = q[..., lo], mu[..., lo], r[:, lo, :]
    a[:, 3] = 0.0
    _, b = gmsa_score_cuda(q, mu, a, vp, r, wpue)
    want = torch.full_like(b, lo)
    want[:, 3] = 0
    if not torch.equal(b, want):
        fail(f"gmsa_score tie-break: got {b.tolist()}")
    flat = torch.ones(2, 8, 256, device=dev)
    _, b = gmsa_score_cuda(flat, flat, a[:2], vp, r[:, :1, :].expand(8, 256, 256).contiguous(), wpue)
    if bool(b.any()):
        fail("gmsa_score: all-equal scores must pick index 0")
    log("[kernels] exact ties -> lowest index; a=0 rows -> index 0; launches bitwise repeatable")

    # A developed fleet backlog (the kernel-bench operands).
    q, mu, a, vp, r, wpue, _ = make_score_operands(FleetConfig(), device=dev)
    s, b = gmsa_score_cuda(q, mu, a, vp, r, wpue)
    s_ref, b_ref = gmsa_score_ref(q, mu, a, vp, r, wpue)
    mism = off_tie_mismatches(b, b_ref, s_ref)
    rel = float(((s - s_ref).abs() / s_ref.abs().clamp_min(1.0)).max())
    worst_rel = max(worst_rel, rel)
    if mism:
        fail(f"gmsa_score on fleet operands: {mism} off-tie argmin mismatches")
    log(f"[kernels] fleet_256 developed-backlog operands: max_rel_err {rel:.3e}, "
        f"argmin agrees up to near-ties")
    main["max_rel_err"] = worst_rel
    main["workspace_rel_err"] = worst_cost
    main.update(sweep)
    main.update(bench)
    main.update(per_run)
    main.update(serve)
    return main


def phase_lockstep(dev):
    import torch

    from repro_torch.configs.fleet_256 import FleetConfig, make_fleet_builder
    from repro_torch.core.simulator import energy_tables, slot_step
    from repro_torch.kernels.gmsa_score.kernel import gmsa_score_cuda
    from repro_torch.kernels.gmsa_score.ref import gmsa_score_ref

    cfg = FleetConfig()
    _, build_inputs = make_fleet_builder(cfg, device=dev)
    inputs = build_inputs(torch.Generator(device=dev).manual_seed(1), cfg.n_runs)
    wpue = inputs.omega * inputs.pue
    e_cost, e_raw = energy_tables(inputs.r, wpue, inputs.pue, inputs.p_it)
    vp = cfg.v * inputs.p_it
    q = torch.zeros(cfg.n_runs, cfg.n_sites, cfg.k_types, device=dev)
    idx = torch.arange(cfg.n_sites, device=dev)[:, None]
    mism = torch.zeros((), dtype=torch.int64, device=dev)
    flips = torch.zeros((), dtype=torch.int64, device=dev)
    worst = torch.zeros((), device=dev)
    for t in range(cfg.t_slots):
        a_t, mu_t = inputs.arrivals[:, t], inputs.mu[:, t]
        s, b = gmsa_score_cuda(q.mT, mu_t.mT, a_t, vp, inputs.r, wpue[t])
        s_ref, b_ref = gmsa_score_ref(q.mT, mu_t.mT, a_t, vp, inputs.r, wpue[t])
        picked = torch.gather(s_ref, -1, b.long().unsqueeze(-1)).squeeze(-1)
        low = s_ref.min(dim=-1).values
        near = (picked - low).abs() <= TIE_ATOL + TIE_RTOL * low.abs()
        diff = b != b_ref
        mism += (diff & ~near).sum()
        flips += (diff & near).sum()
        worst = torch.maximum(worst, ((s - s_ref).abs() / s_ref.abs().clamp_min(1.0)).max())
        f = (idx == b.unsqueeze(-2)).to(torch.float32)
        q, _ = slot_step(q, f, a_t, mu_t, e_cost[t], e_raw[t])
    torch.cuda.synchronize()
    decisions = cfg.t_slots * cfg.n_runs * cfg.k_types
    log(f"[lockstep] fleet_256 N={cfg.n_sites} K={cfg.k_types} T={cfg.t_slots} "
        f"R={cfg.n_runs}: {decisions} decisions, off-tie mismatches {int(mism)}, "
        f"near-tie flips {int(flips)}, max_rel_err {float(worst):.3e}, "
        f"final mean backlog {float(q.mean()):.3f}")
    if int(mism) != 0:
        fail(f"lockstep: {int(mism)} off-tie decision mismatches")
    if not bool(torch.isfinite(q).all()):
        fail("lockstep: non-finite backlog")
    return int(mism), float(worst)


def device_profile(fn) -> tuple[float, list[tuple[str, float, int]]]:
    """One call of ``fn()`` under torch.profiler: (wall seconds, [(kernel
    name, device µs, count)] sorted by device time, largest first)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device-side events only: a CPU op also reports its kernels' time.
    # (torch < 2.4 names the field self_cuda_time_total.)
    dev_time = lambda e: getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0.0)
    events = [(e.key, dev_time(e), e.count) for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    return wall, sorted(events, key=lambda e: -e[1])


def device_busy_share(fn) -> str:
    """Share of one call's wall time the card spent in kernels, from
    torch.profiler, with gmsa_score's two kernels summed, or "not measured"
    when the trace shows no device time."""
    wall, events = device_profile(fn)
    dev_us = sum(us for _, us, _ in events)
    if dev_us <= 0:
        return "not measured"
    kernels = ", ".join(f"{k[:40]} {us / 1e3:.2f} ms x{c}" for k, us, c in events[:4])
    score = [(us, c) for k, us, c in events
             if any(f"gmsa_{ph}_kernel" in k for ph in SCORE_PHASES)]
    return (f"device busy {dev_us / 1e3:.2f} ms of {wall * 1e3:.2f} ms wall under the "
            f"profiler ({100 * dev_us / 1e6 / wall:.1f}%); gmsa_score kernels "
            f"{sum(us for us, _ in score) / 1e3:.2f} ms x{sum(c for _, c in score)}; "
            f"top: {kernels}")


def phase_end_to_end(dev):
    import torch

    from repro_torch.configs.fleet_256 import FleetConfig, make_fleet_builder
    from repro_torch.core.gmsa import make_kernel_policy
    from repro_torch.core.simulator import simulate_many, summarize

    cfg = FleetConfig()
    _, build_inputs = make_fleet_builder(cfg, device=dev)
    policy = make_kernel_policy(None)
    run = lambda p: simulate_many(
        build_inputs, p, torch.Generator(device=dev).manual_seed(7), cfg.n_runs, cfg.v,
        device=dev,
    )

    torch.cuda.synchronize()
    reset_counts()
    outs = run(policy)
    torch.cuda.synchronize()
    counts = read_counts()
    launches = counts["gmsa_score"]
    log(f"[e2e] simulate_many fleet_256 R={cfg.n_runs} T={cfg.t_slots}: "
        f"launches {counts}")
    if launches != cfg.t_slots:
        fail(f"end to end: kernel launched {launches} times, expected {cfg.t_slots}")
    for name, x in outs._asdict().items():
        if not bool(torch.isfinite(x).all()):
            fail(f"end to end: non-finite {name}")
    if tuple(outs.f_trace.shape) != (cfg.n_runs, cfg.t_slots, cfg.n_sites, cfg.k_types):
        fail(f"end to end: f_trace shape {tuple(outs.f_trace.shape)}")
    log(f"[e2e] summarize: {json.dumps(summarize(outs))}")

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run(policy)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    log(f"[e2e] wall per simulate_many call (calls 2-4): "
        f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms; median "
        f"{statistics.median(walls) * 1e3:.1f} ms")
    log(f"[e2e] {device_busy_share(lambda: run(policy))}")
    mem0 = torch.cuda.max_memory_allocated()
    log(f"[e2e] peak device memory so far {mem0 / 2**30:.2f} GiB")

    outs_ref = run(make_kernel_policy(None, impl="ref"))
    agree = float((outs.f_trace == outs_ref.f_trace).all(dim=-2).float().mean())
    c_k, c_r = float(outs.cost.mean()), float(outs_ref.cost.mean())
    log(f"[e2e] impl='ref' run: dispatch agreement {agree:.6f}, time-avg cost "
        f"kernel {c_k:.4f} vs plain {c_r:.4f} (rel diff {abs(c_k - c_r) / abs(c_r):.3e})")
    return launches, statistics.median(walls)


def phase_paper(dev):
    import torch

    from repro_torch.configs.facebook_4dc import PaperSimConfig, make_sim_builder
    from repro_torch.core.baselines import data_dispatch, random_dispatch
    from repro_torch.core.gmsa import dispatch_fn, make_kernel_policy
    from repro_torch.core.simulator import simulate_many, summarize

    cfg = PaperSimConfig()
    _, build_inputs = make_sim_builder(cfg, device=dev)
    runs = 200
    arms = [
        ("GMSA V=1", dispatch_fn(1.0), 1.0),
        ("GMSA V=100", dispatch_fn(100.0), 100.0),
        ("DATA", data_dispatch, 0.0),
        ("RANDOM", random_dispatch, 0.0),
        ("GMSA V=1 kernel", make_kernel_policy(None), 1.0),
    ]
    res, outs = {}, {}
    for name, policy, v in arms:
        gen = torch.Generator(device=dev).manual_seed(0)
        t0 = time.perf_counter()
        outs[name] = simulate_many(build_inputs, policy, gen, runs, v, device=dev)
        res[name] = summarize(outs[name])
        log(f"[paper] {name:<16} avg cost $/slot {res[name]['time_avg_cost']:9.3f}  "
            f"avg backlog {res[name]['time_avg_backlog']:8.3f}  "
            f"({(time.perf_counter() - t0) * 1e3:.0f} ms)")
    agree = float((outs["GMSA V=1"].f_trace == outs["GMSA V=1 kernel"].f_trace)
                  .all(dim=-2).float().mean())
    log(f"[paper] GMSA V=1 kernel policy vs table policy: dispatch agreement {agree:.6f}")
    if agree < 0.99:
        fail(f"paper: kernel policy agrees with the table policy on only {agree:.4f}")
    best = min(res["GMSA V=1"]["time_avg_cost"], res["GMSA V=100"]["time_avg_cost"])
    for base in ("DATA", "RANDOM"):
        if not best < res[base]["time_avg_cost"]:
            fail(f"paper: cheapest GMSA arm {best:.3f} does not beat {base}")
    if not res["GMSA V=1"]["time_avg_backlog"] < 50.0:
        fail(f"paper: GMSA V=1 backlog {res['GMSA V=1']['time_avg_backlog']:.3f} >= 50")


def ssd_inputs(gen, b, s, h, p, n, dtype, dev, model_like: bool):
    """SSD operands: unit-normal (as tests/test_kernels.py makes them), or in
    the model's own ranges — dt log-uniform in [1e-3, 0.1] and A in
    [-16, -1] (the init of dt_bias and a_log), x, B, C through silu."""
    import torch
    import torch.nn.functional as F

    rn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    if model_like:
        u = lambda *shape: torch.rand(shape, generator=gen, device=dev)
        dt = torch.exp(u(b, s, h) * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        a = -(1.0 + 15.0 * u(h))
        x, bm, cm = F.silu(rn(b, s, h, p)), F.silu(rn(b, s, n)), F.silu(rn(b, s, n))
    else:
        x, dt, a = rn(b, s, h, p), F.softplus(rn(b, s, h)), -torch.exp(rn(h))
        bm, cm = rn(b, s, n), rn(b, s, n)
    return x.to(dtype), dt, a, bm.to(dtype), cm.to(dtype)


def is_ssd_kernel(name: str) -> bool:
    """Whether a profiler kernel name is one of the ssd_scan chain's."""
    return any(f"ssd_scan_{ph}_kernel" in name for ph in SSD_PHASES)


def check_ssd_workspaces(ops, q, shape: str) -> dict[str, float]:
    """Every workspace of one chain call against the plain phase-by-phase
    version on the same inputs; fails beyond the stated tolerances."""
    import torch

    from repro_torch.kernels.ssd_scan.kernel import _ssd_scan_cuda_phases
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_phases_ref

    got = _ssd_scan_cuda_phases(*ops, q)
    want = ssd_scan_phases_ref(*ops, q)
    torch.cuda.synchronize()
    y, hf, cum, g, h_in = got
    y_r, hf_r, cum_r, g_r, h_in_r = want
    tri = torch.ones(q, q, dtype=torch.bool, device=g.device).tril()
    tiny = torch.finfo(torch.float64).tiny
    errs = {
        "cum": float(((cum - cum_r).abs() / cum_r.abs().clamp_min(tiny)).max()),
        "G": rel_err(g[..., tri], g_r[..., tri]),
        "h_in": rel_err(h_in, h_in_r),
        "y": rel_err(y, y_r),
        "h_final": rel_err(hf, hf_r),
    }
    log(f"[ssd] {shape}: workspaces vs ssd_scan_phases_ref: cum {errs['cum']:.3e} "
        f"(tol {SSD_CUM_RTOL:g} relative), G {errs['G']:.3e}, h_in {errs['h_in']:.3e}, "
        f"y {errs['y']:.3e}, h_final {errs['h_final']:.3e} (tol {SSD_WORKSPACE_TOL:g})")
    if errs["cum"] > SSD_CUM_RTOL or max(v for k, v in errs.items() if k != "cum") > SSD_WORKSPACE_TOL:
        fail(f"ssd_scan workspaces off the plain phase version at {shape}: {errs}")
    return errs


def phase_ssd_kernel(dev):
    import torch

    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.models.ssm import ssd_chunked

    gen = torch.Generator(device=dev).manual_seed(3)
    cases = [(shape, dname, False, SSD_TEST_TOL[dname])
             for shape in SSD_TEST_SHAPES for dname in ("float32", "bfloat16")]
    cases += [(shape, "float32", True, SSD_MODEL_TOL) for shape in SSD_MODEL_SHAPES]
    worst, main, long_run, timed = {"float32": 0.0, "bfloat16": 0.0}, None, None, {}
    for (b, s, h, p, n, q), dname, model_like, tol in cases:
        dtype = getattr(torch, dname)
        ops = ssd_inputs(gen, b, s, h, p, n, dtype, dev, model_like)
        y, hf = ssd_scan(*ops, chunk=q)
        y2, hf2 = ssd_scan(*ops, chunk=q)
        torch.cuda.synchronize()
        shape = f"B={b} S={s} H={h} P={p} N={n} chunk={q} {dname}" + (
            " model-range" if model_like else " unit-normal")
        if not (torch.equal(y, y2) and torch.equal(hf, hf2)):
            fail(f"ssd_scan launches differ bitwise at {shape}")
        long_seq = s > 4096
        plain = "ssd_chunked" if long_seq else "ssd_scan_ref"
        y_ref, h_ref = ssd_chunked(*ops, q) if long_seq else ssd_scan_ref(*ops)
        err_y, err_h = rel_err(y, y_ref), rel_err(hf, h_ref)
        abs_y = float((y.float() - y_ref.float()).abs().max())
        msg = (f"[ssd] {shape}: vs {plain} y max_rel_err {err_y:.3e} (max_abs {abs_y:.3e}), "
               f"h_final max_rel_err {err_h:.3e}, tol {tol:g}")
        if (b, s, h, p, n, q) == SSD_SERVE_SHAPE:
            y_c, h_c = ssd_chunked(*ops, q)
            msg += (f"; vs ssd_chunked y {rel_err(y, y_c):.3e} h_final {rel_err(hf, h_c):.3e}; "
                    f"ssd_chunked vs ssd_scan_ref y {rel_err(y_c, y_ref):.3e}")
            del y_c, h_c
        log(msg)
        if max(err_y, err_h) > tol:
            fail(f"ssd_scan off its plain version at {shape}: y {err_y:.3e}, h {err_h:.3e}")
        worst[dname] = max(worst[dname], err_y, err_h)
        del y, hf, y2, hf2, y_ref, h_ref
        if (b, s, h, p, n, q) == SSD_SERVE_SHAPE:
            ws_errs = check_ssd_workspaces(ops, q, shape)
            torch.cuda.empty_cache()
        if model_like and (b, s, h, p, n, q) in SSD_TIMED:
            tag, reps, iters = SSD_TIMED[(b, s, h, p, n, q)]
            t_k = device_time_ms(lambda: ssd_scan_cuda(*ops, q), reps=reps, iters=iters)
            _, events = device_profile(lambda: ssd_scan_ref(*ops))
            t_p = sum(us for _, us, _ in events) / 1e3
            bound, bound_by = ssd_bound_ms(b, s, h, p, n, q, dtype.itemsize)
            log(f"[ssd] {shape}: device: kernel chain {t_k * 1e3:.2f} us, plain sequential "
                f"{t_p * 1e3:.1f} us (profiler device sum), bound {bound * 1e3:.3f} us "
                f"({bound_by}; chain at {100 * bound / t_k:.1f}% of it)")
            timed.update({f"ms_{tag}": t_k, f"plain_ms_{tag}": t_p, f"bound_ms_{tag}": bound,
                          f"bound_by_{tag}": bound_by, f"max_abs_err_{tag}": abs_y})
        if model_like and ((b, s, h, p, n, q) == SSD_SERVE_SHAPE or long_seq):
            t_k = device_time_ms(lambda: ssd_scan_cuda(*ops, q), reps=5, iters=4)
            t_c = device_time_ms(lambda: ssd_chunked(*ops, q), reps=1, iters=3)
            bound, bound_by = ssd_bound_ms(b, s, h, p, n, q, dtype.itemsize)
            phase, total = phase_times(lambda: ssd_scan_cuda(*ops, q), 3,
                                       {ph: f"ssd_scan_{ph}_kernel" for ph in SSD_PHASES})
            line = (f"[ssd] {shape}: device: kernel chain {t_k:.3f} ms, plain chunked {t_c:.3f} "
                    f"ms, bound {bound:.3f} ms ({bound_by}; chain at "
                    f"{100 * bound / t_k:.1f}% of it)")
            log(f"[ssd] {shape}: chain calls under torch.profiler, mean per launch by phase: "
                + ", ".join(f"{ph} " + ("not measured" if ms is None else f"{ms:.4f} ms")
                            for ph, ms in phase.items())
                + f"; total {total:.4f} ms")
            if not long_seq:
                # The sequential plain version is ~14k small launches: its
                # device time is the profiler's sum over one call.
                _, events = device_profile(lambda: ssd_scan_ref(*ops))
                t_p = sum(us for _, us, _ in events) / 1e3
                c_k = call_time_ms(lambda: ssd_scan(*ops, chunk=q), iters=10)
                line += (f", plain sequential {t_p:.3f} ms (profiler device sum) | host "
                         f"wall per wrapper call {c_k:.3f} ms")
                main = {"max_abs_err": abs_y, "ms": t_k, "plain_ms": t_p,
                        "plain_chunked_ms": t_c, "bound_ms": bound, "bound_by": bound_by,
                        "phase_ms": phase}
            else:
                long_run = {"ms_32k": t_k, "plain_chunked_ms_32k": t_c, "bound_ms_32k": bound,
                            "phase_ms_32k": phase}
            log(line)
        del ops
    torch.cuda.empty_cache()
    log(f"[ssd] launches bitwise repeatable at every shape; worst max_rel_err fp32 "
        f"{worst['float32']:.3e}, bf16 {worst['bfloat16']:.3e}")
    main["max_rel_err_fp32"], main["max_rel_err_bf16"] = worst["float32"], worst["bfloat16"]
    main["workspace_rel_err"] = ws_errs
    main.update(long_run)
    main.update(timed)
    return main


def phase_mamba2(dev, smi):
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.models.lm import count_params, init_params, ssd_layer_inputs
    from repro_torch.serve.step import make_local_exec

    cfg = get_arch(MAMBA_ARCH)
    if count_params(cfg) != MAMBA_PARAMS:
        fail(f"{MAMBA_ARCH}: {count_params(cfg)} parameters, expected {MAMBA_PARAMS}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), torch.float32,
                         device=dev)
    torch.cuda.synchronize()
    log(f"[mamba2] {MAMBA_ARCH} full width and depth ({cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.ssm_heads} heads x {cfg.ssm_head_dim}, state {cfg.ssm_state}): "
        f"{MAMBA_PARAMS} random fp32 params initialised on the card in "
        f"{time.perf_counter() - t0:.2f} s")

    vocab = cfg.vocab_size
    gen = torch.Generator(device=dev).manual_seed(11)
    batches = [(4, 2048, 16), (1, 1000, 8)]   # (requests, prompt tokens, generated)
    tokens = [torch.randint(0, vocab, (b, s + 1), generator=gen, device=dev)
              for b, s, _ in batches]
    execs = [make_local_exec(cfg, g, device=dev) for _, _, g in batches]

    def serve(i):
        """One batch as the reference's FleetEngine._execute_jobs runs it."""
        (b, s, gen_len), (prefill_fn, decode_fn) = batches[i], execs[i]
        before = kernel_counters()["ssd_scan"].launches
        t0 = time.perf_counter()
        logits, cache = prefill_fn(params, tokens[i][:, :s])
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        per_prefill = kernel_counters()["ssd_scan"].launches - before
        finite = torch.isfinite(logits).all()
        tok = torch.argmax(logits[:, -1:, :vocab], dim=-1)
        t0 = time.perf_counter()
        for _ in range(gen_len):
            logits, cache = decode_fn(params, cache, tok)
            finite = finite & torch.isfinite(logits).all()
            tok = torch.argmax(logits[:, :, :vocab], dim=-1)
        torch.cuda.synchronize()
        return per_prefill, bool(finite), t_pre, (time.perf_counter() - t0) / gen_len

    # The main path: both batches, every counter read around them.
    torch.cuda.synchronize()
    reset_counts()
    runs = [serve(i) for i in range(len(batches))]
    torch.cuda.synchronize()
    counts = read_counts()
    for (b, s, g), (per_prefill, finite, t_pre, t_dec) in zip(batches, runs):
        log(f"[mamba2] served {b} x {s}-token prompts + {g} greedy tokens: "
            f"{per_prefill} ssd_scan launches in the prefill, logits finite {finite}; "
            f"prefill {t_pre * 1e3:.1f} ms, decode {t_dec * 1e3:.2f} ms/token (first call)")
        if per_prefill != cfg.num_layers:
            fail(f"mamba2: {per_prefill} ssd_scan launches per prefill, expected {cfg.num_layers}")
        if not finite:
            fail(f"mamba2: non-finite logits serving {b} x {s}")
    log(f"[mamba2] main path launches {counts}")
    if counts["ssd_scan"] != cfg.num_layers * len(batches) or counts["gmsa_score"]:
        fail(f"mamba2: launch counts {counts}")

    # Decode consistency: prefill(t[:, :S]) + decode(t[:, S]) == prefill(t[:, :S+1]).
    for i, (b, s, _) in enumerate(batches):
        prefill_fn, decode_fn = execs[i]
        _, cache = prefill_fn(params, tokens[i][:, :s])
        out = {}
        wall, events = device_profile(
            lambda: out.update(dec=decode_fn(params, cache, tokens[i][:, s:s + 1])[0]))
        if i == 0:
            dev_us = sum(us for _, us, _ in events)
            launched = sum(c for _, _, c in events)
            log(f"[mamba2] {smi} | one decode step (batch {b}) under torch.profiler: "
                f"{wall * 1e3:.1f} ms wall, device busy {dev_us / 1e3:.2f} ms "
                f"({100 * dev_us / 1e6 / wall:.1f}%), {launched} device kernels")
        dec = out["dec"]
        full, _ = prefill_fn(params, tokens[i])
        dec, full = dec[:, -1, :vocab], full[:, -1, :vocab]
        scale = float(full.abs().max())
        rel = float((dec - full).abs().max()) / scale
        pick = torch.argmax(dec, dim=-1)
        gap = full.max(dim=-1).values - torch.gather(full, -1, pick[:, None])[:, 0]
        off_tie = int(((pick != torch.argmax(full, dim=-1)) & (gap > DECODE_REL_TOL * scale)).sum())
        log(f"[mamba2] decode consistency {b} x {s}: prefill+decode vs prefill of S+1, "
            f"max |diff| / max |logit| = {rel:.3e} (tol {DECODE_REL_TOL:g}), greedy tokens "
            f"differing off near-ties {off_tie}")
        if rel > DECODE_REL_TOL or off_tie:
            fail(f"mamba2: decode consistency {b} x {s}: rel {rel:.3e}, off-tie {off_tie}")

    # Layer 0's real SSD operands through the kernel against the plain version.
    b, s, _ = batches[0]
    with torch.inference_mode():
        lp0 = {name: leaf[0] for name, leaf in params["blocks"].items()}
        _, x_in, dt, a, bm, cm, _ = ssd_layer_inputs(lp0, params["embed"][tokens[0][:, :s]], cfg)
        y, hf = ssd_scan(x_in, dt, a, bm, cm, chunk=min(cfg.ssm_chunk, s))
        y_ref, h_ref = ssd_scan_ref(x_in, dt, a, bm, cm)
    err_y, err_h = rel_err(y, y_ref), rel_err(hf, h_ref)
    log(f"[mamba2] layer 0 SSD operands ({b} x {s}) through the kernel vs ssd_scan_ref: "
        f"y max_rel_err {err_y:.3e}, h_final {err_h:.3e} (tol {SSD_MODEL_TOL:g})")
    if max(err_y, err_h) > SSD_MODEL_TOL:
        fail(f"mamba2: layer 0 SSD off its plain version: y {err_y:.3e}, h {err_h:.3e}")
    del x_in, dt, bm, cm, y, hf, y_ref, h_ref

    # Steady-state wall times: the batch of four, twice more.
    walls = [serve(0) for _ in range(2)]
    pre = [w[2] for w in walls]
    dec = [w[3] for w in walls]
    log(f"[mamba2] {smi} | prefill wall per batch (4 x 2048, calls 2-3): "
        f"{', '.join(f'{t * 1e3:.1f}' for t in pre)} ms")
    log(f"[mamba2] {smi} | decode wall per token (batch 4, calls 2-3, 16 tokens each): "
        f"{', '.join(f'{t * 1e3:.2f}' for t in dec)} ms")
    prefill_fn = execs[0][0]
    wall, events = device_profile(lambda: prefill_fn(params, tokens[0][:, :s]))
    dev_us = sum(us for _, us, _ in events)
    k_us = sum(us for k, us, _ in events if is_ssd_kernel(k))
    top = ", ".join(f"{k[:40]} {us / 1e3:.2f} ms x{c}" for k, us, c in events[:5])
    share = f"{100 * k_us / dev_us:.1f}%" if dev_us > 0 else "not measured"
    log(f"[mamba2] {smi} | one prefill under torch.profiler: {wall * 1e3:.1f} ms wall, device "
        f"busy {dev_us / 1e3:.1f} ms, ssd_scan chain {k_us / 1e3:.1f} ms = {share} of device "
        f"time; top: {top}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[mamba2] {smi} | peak device memory {peak:.2f} GiB")
    return counts["ssd_scan"]


def phase_sweep(dev, smi, cfg=None) -> int:
    import torch

    from repro_torch.benchmarks.fig6 import V_GRID
    from repro_torch.configs.fleet_256 import FleetConfig, make_fleet_builder
    from repro_torch.core.gmsa import make_kernel_policy
    from repro_torch.core.simulator import simulate_many
    from repro_torch.core.sweep import sweep_grid

    cfg = cfg or FleetConfig()
    _, build = make_fleet_builder(cfg, device=dev)
    policy = make_kernel_policy(None)
    gen = lambda: torch.Generator(device=dev).manual_seed(7)
    run = lambda: sweep_grid(build, policy, gen(), cfg.n_runs, V_GRID, device=dev)
    lanes = len(V_GRID) * cfg.n_runs

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    reset_counts()
    grid = run()
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"[sweep] sweep_grid fleet_256 N={cfg.n_sites} K={cfg.k_types} T={cfg.t_slots} "
        f"R={cfg.n_runs} x {len(V_GRID)} V = {lanes} lanes: launches {counts}")
    if counts["gmsa_score"] != cfg.t_slots:
        fail(f"sweep: gmsa_score launched {counts['gmsa_score']} times, expected {cfg.t_slots}")
    want = (len(V_GRID), cfg.n_runs, cfg.t_slots, cfg.n_sites, cfg.k_types)
    if tuple(grid.f_trace.shape) != want:
        fail(f"sweep: f_trace shape {tuple(grid.f_trace.shape)}, expected {want}")
    for name, x in grid._asdict().items():
        if not bool(torch.isfinite(x).all()):
            fail(f"sweep: non-finite {name}")
    log(f"[sweep] {smi} | peak device memory of the call {peak / 2**30:.2f} GiB "
        f"({(peak - mem0) / 2**30:.2f} GiB above the {mem0 / 2**30:.2f} GiB held before it; "
        f"f_trace alone {grid.f_trace.numel() * 4 / 2**30:.2f} GiB)")

    # One untimed call first, so that every timed per-point call is warm.
    simulate_many(build, policy, gen(), cfg.n_runs, V_GRID[0], device=dev)
    torch.cuda.synchronize()
    per_walls, costs, worst = [], [], 0.0
    for i, v in enumerate(V_GRID):
        t0 = time.perf_counter()
        per = simulate_many(build, policy, gen(), cfg.n_runs, v, device=dev)
        torch.cuda.synchronize()
        per_walls.append(time.perf_counter() - t0)
        if not (torch.equal(grid.f_trace[i], per.f_trace)
                and torch.equal(grid.q_final[i], per.q_final)):
            fail(f"sweep: lane V={v} differs from simulate_many at that V in f_trace or q_final")
        for name in ("cost", "energy", "backlog_total", "backlog_avg"):
            worst = max(worst, rel_err(getattr(grid, name)[i], getattr(per, name)))
        costs.append(float(grid.cost[i].mean()))
        del per
    log(f"[sweep] every lane's f_trace and q_final bitwise equal to simulate_many at its V; "
        f"sums max_rel_err {worst:.3e} (tol {SWEEP_SUM_RTOL:g})")
    if worst > SWEEP_SUM_RTOL:
        fail(f"sweep: lane sums off simulate_many by {worst:.3e}")
    log("[sweep] mean cost by V: " + ", ".join(f"{v:g}: {c:.4f}" for v, c in zip(V_GRID, costs)))
    if not all(costs[i + 1] <= costs[i] * 1.01 for i in range(len(costs) - 1)):
        fail(f"sweep: mean cost not non-increasing in V: {costs}")
    del grid

    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    log(f"[sweep] {smi} | wall per sweep_grid call (calls 2-3): "
        f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms; the seven per-point simulate_many "
        f"calls, warm: {', '.join(f'{w * 1e3:.1f}' for w in per_walls)} ms, "
        f"sum {sum(per_walls) * 1e3:.1f} ms, {sum(per_walls) / max(walls):.2f}-"
        f"{sum(per_walls) / min(walls):.2f}x one sweep call")
    log(f"[sweep] {smi} | {device_busy_share(run)}")
    # mu expanded over V has stride 0 on V: the kernel wrapper copies it to
    # its (V*R, K, N) runs layout every slot.
    from repro_torch.kernels.gmsa_score.kernel import _fold_runs

    ins = build(gen(), cfg.n_runs)
    mu_v = ins.mu[:, 0].expand((len(V_GRID),) + tuple(ins.mu[:, 0].shape))
    t_copy = device_time_ms(lambda: _fold_runs(mu_v.mT, lanes, cfg.k_types, cfg.n_sites, True))
    log(f"[sweep] {smi} | the stride-0 mu copy the wrapper makes per slot "
        f"({lanes * cfg.k_types * cfg.n_sites * 4 / 1e6:.2f} MB): {t_copy * 1e3:.2f} us device, "
        f"x{cfg.t_slots} slots = {t_copy * cfg.t_slots:.3f} ms per call")
    del ins, mu_v
    torch.cuda.empty_cache()
    return counts["gmsa_score"]


def phase_figures(dev, smi, runs: int = FIGURE_RUNS) -> None:
    from repro_torch.benchmarks import fig5, fig6

    reset_counts()
    t0 = time.perf_counter()
    out5 = fig5.run(runs, device=dev)
    t5 = time.perf_counter() - t0
    out6 = fig6.run(runs, device=dev)
    t6 = time.perf_counter() - t0 - t5
    log(f"[figures] {smi} | fig5.run({runs}) {t5:.2f} s, fig6.run({runs}) {t6:.2f} s; "
        f"launches {read_counts()} (the paper's N = 4 runs GMSA on the table path)")
    checks = {**out5["checks"], **out6["checks"]}
    for name, value in checks.items():
        ref = RECORDED_CHECKS.get(name)
        log(f"[figures] {name} = {value}" + ("" if ref is None else
                                             f"  (JAX package, BENCH_sim.json: {ref})"))
    rows = out6["gmsa"]
    log("[figures] fig6 GMSA by V (cost $/slot, backlog): " + ", ".join(
        f"{v:g}: {rows[v]['cost']:.2f}, {rows[v]['backlog']:.2f}" for v in out6["v_grid"]))
    s = out6["sweep_grid"]
    log(f"[figures] {smi} | fig6_grid_vs_percell: grid {s['grid_us_per_run']:.2f} us per run, "
        f"per-cell {s['percell_us_per_run']:.2f} us per run "
        f"({s['percell_us_per_run'] / max(s['grid_us_per_run'], 1e-9):.2f}x), first-call "
        f"overhead grid {s['grid_compile_us']:.0f} us, per-cell {s['percell_compile_us']:.0f} us "
        f"({runs} runs x {len(out6['v_grid'])} V)")
    for name, verify, out in (("fig5", fig5.verify, out5), ("fig6", fig6.verify, out6)):
        try:
            verify(out)
        except AssertionError as exc:
            fail(f"figures: {name}: {exc}")
    log("[figures] the reference's asserts hold: GMSA cheapest in >= 90% of slots, V=1 backlog "
        "< 50, baseline slopes > 10x GMSA's, cost and backlog monotone in V, reduction at "
        "V=100 in [0.2, 0.45]")


def phase_telemetry(dev, smi, cfg=None) -> int:
    import torch

    from repro_torch.configs.fleet_256 import FleetConfig, make_fleet_builder
    from repro_torch.core.gmsa import make_kernel_policy
    from repro_torch.core.simulator import simulate_many
    from repro_torch.telemetry import SUMMARY, HistogramSpec, TelemetryConfig

    cfg = cfg or FleetConfig()
    _, build = make_fleet_builder(cfg, device=dev)
    policy = make_kernel_policy(None)
    tel = TelemetryConfig(level=SUMMARY, hist=HistogramSpec())
    run = lambda t: simulate_many(build, policy, torch.Generator(device=dev).manual_seed(7),
                                  cfg.n_runs, cfg.v, device=dev, telemetry=t)
    off = run(None)
    torch.cuda.synchronize()
    reset_counts()
    outs, frame = run(tel)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"[telemetry] simulate_many fleet_256 with SUMMARY telemetry and {tel.hist}: "
        f"launches {counts}")
    if counts["gmsa_score"] != cfg.t_slots:
        fail(f"telemetry: gmsa_score launched {counts['gmsa_score']} times, expected {cfg.t_slots}")
    for name, a, b in zip(off._fields, outs, off):
        if not torch.equal(a, b):
            fail(f"telemetry: {name} differs from the OFF call")
    q_site, hist = frame.metrics["q_site"], frame.metrics["site_cost_hist"]
    err = rel_err(q_site.sum(-1), off.backlog_total)
    per_series = hist.sum(-1)
    log(f"[telemetry] outputs bitwise equal to the OFF call; q_site {tuple(q_site.shape)} sums "
        f"to backlog_total within {err:.3e} (tol 1e-6); site_cost_hist {tuple(hist.shape)}, "
        f"counts per (run, site) {float(per_series.min()):g}..{float(per_series.max()):g} "
        f"(want {cfg.t_slots})")
    if err > 1e-6:
        fail(f"telemetry: q_site sums off backlog_total by {err:.3e}")
    if not bool((per_series == cfg.t_slots).all()):
        fail("telemetry: a (run, site) histogram does not count T slots")
    del off, outs, frame, q_site, hist
    walls = {"off": [], "summary": []}
    for arm in ("off", "summary", "summary", "off"):
        t0 = time.perf_counter()
        run(tel if arm == "summary" else None)
        torch.cuda.synchronize()
        walls[arm].append(time.perf_counter() - t0)
    added = statistics.mean(walls["summary"]) - statistics.mean(walls["off"])
    log(f"[telemetry] {smi} | wall per call, in turns off/summary/summary/off: off "
        f"{', '.join(f'{w * 1e3:.1f}' for w in walls['off'])} ms, summary "
        f"{', '.join(f'{w * 1e3:.1f}' for w in walls['summary'])} ms; added {added * 1e3:.1f} ms")
    return counts["gmsa_score"]


def staged_fleet(cfg, dev):
    """fleet_256 with a drawn K = 8, S = 3 stage mix and the fleet's own
    backbone: ``(build, dag, wan)``."""
    import torch

    from repro_torch.configs.fleet_256 import make_fleet_builder, make_serve_grid
    from repro_torch.jobs import chain_dag, shuffle_volumes_from_selectivity, validate_dag
    from repro_torch.placement import wan_topology
    from repro_torch.traces.stages import staged_mix_profile

    _, build = make_fleet_builder(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(STAGED_MIX_SEED)
    mask, compute, sel = staged_mix_profile(gen, cfg.k_types, STAGED_S_MAX, min_stages=2,
                                            device=dev)
    dag = chain_dag(compute, shuffle_volumes_from_selectivity(100.0, sel), mask)
    validate_dag(dag)
    _, _, _, up, down, _, _ = make_serve_grid(cfg, cfg.k_types, cfg.t_slots, device=dev)
    return build, dag, wan_topology(up, down, energy_per_gb=0.03)


def lockstep_policy(p_it, tally):
    """A base policy that scores every slot with the kernel and with its
    plain version on the same aggregate state, steps with the kernel's
    decision, and adds the off-tie mismatches and near-tie flips to
    ``tally`` (device tensors)."""
    import torch

    from repro_torch.kernels.gmsa_score.kernel import gmsa_score_cuda
    from repro_torch.kernels.gmsa_score.ref import gmsa_score_ref

    def policy(generator, q, arrivals, mu, e, aux, scalar):
        _, wpue, r_t = aux
        vp = scalar * p_it
        _, b = gmsa_score_cuda(q.mT, mu.mT, arrivals, vp, r_t, wpue)
        s_ref, b_ref = gmsa_score_ref(q.mT, mu.mT, arrivals, vp, r_t, wpue)
        picked = torch.gather(s_ref, -1, b.long().unsqueeze(-1)).squeeze(-1)
        low = s_ref.min(dim=-1).values
        near = (picked - low).abs() <= TIE_ATOL + TIE_RTOL * low.abs()
        diff = b != b_ref
        tally["mism"] += (diff & ~near).sum()
        tally["flips"] += (diff & near).sum()
        idx = torch.arange(q.shape[-2], device=q.device)
        return (idx[:, None] == b.unsqueeze(-2)).to(q.dtype)

    policy.consumes_key = False
    policy.wants_wpue = True
    policy.wants_r = True
    return policy


def phase_staged(dev, smi, cfg=None, paper_runs=None) -> int:
    import tempfile

    import torch

    from repro_torch.benchmarks import jobs_bench
    from repro_torch.configs.facebook_4dc_stages import StagedPaperConfig
    from repro_torch.configs.fleet_256 import FleetConfig
    from repro_torch.core.gmsa import make_kernel_policy
    from repro_torch.core.simulator import simulate_many
    from repro_torch.jobs import (
        make_staged_policy,
        simulate_staged_many,
        single_stage_dag,
        stage_oblivious,
        summarize_staged,
    )
    from repro_torch.telemetry import HistogramSpec, cross_check, read_jsonl

    # (a) the staged paper scenario, both arms, as jobs_bench runs them.
    runs = paper_runs or StagedPaperConfig().n_runs
    reset_counts()
    res = jobs_bench.run(runs, dev)
    for name, arm in res["arms"].items():
        s = arm["summary"]
        if not all(math.isfinite(x) for x in s.values()):
            fail(f"staged: paper {name} arm summary not finite: {s}")
        log(f"[staged] paper {name:<9} {runs} runs: total $/slot {s['time_avg_total_cost']:.1f} "
            f"(JAX package, BENCH_sim.json: {RECORDED_JOBS[name]}), compute "
            f"{s['time_avg_compute_cost']:.1f}, WAN {s['time_avg_wan_cost']:.1f}, WAN GB "
            f"{s['total_wan_gb']:.0f}, backlog {s['time_avg_backlog']:.3f}, completed "
            f"{s['jobs_completed']:.0f}; {smi} | {arm['us_per_run']:.1f} us per run "
            f"(best of 4 warm calls), first call +{arm['first_call_us'] / 1e3:.0f} ms")
    log(f"[staged] paper saving_frac {res['saving_frac']:.4f} (JAX package, BENCH_sim.json: "
        f"{RECORDED_JOBS['saving_frac']}), WAN GB saved {res['wan_gb_saved']:.0f}; launches "
        f"{read_counts()} (N = 4 dispatches on the table path)")
    try:
        jobs_bench.verify(res)
    except AssertionError as exc:
        fail(f"staged: paper: {exc}")

    # (b) full fleet_256 through the kernel.
    cfg = cfg or FleetConfig()
    build, dag, wan = staged_fleet(cfg, dev)
    gen = lambda: torch.Generator(device=dev).manual_seed(7)
    kernel_arm = stage_oblivious(make_kernel_policy(None), pin_map=True)
    run = lambda pol, d=dag: simulate_staged_many(build, d, wan, pol, gen(), cfg.n_runs, cfg.v,
                                                  device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    reset_counts()
    outs = run(kernel_arm)
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    depth = dag.stage_mask.sum(1).tolist()
    log(f"[staged] fleet_256 N={cfg.n_sites} K={cfg.k_types} S={dag.s_max} (depths "
        f"{[int(x) for x in depth]}) T={cfg.t_slots} R={cfg.n_runs}: "
        f"stage_oblivious(make_kernel_policy(None), pin_map=True) launches {counts}")
    if counts["gmsa_score"] != cfg.t_slots:
        fail(f"staged: gmsa_score launched {counts['gmsa_score']} times, expected {cfg.t_slots}")
    want = (cfg.n_runs, cfg.t_slots, cfg.n_sites, cfg.k_types, dag.s_max)
    if tuple(outs.f_trace.shape) != want:
        fail(f"staged: f_trace shape {tuple(outs.f_trace.shape)}, expected {want}")
    for name, x in outs._asdict().items():
        if not bool(torch.isfinite(x).all()):
            fail(f"staged: non-finite {name}")
    summ = summarize_staged(outs)
    if not all(math.isfinite(x) for x in summ.values()):
        fail(f"staged: summarize_staged not finite: {summ}")
    log(f"[staged] summarize_staged: {json.dumps(summ)}")
    log(f"[staged] {smi} | peak device memory of the call {peak / 2**30:.2f} GiB "
        f"({(peak - mem0) / 2**30:.2f} GiB above the {mem0 / 2**30:.2f} GiB held before it; "
        f"f_trace alone {outs.f_trace.numel() * 4 / 2**30:.2f} GiB)")
    del outs

    tally = {"mism": torch.zeros((), dtype=torch.int64, device=dev),
             "flips": torch.zeros((), dtype=torch.int64, device=dev)}
    p_it = torch.ones(cfg.k_types, device=dev)
    lock = run(stage_oblivious(lockstep_policy(p_it, tally), pin_map=True))
    torch.cuda.synchronize()
    mism = int(tally["mism"])
    decisions = cfg.t_slots * cfg.n_runs * cfg.k_types
    log(f"[staged] lockstep: {decisions} decisions, kernel and plain on the same aggregate "
        f"state every slot: off-tie mismatches {mism}, near-tie flips {int(tally['flips'])}")
    if mism != 0:
        fail(f"staged: {mism} off-tie decision mismatches in lockstep")
    del lock

    one = single_stage_dag(cfg.k_types, device=dev)
    st = run(make_kernel_policy(None), one)
    base = simulate_many(build, make_kernel_policy(None), gen(), cfg.n_runs, cfg.v, device=dev)
    if not (torch.equal(st.f_trace[..., 0], base.f_trace)
            and torch.equal(st.q_final[..., 0], base.q_final)):
        fail("staged: single_stage_dag through the kernel differs from simulate in f_trace "
             "or q_final")
    errs = {name: rel_err(getattr(st, name), getattr(base, name))
            for name in ("cost", "energy", "backlog_total")}
    bitwise = [name for name in errs if torch.equal(getattr(st, name), getattr(base, name))]
    log(f"[staged] single_stage_dag through the kernel == simulate: f_trace and q_final bitwise; "
        f"sums max_rel_err {json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})} "
        f"(tol {STAGED_IDENTITY_RTOL:g}); bitwise too: {bitwise or 'none'}")
    if max(errs.values()) > STAGED_IDENTITY_RTOL:
        fail(f"staged: single-stage sums off simulate by {max(errs.values()):.3e}")
    del st, base

    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        obl = run(kernel_arm)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    log(f"[staged] {smi} | wall per simulate_staged_many call, kernel arm (calls 2-4): "
        f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms; median "
        f"{statistics.median(walls) * 1e3:.1f} ms")
    log(f"[staged] {smi} | {device_busy_share(lambda: run(kernel_arm))}")
    obl_backlog = float(obl.backlog_avg.mean())
    obl_final = float(obl.q_final.sum(dim=(-3, -2, -1)).mean())
    del obl

    aware_arm = make_staged_policy(dag, wan)
    aware_walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        aware = run(aware_arm)
        torch.cuda.synchronize()
        aware_walls.append(time.perf_counter() - t0)
    for name, x in aware._asdict().items():
        if not bool(torch.isfinite(x).all()):
            fail(f"staged: aware arm non-finite {name}")
    s_aw = summarize_staged(aware)
    log(f"[staged] {smi} | stage-aware arm at the same size, wall per call (calls 1-3): "
        f"{', '.join(f'{w * 1e3:.1f}' for w in aware_walls)} ms")
    log(f"[staged] fleet backlog (mean per queue; final total per run): kernel oblivious arm "
        f"{obl_backlog:.3f}; {obl_final:.1f}, aware arm {s_aw['time_avg_backlog']:.3f}; "
        f"{s_aw['final_backlog_total']:.1f}; total $/slot oblivious "
        f"{summ['time_avg_total_cost']:.1f}, aware {s_aw['time_avg_total_cost']:.1f}")
    del aware
    torch.cuda.empty_cache()

    # (c) the aware arm's flight record, checked by the report tool.
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "staged_flight_record.jsonl"
        records = jobs_bench.flight_record(path, dev, hist=HistogramSpec())
        check = cross_check(read_jsonl(path))
        out = subprocess.run([sys.executable, "-m", "repro_torch.telemetry.report", str(path),
                              "--check", "--percentiles"], capture_output=True, text=True,
                             timeout=300, cwd=ROOT,
                             env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    tail = [line for line in out.stdout.splitlines() if "cross-check" in line or "✓" in line
            or "✗" in line]
    log(f"[staged] flight record: {len(records)} records; report --check exit "
        f"{out.returncode}: " + " | ".join(x.strip() for x in tail))
    if out.returncode != 0 or not check["ok"]:
        fail(f"staged: flight record cross-check failed: {out.stdout[-2000:]} {out.stderr[-2000:]}")
    return counts["gmsa_score"]


def placed_lockstep_policy(p_it, tally):
    """A carried-r policy that scores every slot with the kernel, its plain
    version on the same per-run operands, and the table path
    (``drift_plus_penalty_scores`` on the controller's energy rows, as
    ``gmsa_policy`` decides), steps with the kernel's decision, and adds the
    off-tie mismatches and near-tie flips against each to ``tally``."""
    import torch

    from repro_torch.core.gmsa import drift_plus_penalty_scores
    from repro_torch.kernels.gmsa_score.kernel import gmsa_score_cuda
    from repro_torch.kernels.gmsa_score.ref import gmsa_score_ref

    def near(s, b, b_other):
        picked = torch.gather(s, -1, b.long().unsqueeze(-1)).squeeze(-1)
        low = s.min(dim=-1).values
        tie = (picked - low).abs() <= TIE_ATOL + TIE_RTOL * low.abs()
        diff = b != b_other
        return (diff & ~tie).sum(), (diff & tie).sum()

    def policy(generator, q, arrivals, mu, e, aux, scalar):
        _, wpue, r_t = aux
        vp = scalar * p_it
        _, b = gmsa_score_cuda(q.mT, mu.mT, arrivals, vp, r_t, wpue)
        s_ref, b_ref = gmsa_score_ref(q.mT, mu.mT, arrivals, vp, r_t, wpue)
        s_tab = drift_plus_penalty_scores(q, arrivals, mu, e, scalar)
        b_tab = torch.argmin(s_tab, dim=-1).to(torch.int32)
        for name, sc, other in (("ref", s_ref, b_ref), ("table", s_tab, b_tab)):
            m, f = near(sc, b, other)
            tally[f"mism_{name}"] += m
            tally[f"flips_{name}"] += f
        idx = torch.arange(q.shape[-2], device=q.device)
        return (idx[:, None] == b.unsqueeze(-2)).to(q.dtype)

    policy.consumes_key = False
    policy.wants_wpue = True
    policy.wants_r = True
    return policy


def placed_fleet(cfg, dev):
    """fleet_256 placed: ``(build, up, down, pcfg, ingest, sizes, bias)`` —
    the fleet's own backbone (``make_serve_grid``), W = 48, 25% fresh
    ingest per epoch drifting toward the day-mean omega * PUE (data piles up
    at the priciest sites), 5% growth per epoch, uncapped."""
    import torch

    from repro_torch.configs.fleet_256 import make_fleet_builder, make_serve_grid
    from repro_torch.placement import PlacementConfig
    from repro_torch.traces.drift import dataset_growth_trace, ingest_drift_trace

    _, build = make_fleet_builder(cfg, device=dev)
    omega, pue, _, up, down, _, _ = make_serve_grid(cfg, cfg.k_types, cfg.t_slots, device=dev)
    day = (omega * pue).mean(dim=0)
    bias = day / day.sum()
    n_epochs = cfg.t_slots // PLACED_W
    ingest = ingest_drift_trace(torch.Generator(device=dev).manual_seed(PLACED_INGEST_SEED),
                                n_epochs, cfg.k_types, cfg.n_sites, bias=bias,
                                bias_strength=0.5, device=dev)
    sizes = dataset_growth_trace(n_epochs, cfg.k_types, 100.0, 0.05, device=dev)
    pcfg = PlacementConfig(epoch_slots=PLACED_W, growth=0.25,
                           manager_share=cfg.manager_share, map_share=cfg.map_share)
    return build, up, down, pcfg, ingest, sizes, bias


def phase_placement(dev, smi, cfg=None, paper_runs=None, sweep_runs=None) -> dict:
    import dataclasses
    import tempfile

    import torch

    from repro_torch.benchmarks import placement_bench
    from repro_torch.configs.fleet_256 import FleetConfig, make_fleet_builder
    from repro_torch.core.baselines import static_placement_rule
    from repro_torch.core.gmsa import gmsa_policy, make_kernel_policy
    from repro_torch.core.simulator import simulate_many
    from repro_torch.core.sweep import sweep_placed_budgets
    from repro_torch.placement import (
        PlacedOutputs,
        make_adaptive_rule,
        simulate_placed,
        simulate_placed_many,
        summarize_placed,
    )
    from repro_torch.telemetry import (
        TRACE,
        HistogramSpec,
        TelemetryConfig,
        collect_records,
        cross_check,
        read_jsonl,
        write_jsonl,
    )
    from repro_torch.traces.bandwidth import link_fault_trace, scheduled_link_fault_trace
    from repro_torch.traces.faults import (
        health_to_alive,
        health_trace,
        region_assignment,
        scheduled_failure_trace,
    )

    # (a) the paper scenario, as placement_bench runs it (N = 4: the table path).
    runs = paper_runs or PLACEMENT_PAPER_RUNS
    reset_counts()
    for key, fault in (("drifting", False), ("fault", True)):
        res = placement_bench.run(runs, dev, fault=fault)
        for name, arm in res["arms"].items():
            s = arm["summary"]
            if not all(math.isfinite(x) for x in s.values()):
                fail(f"placement: paper {key} {name} arm summary not finite: {s}")
            extra = (f", recovery $/slot {s['time_avg_recovery_cost']:.4f}, recovery GB "
                     f"{s['total_recovery_gb']:.1f}, slots to SLO {arm['recovery_slots_to_slo']}"
                     if fault else "")
            log(f"[placement] paper {key} {name:<8} {runs} runs: total $/slot "
                f"{s['time_avg_total_cost']:.2f}, WAN $/slot {s['time_avg_wan_cost']:.3f}, sync "
                f"{s['time_avg_sync_cost']:.4f}, WAN GB {s['total_wan_gb']:.1f}, backlog "
                f"{s['time_avg_backlog']:.3f}{extra}; {smi} | {arm['us_per_run']:.1f} us per "
                f"run (best of 4 warm calls), first call +{arm['first_call_us'] / 1e3:.0f} ms")
        log(f"[placement] paper {key} saving_frac {res['saving_frac']:.4f} (JAX package on the "
            f"CPU, BENCH_sim.json: {RECORDED_PLACEMENT[key]}; the card draws its own traces)")
        try:
            placement_bench.verify(res)
        except AssertionError as exc:
            fail(f"placement: paper {key}: {exc}")
    frontier, _ = placement_bench.sweep(sweep_runs or PLACEMENT_SWEEP_RUNS, dev)
    log("[placement] paper sweep (W, budget: total $/slot, WAN GB): " + "; ".join(
        f"{c['epoch_slots']}, {c['move_budget']}: {c['summary']['time_avg_total_cost']:.1f}, "
        f"{c['summary']['total_wan_gb']:.0f}" for c in frontier)
        + f"; launches {read_counts()} (N = 4 dispatches on the table path)")

    # (b) full fleet_256 placed through the kernel.
    cfg = cfg or FleetConfig()
    build, up, down, pcfg, ingest, sizes, bias = placed_fleet(cfg, dev)
    p_it = torch.ones(cfg.k_types, device=dev)
    policy = make_kernel_policy(None, p_it)
    rule = make_adaptive_rule(up, temp=2.0)
    fault_site = int(bias.argmax())
    lost = scheduled_failure_trace(cfg.t_slots, cfg.n_sites,
                                   [(fault_site, PLACED_FAULT_SLOT, None)], device=dev)
    gen = lambda: torch.Generator(device=dev).manual_seed(7)
    run = lambda pol=policy, rl=rule, pc=pcfg, **kw: simulate_placed_many(
        build, up, down, pol, rl, gen(), cfg.n_runs, pc, scalar=cfg.v, ingest=ingest,
        sizes_gb=sizes, device=dev, **kw)
    label = (f"fleet_256 placed N={cfg.n_sites} K={cfg.k_types} T={cfg.t_slots} "
             f"R={cfg.n_runs} W={PLACED_W}")

    def checked(name, outs):
        for field, x in outs._asdict().items():
            if not bool(torch.isfinite(x).all()):
                fail(f"placement: {name}: non-finite {field}")
        if tuple(outs.f_trace.shape) != (cfg.n_runs, cfg.t_slots, cfg.n_sites, cfg.k_types):
            fail(f"placement: {name}: f_trace shape {tuple(outs.f_trace.shape)}")
        return summarize_placed(outs)

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    calls, launches = {}, {}
    for name, kw in (("drifting", {}), ("site loss", {"alive": lost})):
        reset_counts()
        outs = run(**kw)
        torch.cuda.synchronize()
        counts = read_counts()
        if counts["gmsa_score"] != cfg.t_slots:
            fail(f"placement: {name}: gmsa_score launched {counts['gmsa_score']} times, "
                 f"expected {cfg.t_slots}")
        calls[name], launches[name] = outs, counts["gmsa_score"]
        s = checked(name, outs)
        log(f"[placement] {label}, {name}: launches {counts}; summarize_placed "
            f"{json.dumps({k: float(f'{v:.6g}') for k, v in s.items()})}")
    peak = torch.cuda.max_memory_allocated()
    log(f"[placement] {smi} | peak device memory of those two calls {peak / 2**30:.2f} GiB "
        f"({(peak - mem0) / 2**30:.2f} GiB above the {mem0 / 2**30:.2f} GiB held before; "
        f"r_trace alone {calls['drifting'].r_trace.numel() * 4 / 2**30:.2f} GiB)")

    ones = run(alive=torch.ones_like(lost))
    for field, a, b in zip(ones._fields, ones, calls["drifting"]):
        if not torch.equal(a, b):
            fail(f"placement: an all-ones alive mask differs from no mask in {field}")
    log("[placement] an all-ones alive mask: every output bitwise equal to no mask")
    del ones

    hgen = torch.Generator(device=dev).manual_seed(PLACED_DEGRADED_SEED)
    health = health_trace(hgen, cfg.t_slots, cfg.n_sites, death_prob=0.05, device=dev)
    # Degraded links only (no severing): a move across a severed link bills
    # +inf by design, and every fleet bill here must be finite.
    link = link_fault_trace(hgen, cfg.t_slots, cfg.n_sites, sever_frac=0.0, device=dev)
    regions = region_assignment(cfg.n_sites, PLACED_REGIONS, device=dev)
    alive_h = health_to_alive(health)
    reset_counts()
    t0 = time.perf_counter()
    deg = run(alive=alive_h, health=health, link_health=link, regions=regions)
    torch.cuda.synchronize()
    t_deg = time.perf_counter() - t0
    counts = read_counts()
    if counts["gmsa_score"] != cfg.t_slots:
        fail(f"placement: degraded: gmsa_score launched {counts['gmsa_score']} times")
    s = checked("degraded", deg)
    edges = int(((1 - alive_h[1:]) * alive_h[:-1]).sum() + (1 - alive_h[0]).sum())
    log(f"[placement] {label}, stragglers + link faults + {PLACED_REGIONS} regions ("
        f"{edges} death edges, {float((link < 1).float().mean()):.4f} of link-slots degraded): "
        f"launches {counts}; {smi} | wall {t_deg * 1e3:.1f} ms; summarize_placed "
        f"{json.dumps({k: float(f'{v:.6g}') for k, v in s.items()})}")
    del deg, health, link, alive_h

    # Severed links at the loss, from the second priciest site (which sheds
    # data) to the three cheapest (which take it): the recovery routes its
    # evacuation around them, and a move across one bills +inf by design
    # (the boundary move of that slot, the recovery's own). The layouts and
    # WAN bills do not read the backlog (the adaptive rule reads prices,
    # service rates and sizes), so the same call through the kernel-free
    # table policy is their plain reference, bitwise, +inf included.
    order = torch.argsort(bias, descending=True).tolist()
    cut = scheduled_link_fault_trace(
        cfg.t_slots, cfg.n_sites,
        [(order[1], j, PLACED_FAULT_SLOT, PLACED_FAULT_SLOT + PLACED_W, 0.0) for j in order[-3:]],
        device=dev)
    reset_counts()
    sev = run(alive=lost, link_health=cut)
    torch.cuda.synchronize()
    counts = read_counts()
    if counts["gmsa_score"] != cfg.t_slots:
        fail(f"placement: severed: gmsa_score launched {counts['gmsa_score']} times")
    plain = run(pol=gmsa_policy, alive=lost, link_health=cut)
    e_cut = PLACED_FAULT_SLOT // PLACED_W
    inf_at = {"wan_cost": e_cut, "wan_energy": e_cut, "wan_latency_s": e_cut,
              "recovery_cost": PLACED_FAULT_SLOT}
    for field, x, ref in zip(sev._fields, sev, plain):
        col = inf_at.get(field)
        rest = x if col is None else torch.cat([x[..., :col], x[..., col + 1:]], dim=-1)
        if not bool(torch.isfinite(rest).all()) or bool(torch.isnan(x).any()):
            fail(f"placement: severed: {field} not finite where no severed link is in force")
        if field in PLACED_LAYOUT_FIELDS and not torch.equal(x, ref):
            fail(f"placement: severed: {field} differs from the table policy's call")
    log(f"[placement] {label}, site {fault_site} lost and site {order[1]}'s links to the three "
        f"cheapest sites {order[-3:]} severed "
        f"over slots [{PLACED_FAULT_SLOT}, {PLACED_FAULT_SLOT + PLACED_W}): launches {counts}; "
        f"runs billed +inf: boundary move {int(torch.isinf(sev.wan_cost).any(-1).sum())}, "
        f"recovery {int(torch.isinf(sev.recovery_cost).any(-1).sum())} of {cfg.n_runs}; "
        f"recovery GB {float(sev.recovery_gb.sum(-1).mean()):.1f} per run; layouts, r and WAN "
        f"bills bitwise equal to the table policy's call; every other field finite")
    del sev, plain, cut

    # Lockstep: kernel against its plain version and the table path, on the
    # same state every slot, with and without the loss.
    for name, kw in (("drifting", {}), ("site loss", {"alive": lost})):
        tally = {k: torch.zeros((), dtype=torch.int64, device=dev)
                 for k in ("mism_ref", "flips_ref", "mism_table", "flips_table")}
        lock = run(pol=placed_lockstep_policy(p_it, tally), **kw)
        torch.cuda.synchronize()
        if not torch.equal(lock.f_trace, calls[name].f_trace):
            fail(f"placement: lockstep {name}: the stepped decisions differ from the kernel call")
        t = {k: int(v) for k, v in tally.items()}
        log(f"[placement] lockstep {name}: {cfg.t_slots * cfg.n_runs * cfg.k_types} decisions, "
            f"per-run r after slot {PLACED_W}: kernel vs gmsa_score_ref off-tie mismatches "
            f"{t['mism_ref']}, near-tie flips {t['flips_ref']}; kernel vs the table path "
            f"(gmsa_policy on the controller's energy rows) off-tie {t['mism_table']}, "
            f"near-tie {t['flips_table']}")
        if t["mism_ref"] or t["mism_table"]:
            fail(f"placement: lockstep {name}: off-tie mismatches {t}")
        del lock

    one_epoch = dataclasses.replace(pcfg, epoch_slots=cfg.t_slots)
    w_t = simulate_placed_many(build, up, down, policy, rule, gen(), cfg.n_runs, one_epoch,
                               scalar=cfg.v, device=dev)
    base = simulate_many(build, policy, gen(), cfg.n_runs, cfg.v, device=dev)
    if not (torch.equal(w_t.f_trace, base.f_trace) and torch.equal(w_t.q_final, base.q_final)):
        fail("placement: W = T through the kernel differs from simulate in f_trace or q_final")
    errs = {name: rel_err(getattr(w_t, name), getattr(base, name))
            for name in ("cost", "energy", "backlog_total", "backlog_avg")}
    log(f"[placement] W = T through the kernel == simulate: f_trace and q_final bitwise; sums "
        f"max_rel_err {json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})} (tol "
        f"{PLACED_SUM_RTOL:g})")
    if max(errs.values()) > PLACED_SUM_RTOL:
        fail(f"placement: W = T sums off simulate by {max(errs.values()):.3e}")
    del w_t, base

    static = checked("static", run(rl=static_placement_rule))
    adaptive = summarize_placed(calls["drifting"])
    log(f"[placement] fleet static vs adaptive total $/slot: {static['time_avg_total_cost']:.2f} "
        f"vs {adaptive['time_avg_total_cost']:.2f} (saving "
        f"{1 - adaptive['time_avg_total_cost'] / static['time_avg_total_cost']:.4f}); dispatch "
        f"{static['time_avg_dispatch_cost']:.2f} vs {adaptive['time_avg_dispatch_cost']:.2f}, "
        f"WAN {adaptive['time_avg_wan_cost']:.4f}, sync {static['time_avg_sync_cost']:.4f} vs "
        f"{adaptive['time_avg_sync_cost']:.4f}")
    del calls

    for name, kw in (("drifting", {}), ("site loss", {"alive": lost})):
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            run(**kw)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        log(f"[placement] {smi} | wall per simulate_placed_many call, {name} (calls 2-4): "
            f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms; median "
            f"{statistics.median(walls) * 1e3:.1f} ms")
        log(f"[placement] {smi} | {name}: {device_busy_share(lambda: run(**kw))}")
    torch.cuda.empty_cache()

    # (c) the move-budget sweep: every (budget, run) lane in one loop.
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    grid = sweep_placed_budgets(build, up, down, policy, rule, gen(), cfg.n_runs, pcfg,
                                PLACED_BUDGETS, scalar=cfg.v, ingest=ingest, sizes_gb=sizes,
                                device=dev)
    torch.cuda.synchronize()
    t_grid = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    if counts["gmsa_score"] != cfg.t_slots:
        fail(f"placement: sweep: gmsa_score launched {counts['gmsa_score']} times")
    sweep_launches = counts["gmsa_score"]
    worst, per_walls, totals = 0.0, [], []
    for i, mb in enumerate(PLACED_BUDGETS):
        t0 = time.perf_counter()
        per = run(pc=dataclasses.replace(pcfg, move_budget=mb))
        torch.cuda.synchronize()
        per_walls.append(time.perf_counter() - t0)
        lane = PlacedOutputs(*(x[i] for x in grid))
        for field in ("f_trace", "q_final", "placements", "r_trace"):
            if not torch.equal(getattr(lane, field), getattr(per, field)):
                fail(f"placement: sweep lane {mb} differs from simulate_placed_many in {field}")
        for field in ("cost", "energy", "backlog_total", "backlog_avg", "wan_cost", "wan_gb",
                      "sync_cost", "wan_latency_s"):
            worst = max(worst, rel_err(getattr(lane, field), getattr(per, field)))
        totals.append(summarize_placed(lane)["time_avg_total_cost"])
        del per, lane
    log(f"[placement] sweep_placed_budgets {PLACED_BUDGETS} x {cfg.n_runs} runs: launches "
        f"{counts}; every lane's f_trace, q_final, placements and r_trace bitwise equal to "
        f"simulate_placed_many at its budget; sums and bills max_rel_err {worst:.3e} (tol "
        f"{PLACED_SUM_RTOL:g}); total $/slot by budget "
        + ", ".join(f"{mb}: {c:.2f}" for mb, c in zip(PLACED_BUDGETS, totals)))
    if worst > PLACED_SUM_RTOL:
        fail(f"placement: sweep lane sums off the per-budget calls by {worst:.3e}")
    log(f"[placement] {smi} | sweep call {t_grid * 1e3:.1f} ms (first call) against the three "
        f"per-budget calls {', '.join(f'{w * 1e3:.1f}' for w in per_walls)} ms; peak "
        f"{(peak - mem0) / 2**30:.2f} GiB above the start")
    del grid
    torch.cuda.empty_cache()

    # (d) one fleet run's flight record (the template run, the site loss).
    template, _ = make_fleet_builder(cfg, device=dev)
    tcfg = TelemetryConfig(level=TRACE, hist=HistogramSpec())
    reset_counts()
    outs, frame = simulate_placed(template, up, down, policy, rule, None, pcfg, scalar=cfg.v,
                                  ingest=ingest, sizes_gb=sizes, alive=lost, telemetry=tcfg)
    torch.cuda.synchronize()
    if read_counts()["gmsa_score"] != cfg.t_slots:
        fail(f"placement: flight record run launched {read_counts()}")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "placed_flight_record.jsonl"
        records = collect_records(outs, frame, cfg=tcfg, summary=summarize_placed(outs),
                                  meta={"scenario": "fleet_256 placed", "site_lost": fault_site})
        write_jsonl(records, path)
        check = cross_check(read_jsonl(path))
        out = subprocess.run([sys.executable, "-m", "repro_torch.telemetry.report", str(path),
                              "--check"], capture_output=True, text=True, timeout=300, cwd=ROOT,
                             env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    codes = {}
    for rec in records:
        if rec["type"] == "event":
            codes[rec["code"]] = codes.get(rec["code"], 0) + 1
    tail = [line for line in out.stdout.splitlines() if "cross-check" in line or "✓" in line
            or "✗" in line]
    log(f"[placement] flight record: {len(records)} records, events {codes}; report --check "
        f"exit {out.returncode}: " + " | ".join(x.strip() for x in tail))
    if out.returncode != 0 or not check["ok"]:
        fail(f"placement: flight record cross-check failed: {out.stdout[-2000:]} "
             f"{out.stderr[-2000:]}")
    return {"launches_placed": launches["drifting"], "launches_placed_sweep": sweep_launches}


def with_static_r(policy, r):
    """A carried-r base policy bound to a static (K, N, N) ``r``: the
    serving engine hands base policies ``(data_dist, wpue)``, and the
    lockstep policy reads ``r_t`` third."""
    def bound(generator, q, arrivals, mu, e, aux, scalar):
        return policy(generator, q, arrivals, mu, e, (aux[0], aux[1], r), scalar)

    bound.consumes_key = False
    bound.wants_wpue = True
    return bound


def watch_execution(eng, dev) -> dict:
    """Wrap every class's prefill and decode of ``eng``: the returned dict
    collects each class's prefill batch sizes (``batches``), whether every
    logit was finite and every fed token inside the class's vocabulary."""
    import torch

    ok = {"finite": torch.ones((), dtype=torch.bool, device=dev),
          "vocab": torch.ones((), dtype=torch.bool, device=dev),
          "batches": {rc.name: [] for rc in eng.classes}}
    for rc in eng.classes:
        prefill_fn, decode_fn = eng._prefill[rc.name], eng._decode[rc.name]

        def prefill(params, tokens, name=rc.name, prefill_fn=prefill_fn):
            ok["batches"][name].append(tokens.shape[0])
            logits, cache = prefill_fn(params, tokens)
            ok["finite"] &= torch.isfinite(logits).all()
            return logits, cache

        def decode(params, cache, tok, vocab=rc.cfg.vocab_size, decode_fn=decode_fn):
            ok["vocab"] &= ((tok >= 0) & (tok < vocab)).all()
            logits, cache = decode_fn(params, cache, tok)
            ok["finite"] &= torch.isfinite(logits).all()
            return logits, cache

        eng._prefill[rc.name], eng._decode[rc.name] = prefill, decode
    return ok


def phase_serve(dev, smi, cfg=None, exec_variant: str = "full") -> dict:
    import tempfile

    import numpy as np
    import torch

    from repro_torch.benchmarks import serve_bench
    from repro_torch.configs import get_arch
    from repro_torch.configs.fleet_256 import FleetConfig, make_serve_grid
    from repro_torch.jobs import stage_oblivious
    from repro_torch.launch.serve import serve_traces
    from repro_torch.serve import FleetConfig as ServeFleetConfig
    from repro_torch.serve import FleetEngine, RequestClass
    from repro_torch.telemetry import (
        SUMMARY,
        HistogramSpec,
        TelemetryConfig,
        cross_check,
        fleet_records,
        read_jsonl,
        write_jsonl,
    )

    def checked(what, fn, *args):
        try:
            return fn(*args)
        except AssertionError as exc:
            fail(f"serve: {what}: {exc}")

    # (a) the fleet serving grid, dispatch only, through gmsa_score.
    cfg = cfg or FleetConfig()
    t_slots, n, k = cfg.t_slots, cfg.n_sites, cfg.k_types
    omega, pue, r, up, down, layout, shares = make_serve_grid(cfg, k, t_slots, device=dev)
    smoke, full = get_arch(MAMBA_ARCH, "smoke"), get_arch(MAMBA_ARCH, "full")
    rcs = [RequestClass(name=f"{MAMBA_ARCH}/{i}", cfg=smoke, energy_cfg=full,
                        arrival_rate=SERVE_ARRIVAL) for i in range(k)]
    fc = ServeFleetConfig(n_pods=n, horizon_slots=t_slots, v=cfg.v, seed=1,
                          capacity_shares=shares, dispatch="kernel", admit_max=SERVE_ADMIT_MAX)
    grid = dict(up=up, down=down, layout=layout, device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    eng = FleetEngine(fc, rcs, omega, pue, r, **grid)
    scn = eng.scenario
    again = lambda **kw: FleetEngine(fc, rcs, omega, pue, r, scenario=scn, **grid, **kw)

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = eng.run(execute_real=False)
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    counts = read_counts()
    log(f"[serve] fleet grid N={n} K={k} T={t_slots} (mamba2-2.7b classes, smoke executes, "
        f"full prices; {SERVE_ARRIVAL:g} requests per class per slot, cap "
        f"{SERVE_ADMIT_MAX:g}), dispatch='kernel': launches {counts}; first run "
        f"{wall1 * 1e3:.1f} ms")
    if counts["gmsa_score"] != t_slots or counts["ssd_scan"]:
        fail(f"serve: launch counts {counts}, expected {t_slots} gmsa_score and no ssd_scan")
    for name in ("cost", "backlog", "wan_cost", "dispatch", "q_final"):
        if not np.isfinite(out[name]).all():
            fail(f"serve: non-finite {name}")
    replay = checked("replay pin against simulate_staged", serve_bench.check_replay, eng, out)
    conserve = checked("conservation", serve_bench.check_conservation, out)
    log(f"[serve] replay pin against simulate_staged: dispatch and WAN bill bitwise; cost "
        f"max_rel {replay['cost_rel']:.3e} (tol {serve_bench.COST_RTOL:g}), total "
        f"{replay['total_rel']:.3e} (tol {serve_bench.TOTAL_RTOL:g}), backlog max_rel "
        f"{replay['backlog_rel']:.3e} (tol {serve_bench.BACKLOG_RTOL:g} + "
        f"{serve_bench.BACKLOG_ATOL:g}); conservation "
        f"max_rel {conserve:.3e} (tol {serve_bench.CONSERVE_RTOL:g}); admitted "
        f"{out['admitted'].sum():.0f}, rejected {out['rejected'].sum():.0f}, completed "
        f"{out['completed'].sum():.1f}, final backlog {out['final_backlog']:.1f}, mean cost "
        f"{out['mean_cost']:.4e} $/slot, KV WAN {out['wan_cost'].sum():.4e} $ "
        f"({out['wan_gb'].sum():.1f} GB)")

    walls, timings = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        o = eng.run(execute_real=False)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        timings.append(o["timing"])
        if not np.array_equal(o["dispatch"], out["dispatch"]):
            fail("serve: a second run dispatched differently")
    per_slot = {part: statistics.median(tm[part] for tm in timings) / t_slots * 1e3
                for part in ("enqueue", "readback", "record")}
    log(f"[serve] {smi} | wall per dispatch-only run (calls 2-4): "
        f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms; median "
        f"{statistics.median(walls) * 1e3:.1f} ms ({statistics.median(walls) / t_slots * 1e3:.3f} "
        f"ms per slot); host per slot (median of the three): enqueueing the slot's device work "
        f"{per_slot['enqueue']:.3f} ms, the one readback (device wait included) "
        f"{per_slot['readback']:.3f} ms, bookkeeping and history {per_slot['record']:.3f} ms; "
        f"post-run bill {statistics.median(tm['bill'] for tm in timings) * 1e3:.1f} ms")
    log(f"[serve] {smi} | {device_busy_share(lambda: eng.run(execute_real=False))}")
    peak = torch.cuda.max_memory_allocated()
    log(f"[serve] {smi} | peak device memory of the phase so far {peak / 2**30:.2f} GiB "
        f"({(peak - mem0) / 2**30:.2f} GiB above the {mem0 / 2**30:.2f} GiB held before it)")

    tally = {"mism": torch.zeros((), dtype=torch.int64, device=dev),
             "flips": torch.zeros((), dtype=torch.int64, device=dev)}
    lock = again()
    lock.policy = stage_oblivious(with_static_r(lockstep_policy(scn.inputs.p_it, tally),
                                                scn.inputs.r), pin_map=True)
    lock.run(execute_real=False)
    mism = int(tally["mism"])
    log(f"[serve] lockstep: {t_slots * k} decisions, kernel and plain on the same aggregate "
        f"state every slot: off-tie mismatches {mism}, near-tie flips {int(tally['flips'])}")
    if mism:
        fail(f"serve: {mism} off-tie decision mismatches in lockstep")

    # A pod death: the pod holding the most backlog just before the slot.
    dead = int(np.argmax(out["history"][SERVE_FAULT_SLOT - 1]["q_pod"]))
    alive = np.ones((t_slots, n), np.float32)
    alive[SERVE_FAULT_SLOT:, dead] = 0.0
    stream = []
    reset_counts()
    fout = again(alive=alive).run(execute_real=False, stream=stream.append)
    torch.cuda.synchronize()
    f_counts = read_counts()
    ev = fout["events"]
    kinds = [(rec["type"], rec["t"]) for rec in stream]
    edge = ("event", SERVE_FAULT_SLOT)
    in_order = ([t for kind, t in kinds if kind == "metric"] == list(range(t_slots))
                and edge in kinds
                and kinds.index(edge) == kinds.index(("metric", SERVE_FAULT_SLOT)) + 1)
    dead_q = max(h["q_pod"][dead] for h in fout["history"][SERVE_FAULT_SLOT:])
    f_conserve = checked("conservation under the pod death", serve_bench.check_conservation,
                         fout)
    log(f"[serve] pod {dead} (most backlog at slot {SERVE_FAULT_SLOT - 1}: "
        f"{out['history'][SERVE_FAULT_SLOT - 1]['q_pod'][dead]:.1f}) dies at slot "
        f"{SERVE_FAULT_SLOT}: events {ev}; history[{SERVE_FAULT_SLOT}] recovery "
        f"{'recovery' in fout['history'][SERVE_FAULT_SLOT]}; stream records {len(stream)} in "
        f"slot order {in_order}; the dead pod's largest queue after it {dead_q}; dispatch mass "
        f"on it {float(fout['dispatch'][SERVE_FAULT_SLOT:, dead].sum())}; conservation "
        f"max_rel {f_conserve:.3e}; launches {f_counts}")
    if not (len(ev) == 1 and ev[0]["t"] == SERVE_FAULT_SLOT and ev[0]["pod"] == dead
            and ev[0]["drained"] > 0.0 and "recovery" in fout["history"][SERVE_FAULT_SLOT]
            and in_order and dead_q == 0.0 and float(fout["q_final"][dead].sum()) == 0.0
            and f_counts["gmsa_score"] == t_slots):
        fail("serve: pod-death recovery gates")

    ones = again(alive=np.ones((t_slots, n), np.float32)).run(execute_real=False)
    same = all(np.array_equal(out[name], ones[name])
               for name in ("dispatch", "cost", "wan_cost", "backlog", "q_final"))
    if not (same and ones["history"] == out["history"] and ones["events"] == []):
        fail("serve: an all-ones alive mask differs from none")
    tel = again(telemetry=TelemetryConfig(level=SUMMARY, hist=HistogramSpec()))
    hout = tel.run(execute_real=False)
    checked("conservation with the sojourn histogram", serve_bench.check_conservation, hout)
    same = all(np.array_equal(out[name], hout[name])
               for name in ("dispatch", "cost", "wan_cost", "backlog", "q_final"))
    mass = float(hout["sojourn_hist"].sum())
    log(f"[serve] all-ones alive bitwise equal to none; sojourn histogram mass {mass:.1f} "
        f"against completed {hout['completed'].sum():.1f}, p99 per class "
        f"{[round(p['p99'], 2) for p in hout['sojourn_percentiles']]}; outputs bitwise the "
        f"OFF run's {same and hout['history'] == out['history']}")
    if not (same and hout["history"] == out["history"]):
        fail("serve: the histogram layer changed the run's outputs")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "serve_flight_record.jsonl"
        records = fleet_records(hout, meta={"slo_backlog": fc.slo_backlog})
        write_jsonl(records, path)
        check = cross_check(read_jsonl(path))
        rep = subprocess.run([sys.executable, "-m", "repro_torch.telemetry.report", str(path),
                              "--check", "--percentiles"], capture_output=True, text=True,
                             timeout=300, cwd=ROOT,
                             env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    tail = [line for line in rep.stdout.splitlines() if "cross-check" in line]
    log(f"[serve] flight record: {len(records)} records; report --check exit "
        f"{rep.returncode}: " + " | ".join(x.strip() for x in tail))
    if rep.returncode != 0 or not check["ok"]:
        fail(f"serve: flight record cross-check failed: {rep.stdout[-2000:]} "
             f"{rep.stderr[-2000:]}")
    del eng, lock, tel, out, fout, ones, hout, scn
    torch.cuda.empty_cache()

    # (b) real execution at full width: the drained jobs run prefill +
    # decode on mamba2-2.7b, every prefill layer's scan through ssd_scan.
    xcfg = get_arch(MAMBA_ARCH, exec_variant)
    x = SERVE_EXEC
    x_omega, x_pue, x_r, x_up, x_down, x_layout = serve_traces(1, x["pods"], x["slots"], x["seed"],
                                                               dev)
    xfc = ServeFleetConfig(n_pods=x["pods"], horizon_slots=x["slots"], v=1.0, seed=x["seed"],
                           admit_max=x["admit_max"], dispatch="kernel")
    rc = RequestClass(MAMBA_ARCH, cfg=xcfg, energy_cfg=xcfg, arrival_rate=x["arrival"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    xeng = FleetEngine(xfc, [rc], x_omega, x_pue, x_r, up=x_up, down=x_down, layout=x_layout,
                       device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    ok = watch_execution(xeng, dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    xout = xeng.run(execute_real=True)
    torch.cuda.synchronize()
    x_wall = time.perf_counter() - t0
    x_counts = read_counts()
    want = [min(int(round(c)), xfc.exec_cap) for c in xout["completed"][:, 0]]
    b = xfc.batch_per_exec
    n_batches = sum(-(-j // b) for j in want)
    width = "full-width" if exec_variant == "full" else exec_variant
    log(f"[serve] {smi} | {width} {MAMBA_ARCH} ({xcfg.num_layers} layers, random fp32 "
        f"weights, built in {t_init:.2f} s) executing the drained jobs of N={x['pods']}, "
        f"T={x['slots']} (dispatch='kernel'): jobs per slot {want}, exec_jobs "
        f"{xout['exec_jobs']}, prefill batches {ok['batches'][MAMBA_ARCH]}; launches {x_counts}; logits "
        f"finite {bool(ok['finite'])}, tokens in vocabulary {bool(ok['vocab'])}; run wall "
        f"{x_wall:.2f} s, {x_wall / x['slots']:.3f} s per slot, execution "
        f"{xout['exec_seconds']:.2f} s = {xout['exec_seconds'] / max(xout['exec_jobs'], 1):.3f} "
        f"s per job")
    if not (xout["exec_jobs"] == sum(want) > 0 and ok["batches"][MAMBA_ARCH] == [
            min(b, j - i) for j in want for i in range(0, j, b)]
            and x_counts["ssd_scan"] == xcfg.num_layers * n_batches
            and x_counts["gmsa_score"] == x["slots"] and xout["exec_seconds"] > 0.0
            and bool(ok["finite"]) and bool(ok["vocab"])):
        fail(f"serve: real execution gates: exec_jobs {xout['exec_jobs']} (want {sum(want)}), "
             f"launches {x_counts} (want {xcfg.num_layers * n_batches} ssd_scan)")
    wall, events = device_profile(lambda: xeng._execute_jobs(rc, b))
    dev_us = sum(us for _, us, _ in events)
    k_us = sum(us for name, us, _ in events if is_ssd_kernel(name))
    share = f"{100 * k_us / dev_us:.2f}%" if dev_us > 0 else "not measured"
    top = ", ".join(f"{name[:40]} {us / 1e3:.2f} ms x{c}" for name, us, c in events[:4])
    log(f"[serve] {smi} | one executed batch ({b} x {rc.prompt_len}-token prompts + "
        f"{rc.gen_len} tokens) under torch.profiler: {wall * 1e3:.1f} ms wall, device busy "
        f"{dev_us / 1e3:.2f} ms, ssd_scan chain {k_us / 1e3:.3f} ms = {share} of device time; "
        f"top: {top}; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del xeng
    torch.cuda.empty_cache()

    # (c) the launcher, as a user runs it.
    t0 = time.perf_counter()
    launch = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--classes",
                             MAMBA_ARCH, "--slots", "24", "--pods", "8", "--dispatch", "kernel"],
                            capture_output=True, text=True, timeout=600, cwd=ROOT,
                            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    lines = launch.stdout.strip().splitlines()
    log(f"[serve] python -m repro_torch.launch.serve --classes {MAMBA_ARCH} --slots 24 --pods 8 "
        f"--dispatch kernel: "
        f"exit {launch.returncode} in {time.perf_counter() - t0:.1f} s: "
        + " | ".join(line.strip() for line in lines[:1] + lines[-3:]))
    if launch.returncode != 0:
        fail(f"serve: the launcher failed: {launch.stdout[-2000:]} {launch.stderr[-2000:]}")
    return {"gmsa_score": counts["gmsa_score"], "ssd_scan": x_counts["ssd_scan"]}


def attention_inputs(gen, b, s, h, hkv, d, dev):
    """Unit-normal q (B,S,H,d), k and v (B,S,Hkv,d), positions 0..S-1."""
    import torch

    rand = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    return rand(b, s, h, d), rand(b, s, hkv, d), rand(b, s, hkv, d), torch.arange(s, device=dev)


def phase_dense(dev, smi, variant: str = "full", attn_shapes=DENSE_ATTN_SHAPES,
                batches=DENSE_BATCHES) -> int:
    import torch
    import torch.nn.functional as F

    from repro_torch.benchmarks import serve_bench
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve_traces
    from repro_torch.models.attention import _mask_bias, attend_blockwise, attend_naive
    from repro_torch.models.lm import count_params, init_params
    from repro_torch.serve import FleetConfig as ServeFleetConfig
    from repro_torch.serve import FleetEngine, RequestClass
    from repro_torch.serve.step import make_local_exec

    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # (a) blockwise against naive attention on the card, and the library's
    # fused attention beside them (timed, not used).
    gen = torch.Generator(device=dev).manual_seed(21)
    for b, s, h, hkv, d, causal, window in attn_shapes:
        q, k, v, pos = attention_inputs(gen, b, s, h, hkv, d, dev)
        kw = dict(causal=causal, window=window)
        with torch.inference_mode():
            blk = attend_blockwise(q, k, v, pos, pos, **kw)
            ref = attend_naive(q, k, v, pos, pos, **kw)
            err = rel_err(blk, ref)
            t_blk = call_time_ms(lambda: attend_blockwise(q, k, v, pos, pos, **kw), iters=5)
            t_naive = call_time_ms(lambda: attend_naive(q, k, v, pos, pos, **kw), iters=5)
            qt = q.transpose(1, 2)
            kt, vt = (x.repeat_interleave(h // hkv, dim=2).transpose(1, 2) for x in (k, v))
            mask = None if causal and not window else _mask_bias(pos, pos, causal, window) == 0
            sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                         is_causal=mask is None)
            err_sdpa = rel_err(sdpa().transpose(1, 2), ref)
            t_sdpa = call_time_ms(sdpa, iters=5)
        log(f"[dense] {smi} | attention ({b}, {s}, {h} heads on {hkv}, d {d}, "
            f"{'causal' if causal else 'bidirectional'}, window {window}): blockwise vs naive "
            f"max_rel_err {err:.3e} (tol {ATTN_TOL:g}); blockwise {t_blk:.3f} ms, naive "
            f"{t_naive:.3f} ms, F.scaled_dot_product_attention {t_sdpa:.3f} ms (fp32, KV "
            f"repeated; not used by the port; max_rel_err {err_sdpa:.3e})")
        if not err <= ATTN_TOL:
            fail(f"dense: blockwise attention off naive at {(b, s, h, hkv, d)}: {err:.3e}")
        del q, k, v, blk, ref, qt, kt, vt, mask
    torch.cuda.empty_cache()

    # (b) each model at its published widths and depth, served as the
    # reference's FleetEngine._execute_jobs runs a batch.
    for arch, n_params in DENSE_ARCHS.items():
        cfg = get_arch(arch, variant)
        if variant == "full" and count_params(cfg) != n_params:
            fail(f"{arch}: {count_params(cfg)} parameters, expected {n_params}")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), torch.float32,
                             device=dev)
        torch.cuda.synchronize()
        log(f"[dense] {arch} ({variant}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
            f"{cfg.num_heads} heads on {cfg.num_kv_heads} x {cfg.resolved_head_dim}, d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab_size}): {count_params(cfg)} random fp32 params "
            f"initialised on the card in {time.perf_counter() - t0:.2f} s")
        vocab = cfg.vocab_size
        tgen = torch.Generator(device=dev).manual_seed(11)
        tokens = [torch.randint(0, vocab, (b, s + 1), generator=tgen, device=dev)
                  for b, s, _ in batches]
        execs = [make_local_exec(cfg, g, device=dev) for _, _, g in batches]

        def serve(i):
            (b, s, gen_len), (prefill_fn, decode_fn) = batches[i], execs[i]
            t0 = time.perf_counter()
            logits, cache = prefill_fn(params, tokens[i][:, :s])
            torch.cuda.synchronize()
            t_pre = time.perf_counter() - t0
            nan = torch.isnan(logits).any()
            tok = torch.argmax(logits[:, -1:, :vocab], dim=-1)
            t0 = time.perf_counter()
            for _ in range(gen_len):
                logits, cache = decode_fn(params, cache, tok)
                nan = nan | torch.isnan(logits).any()
                tok = torch.argmax(logits[:, :, :vocab], dim=-1)
            torch.cuda.synchronize()
            return not bool(nan), t_pre, (time.perf_counter() - t0) / gen_len

        torch.cuda.synchronize()
        reset_counts()
        runs = [serve(i) for i in range(len(batches))]
        torch.cuda.synchronize()
        counts = read_counts()
        for (b, s, g), (clean, t_pre, t_dec) in zip(batches, runs):
            log(f"[dense] {arch} served {b} x {s}-token prompts + {g} greedy tokens: no NaN "
                f"logit {clean}; prefill {t_pre * 1e3:.1f} ms, decode {t_dec * 1e3:.2f} "
                f"ms/token (first call)")
            if not clean:
                fail(f"dense: {arch}: a NaN logit serving {b} x {s}")
        log(f"[dense] {arch} main path launches {counts} (attention is plain PyTorch)")
        if any(counts.values()):
            fail(f"dense: {arch}: launch counts {counts}, expected none")

        for i, (b, s, _) in enumerate(batches):
            prefill_fn, decode_fn = execs[i]
            _, cache = prefill_fn(params, tokens[i][:, :s])
            out = {}
            wall, events = device_profile(
                lambda: out.update(dec=decode_fn(params, cache, tokens[i][:, s:s + 1])[0]))
            if i == 0:
                dev_us = sum(us for _, us, _ in events)
                log(f"[dense] {smi} | {arch} one decode step (batch {b}, cache "
                    f"{s + batches[i][2] + 1} slots) under torch.profiler: {wall * 1e3:.1f} ms "
                    f"wall, device busy {dev_us / 1e3:.2f} ms ({100 * dev_us / 1e6 / wall:.1f}%), "
                    f"{sum(c for _, _, c in events)} device kernels")
            full, _ = prefill_fn(params, tokens[i])
            dec, full = out["dec"][:, -1, :vocab], full[:, -1, :vocab]
            scale = float(full.abs().max())
            rel = float((dec - full).abs().max()) / scale
            pick = torch.argmax(dec, dim=-1)
            gap = full.max(dim=-1).values - torch.gather(full, -1, pick[:, None])[:, 0]
            off_tie = int(((pick != torch.argmax(full, dim=-1))
                           & (gap > DECODE_REL_TOL * scale)).sum())
            log(f"[dense] {arch} decode consistency {b} x {s}: prefill+decode vs prefill of "
                f"S+1, max |diff| / max |logit| = {rel:.3e} (tol {DECODE_REL_TOL:g}), greedy "
                f"tokens differing off near-ties {off_tie}")
            if not rel <= DECODE_REL_TOL or off_tie:
                fail(f"dense: {arch} decode consistency {b} x {s}: rel {rel:.3e}, "
                     f"off-tie {off_tie}")
            del cache, full, dec

        walls = [serve(0) for _ in range(2)]
        b, s, g = batches[0]
        log(f"[dense] {smi} | {arch} prefill wall per batch ({b} x {s}, calls 2-3): "
            f"{', '.join(f'{w[1] * 1e3:.1f}' for w in walls)} ms; decode wall per token "
            f"(batch {b}, {g} tokens each): {', '.join(f'{w[2] * 1e3:.2f}' for w in walls)} ms")
        prefill_fn = execs[0][0]
        wall, events = device_profile(lambda: prefill_fn(params, tokens[0][:, :s]))
        dev_us = sum(us for _, us, _ in events)
        q, k, v, pos = attention_inputs(gen, b, s, cfg.num_heads, cfg.num_kv_heads,
                                        cfg.resolved_head_dim, dev)
        with torch.inference_mode():
            t_attn = call_time_ms(lambda: attend_blockwise(
                q, k, v, pos, pos, causal=cfg.causal, window=cfg.sliding_window), iters=5)
        del q, k, v
        top = ", ".join(f"{name[:48]} {us / 1e3:.2f} ms x{c}" for name, us, c in events[:6])
        share = (f"{100 * cfg.num_layers * t_attn * 1e3 / dev_us:.1f}%" if dev_us > 0
                 else "not measured")
        log(f"[dense] {smi} | {arch} one prefill ({b} x {s}) under torch.profiler: "
            f"{wall * 1e3:.1f} ms wall, device busy {dev_us / 1e3:.1f} ms "
            f"({100 * dev_us / 1e6 / wall:.1f}%); attention (blockwise, {t_attn:.2f} ms per "
            f"layer timed alone, x{cfg.num_layers}) = {share} of device time; top: {top}")
        log(f"[dense] {smi} | {arch} peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del params, execs, tokens
        torch.cuda.empty_cache()

    # (c) the launcher's default classes at full width, executing the
    # drained jobs of a short run; dispatch through gmsa_score every slot.
    x = SERVE_EXEC
    archs = list(DENSE_ARCHS)
    x_omega, x_pue, x_r, x_up, x_down, x_layout = serve_traces(len(archs), x["pods"],
                                                               x["slots"], x["seed"], dev)
    xfc = ServeFleetConfig(n_pods=x["pods"], horizon_slots=x["slots"], v=1.0, seed=x["seed"],
                           admit_max=x["admit_max"], dispatch="kernel")
    rcs = [RequestClass(a, cfg=get_arch(a, variant), energy_cfg=get_arch(a, variant),
                        arrival_rate=x["arrival"]) for a in archs]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    xeng = FleetEngine(xfc, rcs, x_omega, x_pue, x_r, up=x_up, down=x_down, layout=x_layout,
                       device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    ok = watch_execution(xeng, dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    xout = xeng.run(execute_real=True)
    torch.cuda.synchronize()
    x_wall = time.perf_counter() - t0
    x_counts = read_counts()
    want = {a: [min(int(round(c)), xfc.exec_cap) for c in xout["completed"][:, i]]
            for i, a in enumerate(archs)}
    b = xfc.batch_per_exec
    conserve = serve_bench.check_conservation(xout)
    n_jobs = sum(sum(w) for w in want.values())
    log(f"[dense] {smi} | FleetEngine with the launcher's default classes {archs} "
        f"({variant} width, random fp32 weights, built in {t_init:.2f} s), N={x['pods']}, "
        f"T={x['slots']}, dispatch='kernel': jobs per slot {want}, exec_jobs "
        f"{xout['exec_jobs']}, prefill batches {ok['batches']}; launches {x_counts}; logits "
        f"finite {bool(ok['finite'])}, tokens in vocabulary {bool(ok['vocab'])}; conservation "
        f"max_rel {conserve:.3e}; run wall {x_wall:.2f} s, {x_wall / x['slots']:.3f} s per "
        f"slot, execution {xout['exec_seconds']:.2f} s = "
        f"{xout['exec_seconds'] / max(xout['exec_jobs'], 1):.3f} s per job; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not (xout["exec_jobs"] == n_jobs > 0
            and all(ok['batches'][a] == [min(b, j - i) for j in want[a] for i in range(0, j, b)]
                    for a in archs)
            and x_counts["gmsa_score"] == x["slots"] and x_counts["ssd_scan"] == 0
            and xout["exec_seconds"] > 0.0 and bool(ok["finite"]) and bool(ok["vocab"])):
        fail(f"dense: serving execution gates: exec_jobs {xout['exec_jobs']} (want {n_jobs}), "
             f"launches {x_counts} (want {x['slots']} gmsa_score, no ssd_scan)")
    del xeng
    torch.cuda.empty_cache()

    # (d) the launcher with its default classes, as a user runs it.
    t0 = time.perf_counter()
    launch = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve"],
                            capture_output=True, text=True, timeout=600, cwd=ROOT,
                            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    lines = launch.stdout.strip().splitlines()
    log(f"[dense] python -m repro_torch.launch.serve (default classes): exit "
        f"{launch.returncode} in {time.perf_counter() - t0:.1f} s: "
        + " | ".join(line.strip() for line in lines[:1] + lines[-3:]))
    if launch.returncode != 0:
        fail(f"dense: the launcher failed: {launch.stdout[-2000:]} {launch.stderr[-2000:]}")
    return x_counts["gmsa_score"]


def is_gemm_kernel(name: str) -> bool:
    """Whether a profiler kernel name is a cuBLAS / CUTLASS GEMM's."""
    low = name.lower()
    return any(tag in low for tag in ("gemm", "xmma", "cutlass", "kernel2"))


def topk_off_tie_mismatches(idx, idx_ref, probs_ref, k: int) -> tuple[int, int]:
    """(tokens whose expert indices differ with no near-tie, tokens that
    differ at a near-tie): a near-tie is two of the reference's router
    probabilities among the token's top k + 1 within TOPK_TIE."""
    import torch

    top = torch.sort(probs_ref.reshape(-1, probs_ref.shape[-1]), dim=-1,
                     descending=True).values[:, :k + 1]
    near = (top[:, :-1] - top[:, 1:]).abs().le(TOPK_TIE).any(dim=-1)
    differ = (idx.reshape(-1, k) != idx_ref.reshape(-1, k)).any(dim=-1)
    return int((differ & ~near).sum()), int((differ & near).sum())


def moe_layer_gate(params, cfg, tokens) -> dict:
    """Layer 0's ``moe_ffn`` on 1 x MOE_GATE_TOKENS real tokens (embedded,
    RMS-normed) on the card and on the CPU with the same weights: routing,
    drops, output and aux held against each other; the card's call
    bitwise-repeatable (no atomics in the combine)."""
    import torch

    from repro_torch.models import moe
    from repro_torch.models.layers import rms_norm

    names = ("router", "we_gate", "we_up", "we_down")
    with torch.inference_mode():
        w_dev = [params["blocks"][name][0] for name in names]
        x_dev = rms_norm(params["embed"][tokens[:1, :MOE_GATE_TOKENS]],
                         params["blocks"]["ln2"][0], cfg.norm_eps)
        w_cpu, x_cpu = [w.cpu() for w in w_dev], x_dev.cpu()
        cap = moe.expert_capacity(MOE_GATE_TOKENS, cfg, 1.25)
        out = {}
        for where, x, w in (("card", x_dev, w_dev), ("cpu", x_cpu, w_cpu)):
            t0 = time.perf_counter()
            y, aux = moe.moe_ffn(x, *w, cfg)
            _, idx, _ = moe.route_topk(x, w[0], cfg.top_k)
            probs = torch.softmax(x.float() @ w[0].float(), dim=-1)
            plan = moe.dispatch_plan(idx, cfg.num_experts, cap)
            if where == "card":
                torch.cuda.synchronize()
                y2, aux2 = moe.moe_ffn(x, *w, cfg)
                if not (torch.equal(y, y2) and torch.equal(aux, aux2)):
                    fail("moe_hybrid: moe_ffn on the card is not bitwise repeatable")
            out[where] = {"y": y.cpu(), "aux": float(aux), "idx": idx.cpu(), "probs": probs.cpu(),
                          "dropped": (plan["pos"] >= cap).cpu(),
                          "secs": time.perf_counter() - t0}
    card, cpu = out["card"], out["cpu"]
    off_tie, near_tie = topk_off_tie_mismatches(card["idx"], cpu["idx"], cpu["probs"], cfg.top_k)
    n_dropped = int(cpu["dropped"].sum())
    same_drops = bool(torch.equal(card["dropped"], cpu["dropped"]))
    err = rel_err(card["y"], cpu["y"])
    aux_rel = abs(card["aux"] - cpu["aux"]) / abs(cpu["aux"])
    log(f"[moe] {cfg.name} layer 0 moe_ffn on 1 x {MOE_GATE_TOKENS} tokens (C = {cap}), card "
        f"against CPU with the same weights: expert indices differing off near-ties "
        f"{off_tie}, at near-ties {near_tie}; dropped pairs {n_dropped} of "
        f"{MOE_GATE_TOKENS * cfg.top_k}, the same set {same_drops}; output max_rel_err "
        f"{err:.3e} (tol {MODEL_TOL:g}); aux card {card['aux']:.7f} CPU {cpu['aux']:.7f} "
        f"(rel {aux_rel:.3e}, tol {AUX_RTOL:g}); bitwise repeatable on the card; CPU call "
        f"{cpu['secs']:.2f} s")
    if off_tie:
        fail(f"moe_hybrid: {off_tie} tokens routed differently off near-ties, card vs CPU")
    if near_tie:
        # A near-tie flip moves later pairs' capacity slots, so the drops and
        # the output differ by construction: they are not compared then.
        log(f"[moe] {near_tie} near-tie flips: drops and output not compared")
    elif not (same_drops and err <= MODEL_TOL and aux_rel <= AUX_RTOL):
        fail(f"moe_hybrid: card vs CPU: drops equal {same_drops} ({n_dropped}), output "
             f"{err:.3e}, aux {aux_rel:.3e}")
    return {"off_tie": off_tie, "near_tie": near_tie, "dropped": n_dropped,
            "max_rel_err": err, "aux_rel": aux_rel}


def serve_model(arch: str, cfg, params, batch, dev, smi) -> dict:
    """One model of phase 16 served as the reference's
    ``FleetEngine._execute_jobs`` runs a batch: the main path (counts read
    around it), its gates, then steady walls, device profiles and peak
    memory."""
    import torch

    from repro_torch.models.lm import cache_len_for, forward
    from repro_torch.serve.step import make_local_exec

    b, s, gen_len = batch
    vocab = cfg.vocab_size
    tokens = torch.randint(0, vocab, (b, s + 1), generator=torch.Generator(device=dev).manual_seed(11),
                           device=dev)
    prefill_fn, decode_fn = make_local_exec(cfg, gen_len, device=dev)

    def serve():
        t0 = time.perf_counter()
        logits, cache = prefill_fn(params, tokens[:, :s])
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        finite = torch.isfinite(logits).all()
        tok = torch.argmax(logits[:, -1:, :vocab], dim=-1)
        t0 = time.perf_counter()
        for _ in range(gen_len):
            logits, cache = decode_fn(params, cache, tok)
            finite = finite & torch.isfinite(logits).all()
            tok = torch.argmax(logits[:, :, :vocab], dim=-1)
        torch.cuda.synchronize()
        pos = cache["pos"].tolist()
        return bool(finite), pos, t_pre, (time.perf_counter() - t0) / gen_len

    torch.cuda.synchronize()
    reset_counts()
    finite, pos, t_pre, t_dec = serve()
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"[moe] {arch} served {b} x {s}-token prompts + {gen_len} greedy tokens: logits finite "
        f"{finite}, pos {sorted(set(pos))}; prefill {t_pre * 1e3:.1f} ms, decode "
        f"{t_dec * 1e3:.2f} ms/token (first call); main path launches {counts}")
    want_ssd = cfg.num_layers if cfg.has_ssm else 0
    if not (finite and pos == [s + gen_len] * b):
        fail(f"moe_hybrid: {arch}: finite {finite}, pos {pos}")
    if counts != {"gmsa_score": 0, "ssd_scan": want_ssd}:
        fail(f"moe_hybrid: {arch}: launch counts {counts}, expected {want_ssd} ssd_scan")
    rec = {"counts": counts, "prefill_ms_first": t_pre * 1e3, "decode_ms_first": t_dec * 1e3}

    if cfg.is_moe:
        # The router's aux over one prompt (prefill_step keeps only the cache).
        with torch.inference_mode():
            _, aux = forward(params, cfg, tokens[:1, :s])
        aux = float(aux)
        log(f"[moe] {arch} forward on 1 x {s}: summed router aux {aux:.6f} over "
            f"{cfg.num_layers} layers")
        if not (math.isfinite(aux) and aux > 0.0):
            fail(f"moe_hybrid: {arch}: aux {aux}")
        rec["aux"] = aux
    else:
        # Decode consistency: prefill(t[:, :S]) + decode(t[:, S]) == prefill(t[:, :S+1]).
        _, cache = prefill_fn(params, tokens[:, :s])
        dec = decode_fn(params, cache, tokens[:, s:s + 1])[0][:, -1, :vocab]
        del cache
        full = prefill_fn(params, tokens)[0][:, -1, :vocab]
        scale = float(full.abs().max())
        rel = float((dec - full).abs().max()) / scale
        pick = torch.argmax(dec, dim=-1)
        gap = full.max(dim=-1).values - torch.gather(full, -1, pick[:, None])[:, 0]
        off_tie = int(((pick != torch.argmax(full, dim=-1)) & (gap > DECODE_REL_TOL * scale)).sum())
        log(f"[moe] {arch} decode consistency {b} x {s} (a {cache_len_for(cfg, s + gen_len)}-slot "
            f"ring, wrapped): prefill+decode vs prefill of S+1, max |diff| / max |logit| = "
            f"{rel:.3e} (tol {DECODE_REL_TOL:g}), greedy tokens differing off near-ties {off_tie}")
        if not rel <= DECODE_REL_TOL or off_tie:
            fail(f"moe_hybrid: {arch} decode consistency: rel {rel:.3e}, off-tie {off_tie}")
        rec["decode_rel"] = rel
        del dec, full

    walls = [serve() for _ in range(2)]
    log(f"[moe] {smi} | {arch} prefill wall per batch ({b} x {s}, calls 2-3): "
        f"{', '.join(f'{w[2] * 1e3:.1f}' for w in walls)} ms; decode wall per token (batch {b}, "
        f"{gen_len} tokens each): {', '.join(f'{w[3] * 1e3:.2f}' for w in walls)} ms")
    rec["prefill_ms"] = [w[2] * 1e3 for w in walls]
    rec["decode_ms"] = [w[3] * 1e3 for w in walls]

    _, cache = prefill_fn(params, tokens[:, :s])
    wall, events = device_profile(lambda: decode_fn(params, cache, tokens[:, s:s + 1]))
    del cache
    dev_us = sum(us for _, us, _ in events)
    launched = sum(c for _, _, c in events)
    log(f"[moe] {smi} | {arch} one decode step (batch {b}) under torch.profiler: "
        f"{wall * 1e3:.1f} ms wall, device busy {dev_us / 1e3:.2f} ms "
        f"({100 * dev_us / 1e6 / wall:.1f}%), {launched} device kernels")
    rec["decode_launches"] = launched
    wall, events = device_profile(lambda: prefill_fn(params, tokens[:, :s]))
    dev_us = sum(us for _, us, _ in events)
    gemm_us = sum(us for name, us, _ in events if is_gemm_kernel(name))
    ssd_us = sum(us for name, us, _ in events if is_ssd_kernel(name))
    top = ", ".join(f"{name[:48]} {us / 1e3:.2f} ms x{c}" for name, us, c in events[:6])
    pct = lambda us: f"{100 * us / dev_us:.1f}%" if dev_us > 0 else "not measured"
    log(f"[moe] {smi} | {arch} one prefill ({b} x {s}) under torch.profiler: {wall * 1e3:.1f} ms "
        f"wall, device busy {dev_us / 1e3:.1f} ms ({100 * dev_us / 1e6 / wall:.1f}%); GEMM "
        f"kernels {gemm_us / 1e3:.1f} ms = {pct(gemm_us)}; ssd_scan chain {ssd_us / 1e3:.2f} ms "
        f"= {pct(ssd_us)}; top: {top}")
    rec.update(prefill_busy_ms=dev_us / 1e3, gemm_share=gemm_us / dev_us if dev_us else None,
               ssd_ms=ssd_us / 1e3)

    if cfg.is_moe:
        # One MoE layer at the prefill's real input, by kernel name: the
        # GEMMs are the three expert products and the (S, D) x (D, E)
        # router; every other kernel is routing, dispatch and combine.
        from repro_torch.models import moe
        from repro_torch.models.layers import rms_norm

        with torch.inference_mode():
            lp = {name: leaf[0] for name, leaf in params["blocks"].items()}
            x = rms_norm(params["embed"][tokens[:, :s]], lp["ln2"], cfg.norm_eps)
            _, events = device_profile(lambda: moe.moe_ffn(
                x, lp["router"], lp["we_gate"], lp["we_up"], lp["we_down"], cfg))
        del x
        layer_us = sum(us for _, us, _ in events)
        expert_us = sum(us for name, us, _ in events if is_gemm_kernel(name))
        route_us = layer_us - expert_us
        top = ", ".join(f"{name[:40]} {us / 1e3:.2f} ms x{c}" for name, us, c in events[:5])
        log(f"[moe] {smi} | {arch} layer 0's moe_ffn at ({b}, {s}) under torch.profiler: "
            f"device {layer_us / 1e3:.2f} ms: expert GEMMs (and the router's) "
            f"{expert_us / 1e3:.2f} ms, routing/dispatch/combine {route_us / 1e3:.2f} ms; "
            f"x{cfg.num_layers} layers = {pct(cfg.num_layers * expert_us)} and "
            f"{pct(cfg.num_layers * route_us)} of prefill device time; top: {top}")
        rec.update(expert_share=cfg.num_layers * expert_us / dev_us if dev_us else None,
                   route_share=cfg.num_layers * route_us / dev_us if dev_us else None,
                   expert_ms_layer=expert_us / 1e3, route_ms_layer=route_us / 1e3)
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[moe] {smi} | {arch} peak device memory {rec['peak_gib']:.2f} GiB")
    return rec


def phase_moe_hybrid(dev, smi, variant: str = "full", batches=None) -> dict:
    """Phase 16: deepseek-moe-16b and phi3.5-moe (depth cut) and hymba-1.5b
    at their published widths through ``make_local_exec``, the one-layer
    card-against-CPU MoE gate, then ``FleetEngine`` executing with a MoE
    class and with a hybrid + dense pair. ``variant="smoke"`` (with small
    ``batches``: arch -> (b, s, gen)) rehearses it on the CPU."""
    import dataclasses

    import torch

    from repro_torch.benchmarks import serve_bench
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve_traces
    from repro_torch.models.lm import count_params, init_params
    from repro_torch.serve import FleetConfig as ServeFleetConfig
    from repro_torch.serve import FleetEngine, RequestClass

    out = {}
    for arch, (n_params, layers, batch) in MOE_HYBRID_ARCHS.items():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        cfg = get_arch(arch, variant)
        if variant == "full" and count_params(cfg) != n_params:
            fail(f"{arch}: {count_params(cfg)} parameters, expected {n_params}")
        full_layers = cfg.num_layers
        if layers < full_layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        depth = (f"{cfg.num_layers} of {full_layers} layers" if cfg.num_layers < full_layers
                 else f"{cfg.num_layers} layers")
        batch = (batches or {}).get(arch, batch)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), torch.float32,
                             device=dev)
        torch.cuda.synchronize()
        ffn = (f"{cfg.num_experts} experts (top {cfg.top_k}, {cfg.num_shared_experts} shared, "
               f"width {cfg.moe_d_ff})" if cfg.is_moe else f"d_ff {cfg.d_ff}")
        ssm = (f", SSM {cfg.ssm_heads} heads x {cfg.ssm_head_dim}, state {cfg.ssm_state}"
               if cfg.has_ssm else "")
        log(f"[moe] {arch} ({variant}: {depth}, d_model {cfg.d_model}, {cfg.num_heads} heads "
            f"on {cfg.num_kv_heads} x {cfg.resolved_head_dim}, {ffn}{ssm}, window "
            f"{cfg.sliding_window}): {count_params(cfg)} random fp32 params "
            f"({count_params(cfg, active_only=True)} active per token) initialised on the card "
            f"in {time.perf_counter() - t0:.2f} s; {torch.cuda.memory_allocated() / 2**30:.2f} "
            f"GiB held")
        rec = serve_model(arch, cfg, params, batch, dev, smi)
        if arch == "deepseek-moe-16b":
            tokens = torch.randint(0, cfg.vocab_size, (1, MOE_GATE_TOKENS),
                                   generator=torch.Generator(device=dev).manual_seed(13),
                                   device=dev)
            rec["layer_gate"] = moe_layer_gate(params, cfg, tokens)
        out[arch] = rec
        del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # (d) FleetEngine executing with the new classes, one run per class set.
    x = SERVE_EXEC
    for archs in MOE_HYBRID_SERVE:
        torch.cuda.empty_cache()
        x_omega, x_pue, x_r, x_up, x_down, x_layout = serve_traces(
            len(archs), x["pods"], x["slots"], x["seed"], dev)
        xfc = ServeFleetConfig(n_pods=x["pods"], horizon_slots=x["slots"], v=1.0,
                               seed=x["seed"], admit_max=x["admit_max"], dispatch="kernel")
        rcs = [RequestClass(a, cfg=get_arch(a, variant), energy_cfg=get_arch(a, variant),
                            arrival_rate=x["arrival"]) for a in archs]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        xeng = FleetEngine(xfc, rcs, x_omega, x_pue, x_r, up=x_up, down=x_down, layout=x_layout,
                           device=dev)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        ok = watch_execution(xeng, dev)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        xout = xeng.run(execute_real=True)
        torch.cuda.synchronize()
        x_wall = time.perf_counter() - t0
        x_counts = read_counts()
        want = {a: [min(int(round(c)), xfc.exec_cap) for c in xout["completed"][:, i]]
                for i, a in enumerate(archs)}
        b = xfc.batch_per_exec
        batches_run = {a: [min(b, j - i) for j in want[a] for i in range(0, j, b)] for a in archs}
        want_ssd = sum(rc.cfg.num_layers * len(batches_run[rc.name]) for rc in rcs
                       if rc.cfg.has_ssm)
        try:
            conserve = serve_bench.check_conservation(xout)
        except AssertionError as exc:
            fail(f"moe_hybrid: serving {archs}: {exc}")
        n_jobs = sum(sum(w) for w in want.values())
        per_job = xout["exec_seconds"] / max(xout["exec_jobs"], 1)
        log(f"[moe] {smi} | FleetEngine with classes {list(archs)} ({variant} width, random fp32 "
            f"weights, built in {t_init:.2f} s), N={x['pods']}, T={x['slots']}, "
            f"dispatch='kernel': jobs per slot {want}, exec_jobs {xout['exec_jobs']}, prefill "
            f"batches {ok['batches']}; launches {x_counts}; logits finite {bool(ok['finite'])}, "
            f"tokens in vocabulary {bool(ok['vocab'])}; conservation max_rel {conserve:.3e}; run "
            f"wall {x_wall:.2f} s, {x_wall / x['slots']:.3f} s per slot, execution "
            f"{xout['exec_seconds']:.2f} s = {per_job:.3f} s per job; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if not (xout["exec_jobs"] == n_jobs > 0 and ok["batches"] == batches_run
                and x_counts == {"gmsa_score": x["slots"], "ssd_scan": want_ssd}
                and xout["exec_seconds"] > 0.0
                and bool(ok["finite"]) and bool(ok["vocab"])):
            fail(f"moe_hybrid: serving execution gates for {archs}: exec_jobs "
                 f"{xout['exec_jobs']} (want {n_jobs}), launches {x_counts} (want "
                 f"{x['slots']} gmsa_score, {want_ssd} ssd_scan)")
        key = "serve_moe" if any(get_arch(a, variant).is_moe for a in archs) else "serve_hybrid"
        out[key] = {"counts": x_counts, "per_job_s": per_job, "exec_jobs": xout["exec_jobs"]}
        del xeng
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.kernels._build import SOURCES

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = phase_device()
    phase_build()
    main_shape = phase_kernels(dev)
    mism, lock_rel = phase_lockstep(dev)
    launches, _ = phase_end_to_end(dev)
    phase_paper(dev)
    ssd = phase_ssd_kernel(dev)
    ssd_launches = phase_mamba2(dev, smi)
    sweep_launches = phase_sweep(dev, smi)
    phase_figures(dev, smi)
    tel_launches = phase_telemetry(dev, smi)
    staged_launches = phase_staged(dev, smi)
    placed = phase_placement(dev, smi)
    serve = phase_serve(dev, smi)
    dense_launches = phase_dense(dev, smi)
    moe_hybrid = phase_moe_hybrid(dev, smi)

    entry = {
        "name": "gmsa_score",
        "route": "cuda",
        "source": str(SOURCES["gmsa_score"].relative_to(ROOT)),
        "replaces": "src/repro/kernels/gmsa_score/kernel.py:34",
        "launches": launches,
        "launches_sweep_grid": sweep_launches,
        "launches_telemetry": tel_launches,
        "launches_staged": staged_launches,
        "launches_placed": placed["launches_placed"],
        "launches_placed_sweep": placed["launches_placed_sweep"],
        "launches_serve": serve["gmsa_score"],
        "launches_serve_dense": dense_launches,
        "launches_serve_moe": moe_hybrid["serve_moe"]["counts"]["gmsa_score"],
        "launches_serve_hybrid": moe_hybrid["serve_hybrid"]["counts"]["gmsa_score"],
        "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": None,
        "max_rel_err": max(main_shape["max_rel_err"], lock_rel),
        "off_tie_mismatches": mism,
        "phase_ms": main_shape["phase_ms"],
        "workspace_rel_err": main_shape["workspace_rel_err"],
        "ms_sweep": main_shape["ms_sweep"],
        "plain_ms_sweep": main_shape["plain_ms_sweep"],
        "bound_ms_sweep": main_shape["bound_ms_sweep"],
        "phase_ms_sweep": main_shape["phase_ms_sweep"],
        "ms_bench": main_shape["ms_bench"],
        "plain_ms_bench": main_shape["plain_ms_bench"],
        "bound_ms_bench": main_shape["bound_ms_bench"],
        "phase_ms_bench": main_shape["phase_ms_bench"],
        "ms_per_run_r": main_shape["ms_per_run_r"],
        "plain_ms_per_run_r": main_shape["plain_ms_per_run_r"],
        "bound_ms_per_run_r": main_shape["bound_ms_per_run_r"],
        "bound_by_per_run_r": main_shape["bound_by_per_run_r"],
        "library_ms_per_run_r": main_shape["library_ms_per_run_r"],
        "phase_ms_per_run_r": main_shape["phase_ms_per_run_r"],
        "max_abs_err_per_run_r": main_shape["max_abs_err_per_run_r"],
        "ms_serve": main_shape["ms_serve"],
        "plain_ms_serve": main_shape["plain_ms_serve"],
        "bound_ms_serve": main_shape["bound_ms_serve"],
        "phase_ms_serve": main_shape["phase_ms_serve"],
        "host_ms_serve": main_shape["host_ms_serve"],
    }
    ssd_entry = {
        "name": "ssd_scan",
        "route": "cuda",
        "source": str(SOURCES["ssd_scan"].relative_to(ROOT)),
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:29",
        "launches": ssd_launches,
        "launches_serve": serve["ssd_scan"],
        "max_abs_err": ssd["max_abs_err"],
        "ms": ssd["ms"],
        "plain_ms": ssd["plain_ms"],
        "bound_ms": ssd["bound_ms"],
        "bound_by": ssd["bound_by"],
        "library_ms": None,   # no single PyTorch call computes the SSD scan
        "max_rel_err_fp32": ssd["max_rel_err_fp32"],
        "max_rel_err_bf16": ssd["max_rel_err_bf16"],
        "plain_chunked_ms": ssd["plain_chunked_ms"],
        "phase_ms": ssd["phase_ms"],
        "workspace_rel_err": ssd["workspace_rel_err"],
        "ms_32k": ssd["ms_32k"],
        "plain_chunked_ms_32k": ssd["plain_chunked_ms_32k"],
        "bound_ms_32k": ssd["bound_ms_32k"],
        "phase_ms_32k": ssd["phase_ms_32k"],
        "ms_serve": ssd["ms_serve"],
        "plain_ms_serve": ssd["plain_ms_serve"],
        "bound_ms_serve": ssd["bound_ms_serve"],
        "bound_by_serve": ssd["bound_by_serve"],
        "launches_hybrid": moe_hybrid["hymba-1.5b"]["counts"]["ssd_scan"],
        "launches_serve_hybrid": moe_hybrid["serve_hybrid"]["counts"]["ssd_scan"],
        "max_abs_err_hybrid": ssd["max_abs_err_hybrid"],
        "ms_hybrid": ssd["ms_hybrid"],
        "plain_ms_hybrid": ssd["plain_ms_hybrid"],
        "bound_ms_hybrid": ssd["bound_ms_hybrid"],
        "bound_by_hybrid": ssd["bound_by_hybrid"],
    }
    log(f"[device] {smi}")
    print(json.dumps({"kernels": [entry, ssd_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
