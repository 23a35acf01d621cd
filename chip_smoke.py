#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one line or more; any failure exits non-zero:

1. device  — require CUDA; print the card's name and power limit.
2. build   — compile every kernel from ``src/repro_torch/kernels/*/csrc``
             with nvcc (all sources at once) into ``build/torch_kernels/``;
             ptxas's registers, spills and shared memory per kernel, and both
             SSD chains' tensor-core (HMMA) instructions per kernel from
             ``cuobjdump -sass`` where the toolkit has it; fails if a kernel
             of the backward chain or the forward's chunk_state or
             chunk_scan spills, or if chunk_dstate, chunk_bwd, chunk_dbc,
             chunk_state or chunk_scan (in fp32 and in bf16) has no HMMA.
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
             of the chain's five kernels' mean time over three profiled calls;
             at mamba2-2.7b's training microbatch in fp32 and bf16 the chain
             and each kernel alone beside their bounds, and bf16 y within one
             bf16 ulp + SSD_BWD_TOL of the max there and at two one-element-
             copy shapes. (``--ssd-arm SRC DUMP [--steps]`` runs one arm of a
             parent-against-change comparison instead: ssd_arm.)
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
17. frontends — the modality-frontend backbones (plain PyTorch; no kernel
             on their own path): (a) full-width, full-depth hubert-xlarge
             (random fp32 weights) on 4 x 1500 stub frames from
             ``make_batch`` (bf16, no tokens): exact parameter count, its
             decode shapes refused by ``shape_applicable``, logits finite
             and (4, 1500, 512), no kernel launched, blockwise against naive
             attention at 1 x 1500 within FRONTEND_ATTN_TOL (non-causal, keys
             padded to 2048); forward wall, device busy share, attention's
             share of device time, peak memory; (b) internvl2-76b at its
             published widths, 8 of its 80 layers, ``prefill_step`` on 4 x
             (256 image + 1792 text) from ``make_batch``'s vision stub, then
             16 greedy tokens: exact counts, finite logits, pos 2064, no
             kernel launched, decode consistent with the whole prefill
             within DECODE_REL_TOL; prefill wall, decode wall and launches
             per token, busy share, peak memory; (c) both smoke models on
             the card against the CPU with the same weights and numpy stubs
             (forward, prefill logits, KV ring) within MODEL_TOL; (d)
             ``FleetEngine`` executing N = 4, T = 6 with a full-width
             hubert-xlarge class (token prompts) and qwen2-0.5b: one
             ``gmsa_score`` launch per slot, no ``ssd_scan``, exact
             ``exec_jobs``, conservation.
18. entry points — ``python -m repro_torch.examples.{quickstart,
             staged_jobs, adaptive_placement, serve_geo}`` at once, each
             exiting 0 only where its claim holds (GMSA V=100 cheapest with
             bounded backlog; the stage-aware arm cheaper on cost and WAN
             GB; adaptive placement cheaper, no dispatch to the dead site;
             both serving classes executing); then ``python -m
             repro_torch.benchmarks.run --record build/bench_torch.json``
             with REPRO_BENCH_RUNS=100: exit 0, a CSV line with positive µs
             per call from every ported bench (shard_bench's two lines with
             bitwise=True among them; kernel_bench's seven kernel rows, each
             agreeing with the plain version), the roofline table's line
             over at least phase 21 (a)'s cells, no SKIPPED line, the
             record labelled torch_full.
19. train — training on the card (``repro_torch.train``, slice 8a): (a) the
             ``ssd_scan`` backward chain (``csrc/ssd_scan_bwd.cu``, five
             kernels behind one ``ssd_scan_bwd_launch``) against
             ``ssd_scan_bwd_phases_ref`` (every workspace too) and
             against autograd through the sequential ``ssd_scan_ref`` at the
             smoke shape, a multi-chunk one, a ragged S and hymba's heads,
             each with a nonzero gradient of the final state: every
             gradient within SSD_BWD_TOL of its max, bitwise-repeatable
             launches, the wrapper's ``SsdScanFn`` bitwise the direct calls;
             each shape again with bf16 x, B, C and dy (the bf16 chain; dx,
             dB, dC within one bf16 ulp + SSD_BWD_TOL of the max); device
             time, in fp32 and bf16, at mamba2-2.7b's training microbatch (2 x 2048) and
             hymba's 4 x 2048 beside the forward chain, the plain version
             and two bounds (fp32 operands: at the fp32 rate and as
             3xTF32; bf16: mixed products as 2xTF32 with the bf16 pairs at
             the bf16 rate, and as TF32 only; ssd_bwd_bound_ms), each
             kernel's time alone (CUDA events) beside its own bounds; (b)
             full-width, full-depth mamba2-2.7b trained through
             ``make_train_step``, in fp32 (random fp32 weights; a warm-up
             step and two timed ones), then in bf16 (the same draws
             rounded: bf16 params, fp32 moments and gradient sums, the bf16
             chain; a warm-up step and three timed ones, step 1's loss
             within 1e-2 of fp32's): 4 x 2048 tokens per step from the
             token stream, two microbatches, full remat, the launcher's
             AdamW; each step with exactly 256
             forward and 128 backward chain launches, finite loss and grad
             norm > 0; layer 0's real SSD operands and upstream gradient
             through the backward chain against the plain version; step
             wall, tokens/s, device busy share, the chains' share of step
             device time, the optimizer alone, peak memory; (c) full-width
             qwen2-0.5b the same way: no kernel launched, finite loss; step
             wall, peak memory, attention's share of step device time; (d)
             ``python -m repro_torch.examples.train_lm`` (its claim through
             the failure at 150) and the smoke launcher with a failure at
             25 as subprocesses, each exiting 0 after one restart; the same
             smoke run in process with and without the failure: final
             params bitwise equal, or within TRAIN_REPLAY_RTOL.
20. substrate — the substrate on one card (``repro_torch.distributed``):
             (a) ``shard_bench``'s paper scenario (facebook_4dc, T = 48,
             GMSA) at 1000 runs, one chunk against eight, bitwise, both
             walls; (b) full fleet_256 ``simulate_many`` through
             ``make_kernel_policy(None)`` at R = 1000 with ``runs_mesh(1)``,
             ``runs_mesh(8)`` and ``runs_mesh(7)`` (padded): every output
             bitwise across the three, ``gmsa_score`` launches 288 x chunks,
             wall and peak memory of each call; (c) phase 12's staged fleet
             (K = 8, S = 3, seed 17) through ``stage_oblivious(
             make_kernel_policy(None), pin_map=True)`` at R = 1000 in 10
             chunks against 8, then at R = 100 with the degraded-link bill
             (``link_health`` as phase 13 draws it) in 25 chunks of 4 runs
             against 20 of 5, and ``link_health=None`` against all-ones:
             bitwise each, launches 288 x chunks, walls, peak memory; (d)
             full-width qwen2-0.5b on a two-pod mesh, 4 x 2048 tokens a step,
             two microbatches, full remat: three steps at ``grad_sync=
             "native"`` and three at ``"int8"`` from the same params, losses
             finite, step 1 within 1e-6, steps 2-3 within 1e-2 of the native
             loss, the largest param difference after one step, step walls,
             the int8 sync's device time, peak memory; (e)
             ``make_prefill_step`` / ``make_decode_step`` on qwen2-0.5b at full
             width, 4 x 2048 prompts: prefill logits bitwise
             ``make_local_exec``'s, decode at ``kv_shard="heads"`` bitwise
             ``"seq"``.
21. dryrun — the dry-run (``repro_torch.launch.dryrun``) against the card:
             (a) in a process of its own that needs no card, started after
             phase 1 and collected before phase 18, one meta-device pass of
             each cell the card measures in this run, at its shape, in fp32
             and in bf16 (full-width mamba2-2.7b and qwen2-0.5b training 4
             x 2048 with phase 19's microbatches and remat; their 4 x 2048
             prefills): FLOPs, bytes, argument and peak bytes, the H100
             data-sheet roofline (the fp32 weight products gemm_f32 takes
             priced as 3xTF32), each artifact written where the
             orchestrator's roofline bench reads it, no kernel launched; (b)
             after phase 20, the bf16 prefill step timed at full width,
             then every bound at or below the card's fastest wall of that
             cell (fp32 prefills: phases 8 and 15; training: phase 19 (b) /
             (c)), the train cells' dry-run peaks within 15% of
             ``max_memory_allocated``, each share of the roofline printed.
22. gemm    — ``gemm_f32`` (3xTF32 on the tensor cores) at mamba2-2.7b's
             and hymba-1.5b's prefill products, ragged tiles and the serving
             engine's M = 128, on unit-normal x: its largest gap to fp64
             over |x|·|W| within GEMM_LIB_FACTOR of cuBLAS fp32 SGEMM's and
             GEMM_TF32_FACTOR under one TF32 product's, within GEMM_REF_TOL
             of the plain 3xTF32 version, launches bitwise repeatable; its
             time beside ``torch.matmul``'s (library_ms) and the 3xTF32
             bound; the size rule's grid (kernel and ``torch.matmul`` at
             each shape); one fp32 prefill batch of each model: the
             counters (``gemm_f32_cuda.launches``,
             ``matmul_f32.library_calls``), its walls beside the same
             prefill with every product on ``torch.matmul`` and their gaps
             (logits_rel, state_rel); two-layer bf16 and fp32 training
             steps launch no gemm_f32. (``--gemm`` runs phase 2's build of
             it, with the spill gate, and this phase alone.) Phase 2 fails
             if it spills.
23. results — one JSON line of per-kernel numbers, then the device line.

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
#: Dense TF32 and bf16 on the H100 SXM tensor cores (peak rates), for the
#: SSD backward chain's tensor-core bounds (ssd_bwd_bound_ms).
H100_TF32_FLOPS = 495e12
H100_BF16_FLOPS = 989e12

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
#: The chain's kernels that run on the tensor cores (HMMA in their SASS, in
#: the fp32 and the bf16 instantiations).
SSD_MMA_PHASES = ("chunk_cb", "chunk_state", "chunk_scan")
#: Phase 7's shapes, with the model's input ranges, in fp32 and in bf16,
#: each with its tag and CUDA-graph (reps, iters) for the chain, for each of
#: its kernels alone (on filled workspaces) and for the one-call yardsticks:
#: mamba2-2.7b's training microbatch (2 x 2048, phase 19 (b) runs the chain
#: 256 times a step), the serving engine's prefill batch (4 x 32, chunk 32)
#: and the 4 x 2048 prefill (phase 8).
SSD_FWD_TIMED = {(2, 2048, 80, 64, 128, 256): ("train", 5, 4), SSD_ENGINE_SHAPE: ("engine", 20, 10),
                 SSD_SERVE_SHAPE: ("prefill", 5, 4)}
#: bf16 x, B, C: y against ssd_scan_phases_ref on the same operands within
#: one bf16 ulp + SSD_BWD_TOL of the max (bf16_excess), at the timed shapes
#: and at two where the copies move one element (P, N no multiple of 8).
SSD_FWD_BF16_SHAPES = [(2, 130, 4, 20, 40, 65), (1, 1300, 3, 7, 9, 65)]
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
#: Phase 17, the frontend backbones. hubert-xlarge at full width and depth
#: on 4 x 1500 frames (30 s of audio at 50 frames/s, a typical speech chunk;
#: 1500 keys pad to 2048, so the padded-key mask runs under non-causal
#: attention): (arch, exact parameter count, (requests, frames)).
#: internvl2-76b at its published widths cut to 8 of its 80 layers (263 GiB
#: in fp32 at full depth, 33.4 GiB cut) on 4 x (256 image + 1792 text)
#: tokens + 16 greedy ones: (arch, count at full depth, layers run, count at
#: those layers, (requests, prefix + text tokens, generated tokens)).
HUBERT = ("hubert-xlarge", 946_241_280, (4, 1500))
INTERNVL = ("internvl2-76b", 70_562_103_296, 8, 8_954_986_496, (4, 2048, 16))
#: hubert's blockwise against naive logits at 1 x 1500, relative to max
#: |logit|: 48 fp32 layers with the softmax summed in another order.
FRONTEND_ATTN_TOL = 1e-3
#: Phase 17 (d): the serving execution run with a full-width audio class
#: fed token prompts (as the reference's make_local_exec feeds it) beside a
#: dense one.
FRONTEND_SERVE = ("hubert-xlarge", "qwen2-0.5b")
#: Phase 18, the user-facing entry points: the examples (run at once, each
#: its own process), then the bench orchestrator at ENTRY_BENCH_RUNS runs,
#: each ported bench known by its CSV lines' prefix.
ENTRY_EXAMPLES = ("quickstart", "staged_jobs", "adaptive_placement", "serve_geo")
ENTRY_BENCH_RUNS = 100
ENTRY_BENCHES = {"fig5": "fig5", "fig6": "fig6", "sim_bench": "sim_",
                 "placement_bench": "placement_", "jobs_bench": "jobs_",
                 "kernel_bench": ("gmsa_dispatch_", "gmsa_matrix_", "fleet256_e2e_",
                                  "ssd_chunked_", "ssd_matrix_"),
                 "serve_bench": "torch_serve_", "shard_bench": "shard_"}
#: kernel_bench's rows of the kernel arm (each agreeing with the plain
#: version before it prints): three dispatch scales, the gmsa matrix, the
#: fleet end to end, the SSD layer and the SSD matrix.
ENTRY_KERNEL_ROWS = 7
#: The roofline table's line (µs 0.0 by the reference's contract: derived,
#: not timed), held by its ``cells=``: at least phase 21 (a)'s cells.
ENTRY_ROOFLINE = "roofline_table_baseline"
ENTRY_SKIPPED = ()
ENTRY_RECORD = "build/bench_torch.json"
#: Phase 19, training. (a) The ssd_scan backward chain against its plain
#: versions, (B, S, H, P, N, chunk): the smoke model's shape (unit-normal
#: inputs), then with the model's input ranges a multi-chunk one, a ragged
#: S = 300 (padded to 512) and hymba-1.5b's heads and state; each with a
#: nonzero gradient of the final state.
SSD_BWD_SHAPES = [(2, 64, 8, 32, 16, 32), (2, 512, 80, 64, 128, 256), (2, 300, 80, 64, 128, 256),
                  (2, 512, 50, 64, 16, 256)]
#: Each gradient (dx, ddt, da, dB, dC) within SSD_BWD_TOL of its largest
#: |value|, against ssd_scan_bwd_phases_ref (the same algorithm: only fp32
#: summation orders differ) and against autograd through the sequential
#: ssd_scan_ref (an independent formulation: per-step decays against
#: exponents of cumsum differences). SSD_TEST_TOL's 3e-4 is the forward's;
#: the CPU check of the plain chunked backward against fp64 autograd through
#: the recurrence gave at most 9e-6 of the max (da: a sum over every step
#: of a product of reverse cumsums), so 3e-4 leaves 30x room for the card's
#: other summation orders and is kept.
SSD_BWD_TOL = 3e-4
#: The chain's kernels, in launch order (``ssd_bwd_<phase>_kernel``).
SSD_BWD_PHASES = ("chunk_dstate", "dstate_pass", "chunk_bwd", "chunk_dbc", "dbc_sum")
#: The chain's outputs and workspaces, as _ssd_scan_bwd_cuda_phases and
#: ssd_scan_bwd_phases_ref return them.
SSD_BWD_OUTPUTS = ("dx", "ddt", "da", "dB", "dC", "G", "R", "scale_out", "scale_in", "part",
                   "da_part", "R_part")
#: The chain's kernels that run on the tensor cores (HMMA in their SASS).
SSD_BWD_MMA_PHASES = ("chunk_dstate", "chunk_bwd", "chunk_dbc")
#: Timed: mamba2-2.7b's training microbatch (2 x 2048, phase 19 (b)) and
#: hymba-1.5b's 4 x 2048 prefill shape, with CUDA-graph (reps, replays) for
#: the chain and for each of its kernels alone.
SSD_BWD_TIMED = {(2, 2048, 80, 64, 128, 256): ("train", 3, 4),
                 (4, 2048, 50, 64, 16, 256): ("hybrid", 3, 4)}
#: (b) and (c): full-width training through make_train_step, the
#: launcher's AdamW (lr 3e-3, no warm-up at these few steps): 4 x 2048
#: tokens per step from the synthetic token stream (seed 0), two
#: microbatches, full remat; one warm-up step, then TRAIN_TIMED_STEPS (an
#: fp32 arm TRAIN_TIMED_STEPS_FP32: it is the slower and only a reference
#: for bf16's step 1), the schedule set for TRAIN_TIMED_STEPS in both.
#: mamba2-2.7b at full depth (64 layers: 64 x 2 x 2 = 256 forward chains
#: and 64 x 2 = 128 backward chains per step), then the launcher's default
#: arch, qwen2-0.5b (no kernel on its path). Each in fp32, then in bf16
#: (the JAX package's training precision: bf16 params, fp32 moments and
#: gradient sums; mamba2's SSD gradients through the bf16 chain) from the
#: same draws rounded: the bf16 step-1 loss within TRAIN_BF16_LOSS_RTOL of
#: fp32's (the same params to bf16's 8 bits, the same batch). Phase 21 (b)
#: times the dry-run's bf16 prefill step PREFILL_TIMED_CALLS times after a
#: warm-up call (prefill_walls).
TRAIN_ARCHS = (MAMBA_ARCH, "qwen2-0.5b")
TRAIN_BATCH = (4, 2048)
TRAIN_MICROBATCHES = 2
TRAIN_REMAT = "full"
TRAIN_TIMED_STEPS = 3
TRAIN_TIMED_STEPS_FP32 = 2
TRAIN_BF16_LOSS_RTOL = 1e-2
PREFILL_TIMED_CALLS = 2
#: (d) the entry points: the example (its claim through the failure at
#: 150) and the smoke launcher with a failure, as subprocesses; then the
#: same smoke run in process with and without the failure. Where the two
#: final params differ (the tied embedding's backward, an index_put with
#: accumulation, sums in an order that may change between runs on CUDA),
#: each leaf's largest difference is held to TRAIN_REPLAY_RTOL of the
#: leaf's largest value.
TRAIN_SMOKE_ARGS = ("--arch", MAMBA_ARCH, "--variant", "smoke", "--steps", "40", "--batch", "8",
                    "--seq", "128", "--ckpt-every", "10")
TRAIN_SMOKE_FAIL_AT = 25
TRAIN_REPLAY_RTOL = 1e-5

#: Phase 20, the substrate on one card: the Monte-Carlo runs axis in chunks
#: (repro_torch.distributed.mesh), the int8 pod-axis gradient sync in the
#: train step and the sharded serving steps at world size 1. (a)
#: shard_bench's paper scenario (facebook_4dc, T = 48, GMSA) at SUB_RUNS
#: runs, one chunk against SUB_SHARD_CHUNKS; (b) fleet_256 simulate_many
#: through the kernel policy at SUB_RUNS runs in each of SUB_FLEET_CHUNKS
#: (7 does not divide 1000: padded); (c) phase 12's staged fleet at
#: SUB_RUNS runs in each of SUB_STAGED_CHUNKS, then at SUB_DEGRADED_RUNS
#: with the degraded-link bill in each of SUB_DEGRADED_CHUNKS (4 and 5 runs
#: a chunk); every chunk count bitwise the first's, on every output.
SUB_RUNS = 1000
SUB_SHARD_CHUNKS = 8
SUB_FLEET_CHUNKS = (1, 8, 7)
SUB_STAGED_CHUNKS = (10, 8)
SUB_DEGRADED_RUNS = 100
SUB_DEGRADED_CHUNKS = (25, 20)
#: (d) full-width qwen2-0.5b on a ("pod",) mesh of two pods, TRAIN_BATCH
#: tokens a step in TRAIN_MICROBATCHES microbatches, full remat, the
#: reference's AdamW defaults (a run's first steps: lr warming up to 3e-4
#: over 100 steps), from the same params under grad_sync "native" and
#: "int8": SUB_POD_STEPS steps each. The sync comes after the loss, so the
#: step-1 losses differ only by the order of the means (each pod's rows
#: first under int8): within SUB_POD_STEP1_RTOL (the reference's
#: tests/test_distributed.py holds the step-1 loss to 1e-3 absolute on its
#: smoke model). Later steps train on int8-synced gradients: within
#: SUB_POD_LOSS_RTOL of the native loss. Each pod's row is half a leaf under
#: one absmax scale, so most entries of an early gradient round to 0 and do
#: not move, where AdamW's first steps move every entry by about lr: on the
#: H100 the gap was 2.56e-3 of the loss at step 3 (1e-3 was asked for and
#: not met), about lr times the summed size of the entries that rounded to
#: 0. The CPU tests hold the int8 step to the reference's own
#: (tests/test_torch_distributed.py).
SUB_POD_ARCH = "qwen2-0.5b"
SUB_POD_STEPS = 3
SUB_POD_STEP1_RTOL = 1e-6
SUB_POD_LOSS_RTOL = 1e-2
#: (e) make_prefill_step / make_decode_step at full width on SUB_SERVE_BATCH
#: prompts: prefill logits bitwise make_local_exec's, decode "heads" bitwise
#: "seq".
SUB_SERVE_BATCH = (4, 2048)

#: Phase 21, the dry-run against the card (repro_torch.launch.dryrun): the
#: cells this run measures anyway, at their own shapes, counted on the meta
#: device in each of DRY_DTYPES: (arch, kind, (B, S), the phase that
#: measures its fp32 walls). Train cells take phase 19's microbatches and
#: remat; prefill cells the serving steps' blockwise attention. bf16 (the
#: dry-run's own dtype, as the reference's): the train steps of phase 19
#: (b) / (c)'s bf16 arms, the prefill step timed in phase 21 (b).
DRY_CELLS = ((MAMBA_ARCH, "train", TRAIN_BATCH, "19 (b)"),
             ("qwen2-0.5b", "train", TRAIN_BATCH, "19 (c)"),
             (MAMBA_ARCH, "prefill", (4, 2048), "8"),
             ("qwen2-0.5b", "prefill", (4, 2048), "15 (b)"))
#: The train cells' dry-run peak (live storage bytes on meta) against
#: torch.cuda.max_memory_allocated(): the caching allocator rounds each
#: block up and keeps cuBLAS's workspace, the meta count neither.
DRY_PEAK_RTOL = 0.15
DRY_DTYPES = ("float32", "bfloat16")
#: Host seconds the eight meta passes are given (logged against, not gated:
#: the host's speed varies between machines). They run in a process of
#: their own beside phases 2-17 (start_dryrun), which needs no card.
DRY_HOST_BUDGET_S = 90


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
    h_final written once; the work the function needs (ssd_fwd_work) — CBᵀ
    once per (b, chunk) (all heads share it), the causal half of W @ x, C @
    h_inᵀ, the state update and the state recurrence — against the H100's
    memory rate and fp32 rate."""
    nbytes, ops = ssd_fwd_work(b, s, h, p, n, q, itemsize)
    return bound_ms(nbytes, sum(ops.values()))


def rel_err(got, want) -> float:
    """max |got - want| / max(|want|, 1), elementwise, in fp32."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / want.abs().clamp_min(1.0)).max())


def kernel_counters():
    """Every kernel's launch counter, by name (what a main path reads)."""
    from repro_torch.kernels.gmsa_score.kernel import gmsa_score_cuda
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_bwd_cuda, ssd_scan_cuda

    return {"gmsa_score": gmsa_score_cuda, "ssd_scan": ssd_scan_cuda,
            "ssd_scan_bwd": ssd_scan_bwd_cuda}


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


def kernel_name(mangled: str) -> str:
    """A kernel function's short name from its mangled one (with ``<bf16>``
    for the bf16 instantiation, ``<true>`` or ``<2>`` for a bool or int
    template argument)."""
    import re

    short = re.search(r"\d+((?:ssd_scan|ssd_bwd|gmsa|gemm_f32)\w*?_kernel)(I((?:L[bi]\d+E|f|\d+__nv_bfloat16)+)E)?",
                      mangled)
    name = short.group(1) if short else mangled
    args = re.findall(r"L([bi])(\d+)E", short.group(3)) if short and short.group(2) else []
    if args:
        name += "<" + ", ".join(("false", "true")[int(v)] if t == "b" else v for t, v in args) + ">"
    return name + ("<bf16>" if "bfloat16" in mangled else "")


def ptxas_usage(text: str) -> list[str]:
    """One line per kernel function from an ``nvcc -Xptxas -v`` log: its
    name (``kernel_name``), registers, stack frame, spill stores and loads,
    shared memory."""
    import re

    rows = []
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            rows.append({"name": kernel_name(m.group(1))})
        elif rows and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                                      r"(\d+) bytes spill loads", line)):
            rows[-1]["spills"] = (f"stack frame {m.group(1)} B, spill stores {m.group(2)} B, "
                                  f"spill loads {m.group(3)} B")
        elif rows and (m := re.search(r"Used (\d+) registers", line)):
            smem = re.search(r"(\d+) bytes smem", line)
            rows[-1]["regs"] = f"{m.group(1)} registers"
            rows[-1]["smem"] = f"{smem.group(1) if smem else 0} B static smem"
    return [", ".join(r.get(k, f"{k} not reported") for k in ("name", "regs", "spills", "smem"))
            for r in rows]


def sass_mma_counts(lib: Path, prefix: str) -> dict[str, dict[str, int]] | None:
    """Per kernel function of ``lib`` whose short name starts with
    ``prefix``: its tensor-core (HMMA) instructions in the SASS that
    ``cuobjdump -sass`` prints, counted by opcode (``{}`` for none). None
    where the toolkit has no cuobjdump or it fails."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    try:
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                              timeout=120, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    counts, name = {}, None
    for line in sass.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            name = kernel_name(m.group(1))
            name = name if name.startswith(prefix) else None
            if name:
                counts[name] = {}
        elif name and (m := re.search(r"\b(HMMA\.\S+)", line)):
            counts[name][m.group(1)] = counts[name].get(m.group(1), 0) + 1
    return counts


#: Kernel functions whose spills fail the build: the SSD chains and gemm_f32.
SPILL_GATED = ("ssd_bwd_", "ssd_scan_", "gemm_f32_")


def spill_gate(logs: dict[str, str]) -> None:
    """Logs ptxas's registers, spills and shared memory per kernel function
    of ``logs`` (library -> ``nvcc -Xptxas -v`` log); fails where a
    SPILL_GATED function spills or ptxas did not say."""
    import re

    spilled = []
    for name, text in logs.items():
        for usage in ptxas_usage(text):
            log(f"[build] {name}: ptxas {usage}")
            m = re.search(r"spill stores (\d+) B, spill loads (\d+) B", usage)
            if usage.startswith(SPILL_GATED) and (m is None or m.group(1) != "0"
                                                  or m.group(2) != "0"):
                spilled.append(usage)
    if spilled:
        fail(f"SSD or gemm_f32 kernels spill (or ptxas did not say): {spilled}")


def phase_build() -> dict[str, dict[str, dict[str, int]] | None]:
    """Builds every kernel, logs ptxas's registers, spills and shared memory
    per kernel function, then the SSD chains' HMMA counts per library (None:
    not measured). Fails where a kernel spills (spill_gate), or one of
    SSD_BWD_MMA_PHASES / SSD_MMA_PHASES has no HMMA in an instantiation (the
    forward's in both element types)."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    secs = time.perf_counter() - t0
    spill_gate(logs)
    log(f"[build] {len(logs)} kernel(s) built in {secs:.2f} s -> {_build.BUILD_DIR}")
    mma = {}
    for lib, prefix, phases in (("ssd_scan", "ssd_scan_", SSD_MMA_PHASES),
                                ("ssd_scan_bwd", "ssd_bwd_", SSD_BWD_MMA_PHASES)):
        mma[lib] = counts = sass_mma_counts(_build.library_path(lib), prefix)
        if counts is None:
            log(f"[build] {lib}: tensor-core instructions not measured (no cuobjdump)")
            continue
        for fn, ops in counts.items():
            log(f"[build] {lib}: sass {fn}: {sum(ops.values())} HMMA"
                + "".join(f", {op} x{c}" for op, c in sorted(ops.items())))
        for ph in phases:
            fns = {fn: ops for fn, ops in counts.items() if fn.startswith(f"{prefix}{ph}_kernel")}
            typed = lib == "ssd_scan_bwd" or (any(f.endswith("<bf16>") for f in fns)
                                             and not all(f.endswith("<bf16>") for f in fns))
            if not fns or not typed or not all(sum(ops.values()) for ops in fns.values()):
                fail(f"{lib}: {ph} without tensor-core instructions (in fp32 and bf16): {fns}")
    return mma


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
    # Device-side events only: a CPU op also reports its kernels' time. A
    # device-side user annotation (a record_function range under CUDA)
    # spans its kernels and the gaps between them, so it is left out too.
    # (torch < 2.4 names the field self_cuda_time_total.)
    dev_time = lambda e: getattr(e, "self_device_time_total", None) or getattr(
        e, "self_cuda_time_total", 0.0)
    events = [(e.key, dev_time(e), e.count) for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
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
    main.update(phase_ssd_fwd(dev))
    return main


def ssd_fwd_work(b: int, s: int, h: int, p: int, n: int, q: int,
                 elt: int = 4) -> tuple[int, dict[str, int]]:
    """Bytes and operations of one ssd_scan call (x, dt, a, B, C read once,
    y and h_final written once, x, B, C, y at ``elt`` bytes an element; S
    padded to a chunk multiple as the wrapper pads), the operations by the
    class of their
    operands as ssd_bwd_work's: "pair", CBᵀ (B and C); "mixed", the
    products with one fp32 operand (the causal half of W x per head, C
    h_inᵀ and the state update (x ⊙ w)ᵀ B); "vector", state_pass's
    recurrence."""
    full, rem = divmod(s, q)
    pairs = full * q * (q + 1) // 2 + rem * (rem + 1) // 2
    nbytes = elt * (2 * b * s * h * p + 2 * b * s * n) + 4 * (b * s * h + h + b * h * p * n)
    return nbytes, {"pair": 2 * pairs * b * n,
                    "mixed": 2 * pairs * b * h * p + 4 * b * s * h * p * n,
                    "vector": 2 * b * -(-s // q) * h * p * n}


def ssd_fwd_phase_work(b: int, s: int, h: int, p: int, n: int, q: int,
                       elt: int = 4) -> dict[str, tuple[int, dict[str, int]]]:
    """Bytes and operations (by class, as ssd_fwd_work's) of each kernel of
    the forward chain alone, each of its inputs read once and outputs
    written once (S a multiple of Q): cumsum reads dt, a and writes cum;
    chunk_cb reads B, C and writes the causal half of CBᵀ (pair); chunk_state
    reads x, dt, B, cum and writes the chunks' states (mixed); state_pass
    reads them and cum_Q and writes h_in and h_final (vector); chunk_scan
    reads x, dt, C, cum, the causal half of CBᵀ and h_in and writes y (W x
    and C h_inᵀ, mixed). x, B, C, y at ``elt`` bytes an element."""
    nc = s // q
    pairs = nc * q * (q + 1) // 2
    bsh, bshp, bsn, st = b * s * h, b * s * h * p, b * s * n, b * nc * h * p * n
    ops = lambda pair=0, mixed=0, vector=0: {"pair": pair, "mixed": mixed, "vector": vector}
    return {
        "cumsum": (4 * (bsh + h) + 8 * bsh, ops(vector=2 * bsh)),
        "chunk_cb": (elt * 2 * bsn + 4 * b * pairs, ops(pair=2 * pairs * b * n)),
        "chunk_state": (elt * (bshp + bsn) + 12 * bsh + 4 * st, ops(mixed=2 * bshp * n)),
        "state_pass": (4 * (2 * st + b * h * p * n) + 8 * b * h * nc, ops(vector=2 * st)),
        "chunk_scan": (elt * (2 * bshp + bsn) + 12 * bsh + 4 * (b * pairs + st),
                       ops(mixed=2 * pairs * b * h * p + 2 * bshp * n)),
    }


def ssd_fwd_library_ms(ops, q: int, reps: int, iters: int) -> dict[str, float | None]:
    """One PyTorch call for each of chunk_cb's and cumsum's functions on the
    chain's operands, timed as the kernels are (device_time_ms); the port
    calls neither. chunk_cb: CBᵀ per chunk over the whole Q x Q square, fp32
    ``torch.matmul`` with TF32 off ("highest" precision), bf16 ``torch.bmm(...,
    out_dtype=torch.float32)`` where this torch has that overload (None
    where not). cumsum: ``torch.cumsum`` over the chunk of the fp64 a·dt
    product, formed outside the timed window: the prefix sum only, not the
    whole function (no fp32 read, no (B, H, S) layout)."""
    import torch

    x, dt, a, bm, cm = ops
    b, s, h, _ = x.shape
    n, nc = bm.shape[-1], s // q
    cc, bb = cm.view(b * nc, q, n), bm.view(b * nc, q, n)
    if cm.dtype == torch.float32:
        tf32, prec = torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        try:
            cb = device_time_ms(lambda: torch.matmul(cc, bb.mT), reps=reps, iters=iters)
        finally:
            torch.set_float32_matmul_precision(prec)
            torch.backends.cuda.matmul.allow_tf32 = tf32
    else:
        try:
            torch.bmm(cc, bb.mT, out_dtype=torch.float32)
        except (TypeError, RuntimeError, NotImplementedError) as exc:
            log(f"[ssd] torch.bmm(..., out_dtype=torch.float32) is missing in torch "
                f"{torch.__version__} ({type(exc).__name__}): chunk_cb's bf16 library time null")
            cb = None
        else:
            cb = device_time_ms(lambda: torch.bmm(cc, bb.mT, out_dtype=torch.float32),
                                reps=reps, iters=iters)
    prod = dt.view(b, nc, q, h).double() * a.double()
    prefix = device_time_ms(lambda: torch.cumsum(prod, dim=2), reps=reps, iters=iters)
    return {"chunk_cb": cb, "cumsum_prefix": prefix}


def phase_ssd_fwd(dev) -> dict:
    """Phase 7, the forward chain at SSD_FWD_TIMED in fp32 and bf16 with the
    model's input ranges: its device time, each kernel's alone (CUDA events,
    on a copy of the filled workspaces), the plain phase version's, the
    bounds (fp32: the fp32 rate and 3xTF32; bf16: its products priced by
    class, ssd_bwd_bound_ms), each kernel's, and chunk_cb's and cumsum's
    one-call yardsticks (ssd_fwd_library_ms); y against ssd_scan_phases_ref
    (fp32 within SSD_MODEL_TOL, bf16 within bf16_excess's SSD_BWD_TOL), also
    at SSD_FWD_BF16_SHAPES in bf16."""
    import torch

    from repro_torch.kernels.ssd_scan.kernel import (
        _ssd_scan_cuda_phase,
        _ssd_scan_cuda_phases,
        ssd_scan_cuda,
    )
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_phases_ref

    gen = torch.Generator(device=dev).manual_seed(29)
    out, worst, t0 = {}, 0.0, time.perf_counter()
    cases = [(sh, dt) for sh in SSD_FWD_TIMED for dt in (torch.float32, torch.bfloat16)]
    cases += [(sh, torch.bfloat16) for sh in SSD_FWD_BF16_SHAPES]
    for shape, dtype in cases:
        b, s, h, p, n, q = shape
        ops = ssd_inputs(gen, b, s, h, p, n, dtype, dev, model_like=True)
        bf16 = dtype == torch.bfloat16
        tag = f"B={b} S={s} H={h} P={p} N={n} chunk={q} {str(dtype).removeprefix('torch.')}"
        got = _ssd_scan_cuda_phases(*ops, q)
        want = ssd_scan_phases_ref(*ops, q)
        torch.cuda.synchronize()
        err = bf16_excess(got[0], want[0]) if bf16 else rel_err(got[0], want[0])
        abs_err = float((got[0].float() - want[0].float()).abs().max())
        del want
        tol = SSD_BWD_TOL if bf16 else SSD_MODEL_TOL
        log(f"[ssd] {tag} model-range: y vs ssd_scan_phases_ref "
            + (f"{err:.3e} of the max past one bf16 ulp" if bf16 else f"max_rel_err {err:.3e}")
            + f" (max_abs {abs_err:.3e}), tol {tol:g}")
        if not err <= tol:
            fail(f"ssd_scan off ssd_scan_phases_ref at {tag}: {err:.3e}")
        if bf16:
            worst = max(worst, err)
        if shape in SSD_FWD_TIMED:
            key = SSD_FWD_TIMED[shape][0] + ("_bf16" if bf16 else "")
            reps, iters = SSD_FWD_TIMED[shape][1:]
            t_k = device_time_ms(lambda: ssd_scan_cuda(*ops, q), reps=reps, iters=iters)
            ws = tuple(t.clone() for t in got)
            phase = {ph: device_time_ms(lambda ph=ph: _ssd_scan_cuda_phase(ph, *ops, q, ws),
                                        reps=reps, iters=iters) for ph in SSD_PHASES}
            del ws
            _, events = device_profile(lambda: ssd_scan_phases_ref(*ops, q))
            t_p = sum(us for _, us, _ in events) / 1e3
            elt = dtype.itemsize
            work = ssd_fwd_work(b, s, h, p, n, q, elt)
            bound, bound_by = ssd_bwd_bound_ms(*work, elt, tc=False)
            tc_bound, tc_by = ssd_bwd_bound_ms(*work, elt, tc=True)
            pw = ssd_fwd_phase_work(b, s, h, p, n, q, elt)
            ph_bound = {ph: ssd_bwd_bound_ms(*w, elt, tc=False)[0] for ph, w in pw.items()}
            ph_tc = {ph: ssd_bwd_bound_ms(*w, elt, tc=True)[0] for ph, w in pw.items()}
            short = ("fp32", "3xTF32") if not bf16 else ("2xTF32+bf16", "TF32")
            flops = ", ".join(f"{k} {v / 1e9:.2f}" for k, v in work[1].items())
            log(f"[ssd] {tag}: device: forward chain {t_k:.4f} ms, plain phase version "
                f"{t_p:.3f} ms (profiler device sum), bound {bound:.4f} ms ({work[0] / 1e6:.1f} "
                f"MB, GFLOP {flops}; {short[0]}, {bound_by}; chain at {100 * bound / t_k:.1f}% "
                f"of it), {short[1]} bound {tc_bound:.4f} ms ({tc_by}; "
                f"{100 * tc_bound / t_k:.1f}%)")
            log(f"[ssd] {tag}: each kernel alone (CUDA events, on filled workspaces): "
                + ", ".join(f"{ph} {ms:.4f} ms (bound {ph_bound[ph]:.4f} {short[0]} / "
                            f"{ph_tc[ph]:.4f} {short[1]}; {100 * ph_tc[ph] / ms:.0f}% of it)"
                            for ph, ms in phase.items())
                + f"; sum {sum(phase.values()):.4f} ms")
            lib = ssd_fwd_library_ms(ops, q, reps, iters)
            cb_lib = "null" if lib["chunk_cb"] is None else f"{lib['chunk_cb']:.4f} ms"
            log(f"[ssd] {tag}: yardsticks: chunk_cb {phase['chunk_cb']:.4f} ms against one "
                + ("torch.matmul (fp32, TF32 off)" if not bf16 else
                   "torch.bmm(..., out_dtype=torch.float32)")
                + f" of CBᵀ per chunk {cb_lib}; cumsum {phase['cumsum']:.4f} ms against "
                f"torch.cumsum of the fp64 a·dt product (the prefix sum only) "
                f"{lib['cumsum_prefix']:.4f} ms")
            out.update({f"library_ms_chunk_cb_{key}": lib["chunk_cb"],
                        f"ref_ms_cumsum_prefix_{key}": lib["cumsum_prefix"],
                        f"ms_{key}": t_k, f"plain_ms_{key}": t_p, f"bound_ms_{key}": bound,
                        f"bound_by_{key}": bound_by, f"bound_ms_tc_{key}": tc_bound,
                        f"bound_by_tc_{key}": tc_by, f"phase_ms_{key}": phase,
                        f"phase_bound_ms_{key}": ph_bound, f"phase_bound_ms_tc_{key}": ph_tc,
                        f"max_abs_err_{key}": abs_err})
        del got, ops
        torch.cuda.empty_cache()
    out["max_excess_bf16_fwd"] = worst
    log(f"[ssd] the forward at SSD_FWD_TIMED and the bf16 shapes took "
        f"{time.perf_counter() - t0:.1f} s")
    return out


def tc_bound_ms(nbytes: int, flops: int) -> tuple[float, str]:
    """bound_ms with the fp32 products as 3xTF32 on the tensor cores: three
    TF32 products per fp32 one at the H100's dense TF32 rate, the same
    bytes."""
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, 3 * flops / H100_TF32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ssd_bwd_work(b: int, s: int, h: int, p: int, n: int, q: int,
                 elt: int = 4) -> tuple[int, dict[str, int]]:
    """Bytes and operations of one ssd_scan backward call: its inputs
    (x, dt, a, B, C, dy, dh_final and the forward's cum, CBᵀ and entering
    states) read once and dx, ddt, da, dB, dC written once, x, B, C, dy, dx,
    dB and dC at ``elt`` bytes an element (4 fp32, 2 bf16); the work the
    gradient needs — the four (P, N) products per (b, h, step) (D_c, G_c
    B_s, the state terms of dB and dC, h_inᵀ dy once per head serving dC and
    ∂cum), the causal halves of (L ⊙ CB)ᵀ dy and of dy xᵀ per head, R C and
    R B once per (b, chunk), and h_inᵀ dy against C_t — by the class of its
    operands: "pair", products of two of x, B, C, dy (dy xᵀ, its decay
    applied to the product); "mixed", products of one of them and an fp32
    intermediate (a state term's per-(step, head) scale applied to each
    head's product); "vector", fp32 elementwise work."""
    full, rem = divmod(s, q)
    pairs = full * q * (q + 1) // 2 + rem * (rem + 1) // 2
    nc = -(-s // q)
    nbytes = (elt * (3 * b * s * h * p + 4 * b * s * n)
              + 4 * (2 * b * s * h + 2 * h + b * h * p * n + b * nc * q * q + b * nc * h * p * n)
              + 8 * b * h * s)
    causal = 2 * pairs * b * h * p
    return nbytes, {"pair": causal,
                    "mixed": 8 * b * s * h * p * n + causal + 4 * pairs * b * n,
                    "vector": 2 * b * s * h * n}


def ssd_bwd_bound_ms(nbytes: int, flops: dict[str, int], elt: int,
                     tc: bool) -> tuple[float, str]:
    """The least time of ssd_bwd_work's or ssd_fwd_work's (or one kernel's)
    work, in ms, and
    whether bytes or operations set it. fp32 operands (``elt`` 4): every
    operation at the fp32 rate (bound_ms), or as 3xTF32 (``tc``,
    tc_bound_ms). bf16 operands, at fp32 accuracy: a mixed product as two
    TF32 products (a bf16 value is exact in TF32, so its small part in the
    3xTF32 split is zero) and a pair as one bf16 product at the bf16 rate
    (``tc``: as one TF32 product), both on the tensor cores, beside the
    vector work at the fp32 rate on the CUDA cores."""
    if elt == 4:
        return (tc_bound_ms if tc else bound_ms)(nbytes, sum(flops.values()))
    t_tc = (flops["pair"] / (H100_TF32_FLOPS if tc else H100_BF16_FLOPS)
            + 2 * flops["mixed"] / H100_TF32_FLOPS)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, max(t_tc, flops["vector"] / H100_FP32_FLOPS)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ssd_bwd_phase_work(b: int, s: int, h: int, p: int, n: int, q: int,
                       elt: int = 4) -> dict[str, tuple[int, dict[str, int]]]:
    """Bytes and operations (by class, as ssd_bwd_work's) of each kernel of
    the backward chain alone, each of its inputs read once and outputs
    written once (S a multiple of Q): chunk_dstate reads dy, C, x, dt, cum
    and writes D_c and R's head-group partials, forming D_c (mixed) and the
    causal half of dy xᵀ per head (pair); dstate_pass reads D_c, dh_final,
    A_c and the partials and writes G_c and R, summing the partials
    (vector); chunk_bwd reads x, dy, dt, a, B, C, cum, CBᵀ, h_in and G_c and
    writes dx, ddt, the da partials and the two scales, forming dy xᵀ
    (pair) and (L ⊙ CB)ᵀ dy on the causal half, G_c B_s and h_inᵀ C_t per
    head (mixed); chunk_dbc reads x, dy, the scales, G_c, h_in, R, B and C
    and writes the partials, forming the heads' state terms and R C, R B
    (mixed); dbc_sum reads the partials and the da partials and writes dB,
    dC, da (vector). x, B, C, dy, dx, dB and dC at ``elt`` bytes an
    element."""
    from repro_torch.kernels.ssd_scan.ref import DBC_HEAD_GROUP, DSTATE_HEAD_GROUP

    nc = s // q
    pairs = nc * q * (q + 1) // 2
    slots, groups = 1 + -(-h // DBC_HEAD_GROUP), -(-h // DSTATE_HEAD_GROUP)
    bshp, bsh, bsn, st = b * s * h * p, b * s * h, b * s * n, b * nc * h * p * n
    bshpn, causal = b * s * h * p * n, 2 * pairs * b * h * p
    ops = lambda pair=0, mixed=0, vector=0: {"pair": pair, "mixed": mixed, "vector": vector}
    return {
        "chunk_dstate": (elt * (2 * bshp + bsn) + 4 * (bsh + st + groups * b * nc * q * q)
                         + 8 * b * h * s, ops(pair=causal, mixed=2 * bshpn)),
        "dstate_pass": (4 * (2 * st + b * h * p * n + (groups + 1) * b * nc * q * q)
                        + 8 * b * h * nc, ops(vector=2 * st + (groups - 1) * b * nc * q * q)),
        "chunk_bwd": (elt * (3 * bshp + 2 * bsn) + 4 * (4 * bsh + h + b * nc * q * q + 2 * st
                                                        + b * nc * h) + 8 * b * h * s,
                      ops(pair=causal, mixed=causal + 4 * bshpn)),
        "chunk_dbc": (elt * (2 * bshp + 2 * bsn) + 4 * (2 * bsh + 2 * st + b * nc * q * q
                                                        + 2 * slots * bsn),
                      ops(mixed=4 * bshpn + 4 * pairs * b * n)),
        "dbc_sum": (elt * 2 * bsn + 4 * (2 * slots * bsn + b * nc * h + h),
                    ops(vector=2 * slots * bsn)),
    }


def ssd_bwd_inputs(gen, shape, dev, model_like: bool):
    """A padded backward problem as SsdScanFn sees it: the operands padded
    to a chunk multiple with dt = 0 steps (as the wrapper pads), an
    upstream dy that is zero on the padded steps and a nonzero dh_final."""
    import torch
    import torch.nn.functional as F

    b, s, h, p, n, q = shape
    x, dt, a, bm, cm = ssd_inputs(gen, b, s, h, p, n, torch.float32, dev, model_like)
    dy = torch.randn((b, s, h, p), generator=gen, device=dev)
    dhf = torch.randn((b, h, p, n), generator=gen, device=dev)
    pad = (-s) % q
    ops = (F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)), a,
           F.pad(bm, (0, 0, 0, pad)), F.pad(cm, (0, 0, 0, pad)))
    return ops, F.pad(dy, (0, 0, 0, 0, 0, pad)), dhf


def bf16_excess(got, want) -> float:
    """A bf16 gradient against its plain version: the largest amount by
    which an element's |got - want| passes one bf16 ulp (of the larger of
    the two), over want's largest |value|. At most SSD_BWD_TOL passes: the
    two sum in other fp32 orders, then each rounds once to bf16, which may
    fall either side. inf on a NaN."""
    import torch

    got, want = got.double(), want.double()
    big = torch.maximum(got.abs(), want.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    err = float(((got - want).abs() - ulp).max() / want.abs().max().clamp_min(1e-30))
    return err if err == err else math.inf


def grad_err(got, want) -> float:
    """A gradient against its plain version: rel_err_max for an fp32 one,
    bf16_excess for a bf16 one; either passes at most SSD_BWD_TOL."""
    import torch

    return (bf16_excess if got.dtype == torch.bfloat16 else rel_err_max)(got, want)


def phase_ssd_bwd(dev) -> dict:
    """Phase 19 (a): the backward chain against ssd_scan_bwd_phases_ref (on
    the chain's own forward workspaces; every workspace too) and against
    autograd through the sequential ssd_scan_ref, at every SSD_BWD_SHAPES
    shape; bitwise-repeatable launches; the wrapper's autograd path
    (SsdScanFn) bitwise the direct calls; then device times at
    SSD_BWD_TIMED beside the forward chain, the plain version and both
    bounds, and each kernel's time alone (CUDA events) beside its own.
    Each shape again with bf16 x, B, C and dy (the bf16 chain): against the
    plain version on the same bf16 operands (bf16_excess for dx, dB, dC),
    bitwise repeatable, SsdScanFn bitwise the direct calls, timed as
    above at SSD_BWD_TIMED."""
    import torch

    from repro_torch.kernels.ssd_scan.kernel import _ssd_scan_bwd_cuda_phases, _ssd_scan_cuda_phases
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_phases_ref, ssd_scan_ref

    names = SSD_BWD_OUTPUTS[:5]
    gen = torch.Generator(device=dev).manual_seed(19)
    worst = {"plain": 0.0, "autograd": 0.0, "plain_bf16": 0.0}
    out = {}
    t0 = time.perf_counter()
    bf16_s = 0.0
    for shape in list(SSD_BWD_SHAPES) + list(SSD_BWD_TIMED):
        b, s, h, p, n, q = shape
        timed = shape in SSD_BWD_TIMED
        ops32, dy32, dhf = ssd_bwd_inputs(gen, shape, dev, model_like=shape != SSD_BWD_SHAPES[0])
        for dtype in (torch.float32, torch.bfloat16):
            t_arm = time.perf_counter()
            # bf16: x, B, C and dy as a bf16 model's layer gives them.
            ops = tuple(t.to(dtype) if i in (0, 3, 4) else t for i, t in enumerate(ops32))
            dy = dy32.to(dtype)
            tag = f"B={b} S={s} H={h} P={p} N={n} chunk={q} {str(dtype).removeprefix('torch.')}"
            _, _, cum, g, h_in = _ssd_scan_cuda_phases(*ops, q)
            got = _ssd_scan_bwd_cuda_phases(*ops, dy, dhf, cum, g, h_in, q)
            again = _ssd_scan_bwd_cuda_phases(*ops, dy, dhf, cum, g, h_in, q)
            torch.cuda.synchronize()
            tri = torch.ones(q, q, dtype=torch.bool, device=dev).tril()
            # R and its partials above the diagonal: unspecified.
            valid = lambda nm, u: u[..., tri] if nm in ("R", "R_part") else u
            if not all(torch.equal(valid(nm, u), valid(nm, v))
                       for nm, u, v in zip(SSD_BWD_OUTPUTS, got, again)):
                fail(f"ssd_scan backward launches differ bitwise at {tag}")
            if [u.dtype for u in got[:5]] != [dtype, torch.float32, torch.float32, dtype, dtype]:
                fail(f"ssd_scan backward at {tag}: gradient dtypes {[u.dtype for u in got[:5]]}")
            del again
            if timed:
                out[SSD_BWD_TIMED[shape][0] + ("" if dtype == torch.float32 else "_bf16")] = \
                    time_ssd_bwd(shape, ops, dy, dhf, cum, g, h_in, got, tag)
            else:
                want = ssd_scan_bwd_phases_ref(*ops, dy, dhf, cum, g, h_in, q)
                errs = {nm: grad_err(u[:, :s] if u.dim() > 1 else u, v[:, :s] if v.dim() > 1 else v)
                        for nm, u, v in zip(names, got[:5], want[:5])}
                errs.update({nm: rel_err_max(valid(nm, u), valid(nm, v))
                             for nm, u, v in zip(SSD_BWD_OUTPUTS[5:], got[5:], want[5:])})
                leaves = [t[:, :s].clone().requires_grad_() if t.dim() > 1
                          else t.clone().requires_grad_() for t in ops]
                auto = {}
                if dtype == torch.float32:
                    # Autograd through the sequential recurrence, unpadded.
                    y_r, h_r = ssd_scan_ref(*leaves)
                    torch.autograd.backward([y_r, h_r], [dy[:, :s], dhf])
                    auto = {nm: rel_err_max(u[:, :s] if u.dim() > 1 else u, t.grad)
                            for nm, u, t in zip(names, got[:5], leaves)}
                    del y_r, h_r
                # The wrapper under autograd: SsdScanFn with the same launches.
                wl = [t.detach().clone().requires_grad_() for t in leaves]
                y_w, h_w = ssd_scan(*wl, chunk=q)
                torch.autograd.backward([y_w, h_w], [dy[:, :s], dhf])
                torch.cuda.synchronize()
                same = all(torch.equal(u[:, :s] if u.dim() > 1 else u, t.grad)
                           for u, t in zip(got[:5], wl))
                log(f"[train] ssd_scan backward {tag}: max err of the max vs "
                    "ssd_scan_bwd_phases_ref " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
                    + (" (bf16 gradients: past one bf16 ulp)" if dtype == torch.bfloat16 else "")
                    + ("; vs autograd through ssd_scan_ref "
                       + ", ".join(f"{k} {v:.2e}" for k, v in auto.items()) if auto else "")
                    + f" (tol {SSD_BWD_TOL:g}); bitwise repeatable; the wrapper's SsdScanFn "
                    f"bitwise the direct calls: {same}")
                if (max(errs.values()) > SSD_BWD_TOL or max(auto.values(), default=0.0)
                        > SSD_BWD_TOL or not same):
                    fail(f"ssd_scan backward at {tag}: plain {errs}, autograd {auto}, "
                         f"wrapper same {same}")
                key = "plain" if dtype == torch.float32 else "plain_bf16"
                worst[key] = max(worst[key], *errs.values())
                if auto:
                    worst["autograd"] = max(worst["autograd"], *auto.values())
                del want, leaves, wl, y_w, h_w
            del got, ops, dy, cum, g, h_in
            torch.cuda.empty_cache()
            if dtype == torch.bfloat16:
                bf16_s += time.perf_counter() - t_arm
        del ops32, dy32, dhf
    out["max_rel_err_plain"], out["max_rel_err_autograd"] = worst["plain"], worst["autograd"]
    out["max_excess_plain_bf16"] = worst["plain_bf16"]
    out["seconds"], out["bf16_seconds"] = time.perf_counter() - t0, bf16_s
    log(f"[train] phase 19 (a) took {out['seconds']:.1f} s, its bf16 arms {bf16_s:.1f} s")
    return out


def time_ssd_bwd(shape, ops, dy, dhf, cum, g, h_in, got, tag) -> dict:
    """Phase 19 (a) at an SSD_BWD_TIMED shape: the chain's device time, the
    forward chain's, the plain phase version's, each kernel alone on a copy
    of the filled workspaces, the bounds at the operands' element size; the
    gradients ``got`` against the plain version."""
    import torch

    from repro_torch.kernels.ssd_scan.kernel import (
        _ssd_scan_bwd_cuda_phase,
        ssd_scan_bwd_cuda,
        ssd_scan_cuda,
    )
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_phases_ref

    b, s, h, p, n, q = shape
    elt = ops[0].element_size()
    reps, iters = SSD_BWD_TIMED[shape][1:]
    t_b = device_time_ms(lambda: ssd_scan_bwd_cuda(*ops, dy, dhf, cum, g, h_in, q),
                         reps=reps, iters=iters)
    t_f = device_time_ms(lambda: ssd_scan_cuda(*ops, q), reps=reps, iters=iters)
    # Each kernel alone on a copy of the filled workspaces (the phase
    # launches overwrite them; ``got`` is compared below).
    ws = tuple(t.clone() for t in got)
    phase = {ph: device_time_ms(
        lambda ph=ph: _ssd_scan_bwd_cuda_phase(ph, *ops, dy, dhf, cum, g, h_in, q, ws),
        reps=reps, iters=iters) for ph in SSD_BWD_PHASES}
    del ws
    _, events = device_profile(lambda: ssd_scan_bwd_phases_ref(*ops, dy, dhf, cum, g, h_in, q))
    t_p = sum(us for _, us, _ in events) / 1e3
    work = ssd_bwd_work(b, s, h, p, n, q, elt)
    bound, bound_by = ssd_bwd_bound_ms(*work, elt, tc=False)
    tc_bound, tc_by = ssd_bwd_bound_ms(*work, elt, tc=True)
    phase_work = ssd_bwd_phase_work(b, s, h, p, n, q, elt)
    phase_bound = {ph: ssd_bwd_bound_ms(*w, elt, tc=False)[0] for ph, w in phase_work.items()}
    phase_tc_bound = {ph: ssd_bwd_bound_ms(*w, elt, tc=True)[0] for ph, w in phase_work.items()}
    want = ssd_scan_bwd_phases_ref(*ops, dy, dhf, cum, g, h_in, q)
    err = max(grad_err(u, v) for u, v in zip(got[:5], want[:5]))
    abs_err = max(float((u.float() - v.float()).abs().max()) for u, v in zip(got[:5], want[:5]))
    # What each bound prices (ssd_bwd_bound_ms): fp32 operands at the fp32
    # rate / as 3xTF32; bf16 ones with their pairs at the bf16 rate / as one
    # TF32 product, mixed products as two TF32 products either way.
    rates = ("fp32 rate", "3xTF32") if elt == 4 else ("mixed 2xTF32 + pairs bf16", "TF32 only")
    short = ("fp32", "3xTF32") if elt == 4 else ("2xTF32+bf16", "TF32")
    flops = ", ".join(f"{k} {v / 1e9:.2f}" for k, v in work[1].items())
    log(f"[train] ssd_scan backward {tag}: device: backward chain {t_b:.3f} ms, forward "
        f"chain {t_f:.3f} ms, plain phase version {t_p:.3f} ms (profiler device sum), "
        f"bound {bound:.3f} ms ({work[0] / 1e6:.1f} MB, GFLOP {flops}; {rates[0]}, {bound_by}; "
        f"chain at {100 * bound / t_b:.1f}% of it), {rates[1]} bound {tc_bound:.3f} ms "
        f"({tc_by}; {100 * tc_bound / t_b:.1f}%); vs plain max err {err:.3e} of the max"
        + (" past one bf16 ulp" if ops[0].dtype == torch.bfloat16 else ""))
    log(f"[train] ssd_scan backward {tag}: each kernel alone (CUDA events, on filled "
        "workspaces): " + ", ".join(
            f"{ph} {ms:.4f} ms (bound {phase_bound[ph]:.4f} {short[0]} / "
            f"{phase_tc_bound[ph]:.4f} {short[1]})" for ph, ms in phase.items())
        + f"; sum {sum(phase.values()):.4f} ms")
    if err > SSD_BWD_TOL:
        fail(f"ssd_scan backward off its plain version at {tag}: {err:.3e}")
    return {"ms": t_b, "fwd_ms": t_f, "plain_ms": t_p, "bound_ms": bound,
            "bound_by": bound_by, "bound_ms_tc": tc_bound, "bound_by_tc": tc_by,
            "phase_ms": phase, "phase_bound_ms": phase_bound,
            "phase_bound_ms_tc": phase_tc_bound, "max_abs_err": abs_err,
            "max_rel_err": err, "bytes": work[0]}


def train_step_record(arch: str, variant: str, dev, batch, layers=None, dtype=None,
                      timed: int = TRAIN_TIMED_STEPS) -> dict:
    """Phase 19 (b) / (c): ``arch`` at ``variant`` (``layers``: a depth cut,
    None for full depth) with random weights of ``dtype`` (None: fp32; the
    draws are fp32's, rounded) from a seeded generator, trained through
    make_train_step on TRAIN_BATCH-shaped steps from the
    synthetic token stream: one warm-up step, then ``timed`` steps (the
    schedule set for TRAIN_TIMED_STEPS), the launch counters set to 0
    before each step and read after it.
    Records the walls, tokens/s, peak memory, one profiled step's busy share
    and its kernels by name, the optimizer alone; for an SSM model the
    warm-up step's layer-0 backward call (its real operands and upstream
    gradient) is kept for the caller's gate."""
    import dataclasses

    import torch

    import repro_torch.kernels.ssd_scan.ops as ssd_ops
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import token_batch
    from repro_torch.models.lm import count_params, init_params
    from repro_torch.traces.tokens import SyntheticTokenStream, TokenPipelineConfig, lm_inputs
    from repro_torch.train import AdamWConfig, TrainStepConfig, adamw_init, adamw_update
    from repro_torch.train import make_train_step
    from repro_torch.train.optimizer import tree_map

    cfg = get_arch(arch, variant)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    b, s = batch
    steps = 1 + timed
    ocfg = AdamWConfig(lr=3e-3, total_steps=1 + TRAIN_TIMED_STEPS,
                       warmup_steps=min(20, (1 + TRAIN_TIMED_STEPS) // 5))
    tcfg = TrainStepConfig(microbatches=TRAIN_MICROBATCHES, remat=TRAIN_REMAT, optimizer=ocfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dtype = dtype or torch.float32
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dtype, dev)
    opt = adamw_init(params)
    step, init_efb = make_train_step(cfg, tcfg, device=dev)
    efb = init_efb(params)
    pipe = SyntheticTokenStream(TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=s + 1,
                                                    global_batch=b, seed=0))
    batches = [token_batch(lm_inputs(pipe.batch(i)), dev) for i in range(steps + 1)]
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    rec = {"params": count_params(cfg), "layers": cfg.num_layers, "setup_s": setup,
           "walls": [], "counts": [], "losses": [], "grad_norms": []}
    kept = {}
    real_bwd = ssd_ops.ssd_scan_bwd_cuda

    def keep_layer0(*args):
        # Backward runs the layers last to first: call L is microbatch 1's
        # layer 0.
        kept["calls"] = kept.get("calls", 0) + 1
        if kept["calls"] == cfg.num_layers:
            kept["args"] = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
        return real_bwd(*args)

    for i in range(steps):
        if i == 0 and cfg.has_ssm:
            ssd_ops.ssd_scan_bwd_cuda = keep_layer0
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        try:
            params, opt, met, efb = step(params, opt, batches[i], efb)
            torch.cuda.synchronize()
        finally:
            ssd_ops.ssd_scan_bwd_cuda = real_bwd
        wall = time.perf_counter() - t0
        counts = read_counts()
        rec["counts"].append(counts)
        rec["losses"].append(float(met["loss"]))
        rec["grad_norms"].append(float(met["grad_norm"]))
        if i:
            rec["walls"].append(wall)
        else:
            rec["warmup_s"] = wall
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rec["wall_s"] = statistics.median(rec["walls"])
    rec["tokens_per_s"] = b * s / rec["wall_s"]
    wall, events = device_profile(lambda: step(params, opt, batches[steps], efb))
    dev_us = sum(us for _, us, _ in events)
    chain = lambda pred: sum(us for k, us, _ in events if pred(k)) / dev_us if dev_us else None
    rec.update(profiled_wall_s=wall, device_busy_ms=dev_us / 1e3,
               busy_share=dev_us / 1e6 / wall if dev_us else None,
               fwd_share=chain(is_ssd_kernel), bwd_share=chain(lambda k: "ssd_bwd_" in k),
               top=[(k[:48], us / 1e3, c) for k, us, c in events[:6]])
    # The backward chain's kernels in the step, mean device ms per launch.
    rec["bwd_phase_ms"] = {}
    for ph in SSD_BWD_PHASES:
        hits = [(us, c) for k, us, c in events if f"ssd_bwd_{ph}_kernel" in k]
        count = sum(c for _, c in hits)
        rec["bwd_phase_ms"][ph] = sum(us for us, _ in hits) / count / 1e3 if count else None
    # The optimizer alone, on zero gradients (in place, as in the step).
    opt_walls = []
    for _ in range(3):
        grads = tree_map(torch.zeros_like, params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        adamw_update(ocfg, params, grads, opt)
        torch.cuda.synchronize()
        opt_walls.append(time.perf_counter() - t0)
        del grads
    rec["optimizer_s"] = statistics.median(opt_walls)
    rec["layer0"] = kept.get("args")
    del params, opt, efb, batches
    torch.cuda.empty_cache()
    return rec


def attention_train_ms(cfg, b: int, s: int, dev) -> tuple[float, float]:
    """Device time (CUDA events) of one layer's blockwise attention at a
    training microbatch's shape: (forward alone, forward + backward)."""
    import torch

    from repro_torch.models.attention import attend_blockwise

    gen = torch.Generator(device=dev).manual_seed(11)
    q, k, v, pos = attention_inputs(gen, b, s, cfg.num_heads, cfg.num_kv_heads,
                                    cfg.resolved_head_dim, dev)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    dout = torch.randn(q.shape, generator=gen, device=dev)

    def timed(fn, iters=3):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    fwd = lambda: attend_blockwise(q, k, v, pos, pos, causal=cfg.causal, window=cfg.sliding_window)
    t_f = timed(lambda: fwd().detach())
    t_fb = timed(lambda: torch.autograd.grad(fwd(), (q, k, v), dout))
    return t_f, t_fb


def train_arm(arch: str, variant: str, dev, batch, dtype, smi, fp32_rec=None) -> dict:
    """Phase 19 (b) / (c), one arm: train_step_record at ``dtype`` and its
    gates: the launch counts of every step, finite losses and grad norms,
    for mamba2-2.7b layer 0's real backward call against the plain version,
    for qwen2-0.5b (fp32) attention's share of the step. A bf16 arm's step-1
    loss within TRAIN_BF16_LOSS_RTOL of ``fp32_rec``'s (the same draws,
    rounded). An fp32 arm takes TRAIN_TIMED_STEPS_FP32 timed steps."""
    import torch

    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_bwd_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref

    name = str(dtype).removeprefix("torch.")
    rec = train_step_record(arch, variant, dev, batch, dtype=dtype,
                            timed=TRAIN_TIMED_STEPS_FP32 if dtype == torch.float32
                            else TRAIN_TIMED_STEPS)
    L = rec["layers"]
    want = ({"ssd_scan": 2 * TRAIN_MICROBATCHES * L, "ssd_scan_bwd": TRAIN_MICROBATCHES * L}
            if arch == MAMBA_ARCH else {"ssd_scan": 0, "ssd_scan_bwd": 0})
    want["gmsa_score"] = 0
    log(f"[train] {smi} | {arch} ({variant}, {rec['params']:,} params, {L} layers, random "
        f"{name} weights), {batch[0]} x {batch[1]} tokens per step, {TRAIN_MICROBATCHES} "
        f"microbatches, remat {TRAIN_REMAT}: set-up {rec['setup_s']:.1f} s, warm-up step "
        f"{rec['warmup_s']:.2f} s; timed steps {', '.join(f'{w:.3f}' for w in rec['walls'])} s, "
        f"median {rec['wall_s']:.3f} s, {rec['tokens_per_s']:.0f} tokens/s; launches per "
        f"step {rec['counts']}; loss {[round(x, 4) for x in rec['losses']]}, grad norm "
        f"{[round(x, 4) for x in rec['grad_norms']]}; peak device memory "
        f"{rec['peak_gib']:.2f} GiB")
    busy = ("not measured" if rec["busy_share"] is None else
            f"{rec['device_busy_ms']:.1f} ms of {rec['profiled_wall_s'] * 1e3:.1f} ms "
            f"({100 * rec['busy_share']:.1f}%)")
    log(f"[train] {arch} {name}: one profiled step: device busy {busy}; ssd_scan forward "
        f"chains {100 * (rec['fwd_share'] or 0):.1f}% and backward chains "
        f"{100 * (rec['bwd_share'] or 0):.1f}% of step device time (backward kernels, mean "
        f"per launch: " + ", ".join(f"{ph} " + ("none" if ms is None else f"{ms:.4f} ms")
                                    for ph, ms in rec["bwd_phase_ms"].items())
        + f"); the optimizer alone "
        f"{rec['optimizer_s'] * 1e3:.1f} ms; top kernels: "
        + ", ".join(f"{k} {ms:.1f} ms x{c}" for k, ms, c in rec["top"]))
    if any(c != want for c in rec["counts"]):
        fail(f"train {arch} {name}: launches per step {rec['counts']}, expected {want}")
    if not all(math.isfinite(x) for x in rec["losses"]) or not all(
            math.isfinite(g) and g > 0 for g in rec["grad_norms"]):
        fail(f"train {arch} {name}: loss {rec['losses']}, grad norm {rec['grad_norms']}")
    if fp32_rec is not None:
        gap = abs(rec["losses"][0] - fp32_rec["losses"][0]) / abs(fp32_rec["losses"][0])
        rec["step1_loss_rel_gap"] = gap
        log(f"[train] {arch} {name}: step-1 loss {rec['losses'][0]:.5f} against fp32's "
            f"{fp32_rec['losses'][0]:.5f} from the same draws: {gap:.3e} relative (tol "
            f"{TRAIN_BF16_LOSS_RTOL:g})")
        if gap > TRAIN_BF16_LOSS_RTOL:
            fail(f"train {arch} {name}: step-1 loss {rec['losses'][0]} against fp32's "
                 f"{fp32_rec['losses'][0]}")
    if arch == MAMBA_ARCH:
        args = rec.pop("layer0")
        got = ssd_scan_bwd_cuda(*args)
        ref = ssd_scan_bwd_ref(*args)
        torch.cuda.synchronize()
        errs = {nm: grad_err(u, v) for nm, u, v in zip(("dx", "ddt", "da", "dB", "dC"), got, ref)}
        rec["layer0_err"] = max(errs.values())
        rec["layer0_abs_err"] = max(float((u.float() - v.float()).abs().max())
                                    for u, v in zip(got, ref))
        log(f"[train] {arch} {name}: layer 0's real SSD operands and upstream gradient "
            f"(x {tuple(args[0].shape)} {args[0].dtype}): backward chain vs ssd_scan_bwd_ref, "
            "max err of the max " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
            + (" (bf16 gradients: past one bf16 ulp)" if dtype == torch.bfloat16 else "")
            + f" (tol {SSD_BWD_TOL:g})")
        if rec["layer0_err"] > SSD_BWD_TOL:
            fail(f"train {arch} {name}: layer 0's backward off the plain version: {errs}")
        del args, got, ref
    else:
        rec.pop("layer0")
    if arch != MAMBA_ARCH and dtype == torch.float32:
        from repro_torch.configs import get_arch

        cfg = get_arch(arch, variant)
        t_f, t_fb = attention_train_ms(cfg, batch[0] // TRAIN_MICROBATCHES, batch[1], dev)
        per_step = TRAIN_MICROBATCHES * cfg.num_layers * (t_f + t_fb)
        rec["attn_share"] = per_step / rec["device_busy_ms"] if rec["device_busy_ms"] else None
        log(f"[train] {arch}: blockwise attention per layer and microbatch: forward "
            f"{t_f:.3f} ms, forward + backward {t_fb:.3f} ms; x {TRAIN_MICROBATCHES} x "
            f"{cfg.num_layers} layers (forward, then remat's recompute and the backward) = "
            f"{per_step:.1f} ms of the profiled step's {rec['device_busy_ms']:.1f} ms device "
            f"time ({100 * (rec['attn_share'] or 0):.1f}%)")
    return rec


def phase_train(dev, smi, variant: str = "full", batch=TRAIN_BATCH, smoke_steps=None,
                device_args=(), example_steps=None) -> dict:
    """Phase 19 (b)-(d); (a) is phase_ssd_bwd. ``variant="smoke"`` with a
    small ``batch``, ``device_args=("--device", "cpu")`` and small step
    counts rehearse it on the CPU."""
    import shutil
    import tempfile

    import torch

    import repro_torch.launch.train as launch_train

    out = {}
    # (b) mamba2-2.7b, (c) qwen2-0.5b, each in fp32, then in bf16.
    for arch in TRAIN_ARCHS:
        for dtype in (torch.float32, torch.bfloat16):
            t_arm = time.perf_counter()
            out[arch if dtype == torch.float32 else f"{arch} bf16"] = rec = train_arm(
                arch, variant, dev, batch, dtype, smi, out.get(arch))
            rec["seconds"] = time.perf_counter() - t_arm
            log(f"[train] {arch} {str(dtype).removeprefix('torch.')}: the arm took "
                f"{rec['seconds']:.1f} s")
            torch.cuda.empty_cache()

    # (d) the entry points as subprocesses, at once.
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    ckpt = ROOT / "build" / "ckpt_smoke"
    shutil.rmtree(ckpt, ignore_errors=True)
    smoke = list(TRAIN_SMOKE_ARGS)
    if smoke_steps:
        smoke[smoke.index("--steps") + 1] = str(smoke_steps)
    cmds = {
        "examples.train_lm": ["-m", "repro_torch.examples.train_lm", *device_args]
        + (["--steps", str(example_steps)] if example_steps else []),
        "launch.train": ["-m", "repro_torch.launch.train", *smoke, "--ckpt-dir", str(ckpt),
                         "--fail-at", str(TRAIN_SMOKE_FAIL_AT), *device_args],
    }
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        t0 = time.perf_counter()
        try:
            for name, cmd in cmds.items():
                with open(Path(tmp) / f"{name}.log", "w") as sink:
                    procs[name] = subprocess.Popen([sys.executable, *cmd], stdout=sink,
                                                   stderr=subprocess.STDOUT, cwd=ROOT, env=env)
            for name, proc in procs.items():
                rc = proc.wait(timeout=600)
                text = (Path(tmp) / f"{name}.log").read_text()
                log(f"[train] python -m repro_torch.{name}: exit {rc}, done "
                    f"{time.perf_counter() - t0:.1f} s after both started")
                for line in text.splitlines()[-8:]:
                    log(f"[train] {name} | {line}")
                if rc != 0:
                    fail(f"train: {name} exited {rc} (its claim, or an error)")
                if "restarts=1" not in text:
                    fail(f"train: {name} did not restart once from its checkpoint")
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    out["entry_s"] = time.perf_counter() - t0
    shutil.rmtree(ckpt, ignore_errors=True)

    # The same smoke run in process, with and without the failure.
    finals = {}
    for tag, extra in (("clean", []), ("failed", ["--fail-at", str(TRAIN_SMOKE_FAIL_AT)])):
        d = ROOT / "build" / f"ckpt_smoke_{tag}"
        shutil.rmtree(d, ignore_errors=True)
        state, _ = launch_train.run([*smoke, "--ckpt-dir", str(d), "--log-every", "1000",
                                     *extra, *device_args])
        finals[tag] = state["params"]
        shutil.rmtree(d, ignore_errors=True)
    from repro_torch.train.optimizer import leaves

    diffs = {}
    for name, a, b in zip(_leaf_names(finals["clean"]), leaves(finals["clean"]),
                          leaves(finals["failed"])):
        if not torch.equal(a, b):
            diffs[name] = (float((a - b).abs().max()), float(b.abs().max()))
    worst = max((d / max(m, 1e-30) for d, m in diffs.values()), default=0.0)
    out["replay_bitwise"], out["replay_rel_diff"] = not diffs, worst
    log(f"[train] in process: the smoke run through the failure at {TRAIN_SMOKE_FAIL_AT} "
        f"and the uninterrupted run: final params bitwise equal: {not diffs}"
        + ("" if not diffs else
           f"; differing leaves (largest |diff|, largest |value|): {diffs}; the tied "
           f"embedding's backward (index_put with accumulation) sums in a run-dependent order "
           f"on CUDA; worst {worst:.3e} relative (tol {TRAIN_REPLAY_RTOL:g})"))
    if worst > TRAIN_REPLAY_RTOL:
        fail(f"train: the restarted run's params differ by {worst:.3e} relative: {diffs}")
    return out


def _leaf_names(tree, prefix="") -> list[str]:
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k], f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def rel_err_max(got, want) -> float:
    """max |got - want| / max |want|, in fp32 (a gradient's error relative to
    its largest value); inf where either holds a NaN, so that no gate
    passes on one."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))
    return err if err == err else math.inf


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
        before, gemm_before = kernel_counters()["ssd_scan"].launches, gemm_counters()
        t0 = time.perf_counter()
        logits, cache = prefill_fn(params, tokens[i][:, :s])
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        per_prefill = kernel_counters()["ssd_scan"].launches - before
        gemm_per_prefill = gemm_since(gemm_before)
        finite = torch.isfinite(logits).all()
        tok = torch.argmax(logits[:, -1:, :vocab], dim=-1)
        t0 = time.perf_counter()
        for _ in range(gen_len):
            logits, cache = decode_fn(params, cache, tok)
            finite = finite & torch.isfinite(logits).all()
            tok = torch.argmax(logits[:, :, :vocab], dim=-1)
        torch.cuda.synchronize()
        return (per_prefill, bool(finite), t_pre, (time.perf_counter() - t0) / gen_len,
                gemm_per_prefill)

    # The main path: both batches, every counter read around them.
    torch.cuda.synchronize()
    reset_counts()
    runs = [serve(i) for i in range(len(batches))]
    torch.cuda.synchronize()
    counts = read_counts()
    for (b, s, g), (per_prefill, finite, t_pre, t_dec, gemm_pre) in zip(batches, runs):
        log(f"[mamba2] served {b} x {s}-token prompts + {g} greedy tokens: "
            f"{per_prefill} ssd_scan launches in the prefill, gemm_f32 {gemm_pre}, "
            f"logits finite {finite}; "
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
    return counts["ssd_scan"], pre


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
                batches=DENSE_BATCHES) -> tuple[int, dict]:
    """Phase 15. Returns (the serving run's gmsa_score launches, each
    model's steady prefill walls in seconds at ``batches[0]``)."""
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
    prefill_s = {}
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
            gemm_before = gemm_counters()
            t0 = time.perf_counter()
            logits, cache = prefill_fn(params, tokens[i][:, :s])
            torch.cuda.synchronize()
            t_pre = time.perf_counter() - t0
            gemm_pre = gemm_since(gemm_before)
            nan = torch.isnan(logits).any()
            tok = torch.argmax(logits[:, -1:, :vocab], dim=-1)
            t0 = time.perf_counter()
            for _ in range(gen_len):
                logits, cache = decode_fn(params, cache, tok)
                nan = nan | torch.isnan(logits).any()
                tok = torch.argmax(logits[:, :, :vocab], dim=-1)
            torch.cuda.synchronize()
            return not bool(nan), t_pre, (time.perf_counter() - t0) / gen_len, gemm_pre

        torch.cuda.synchronize()
        reset_counts()
        runs = [serve(i) for i in range(len(batches))]
        torch.cuda.synchronize()
        counts = read_counts()
        for (b, s, g), (clean, t_pre, t_dec, gemm_pre) in zip(batches, runs):
            log(f"[dense] {arch} served {b} x {s}-token prompts + {g} greedy tokens: no NaN "
                f"logit {clean}; prefill {t_pre * 1e3:.1f} ms (gemm_f32 {gemm_pre}), decode "
                f"{t_dec * 1e3:.2f} ms/token (first call)")
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
        prefill_s[arch] = [w[1] for w in walls]
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
    return x_counts["gmsa_score"], prefill_s


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
        gemm_before = gemm_counters()
        t0 = time.perf_counter()
        logits, cache = prefill_fn(params, tokens[:, :s])
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        gemm_pre = gemm_since(gemm_before)
        finite = torch.isfinite(logits).all()
        tok = torch.argmax(logits[:, -1:, :vocab], dim=-1)
        t0 = time.perf_counter()
        for _ in range(gen_len):
            logits, cache = decode_fn(params, cache, tok)
            finite = finite & torch.isfinite(logits).all()
            tok = torch.argmax(logits[:, :, :vocab], dim=-1)
        torch.cuda.synchronize()
        pos = cache["pos"].tolist()
        return bool(finite), pos, t_pre, (time.perf_counter() - t0) / gen_len, gemm_pre

    torch.cuda.synchronize()
    reset_counts()
    finite, pos, t_pre, t_dec, gemm_pre = serve()
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"[moe] {arch} served {b} x {s}-token prompts + {gen_len} greedy tokens: logits finite "
        f"{finite}, pos {sorted(set(pos))}; prefill {t_pre * 1e3:.1f} ms (gemm_f32 {gemm_pre}), "
        f"decode {t_dec * 1e3:.2f} ms/token (first call); main path launches {counts}")
    want_ssd = cfg.num_layers if cfg.has_ssm else 0
    if not (finite and pos == [s + gen_len] * b):
        fail(f"moe_hybrid: {arch}: finite {finite}, pos {pos}")
    if counts != {"gmsa_score": 0, "ssd_scan": want_ssd, "ssd_scan_bwd": 0}:
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

    from repro_torch.configs import get_arch
    from repro_torch.models.lm import count_params, init_params

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
    for archs in MOE_HYBRID_SERVE:
        key = "serve_moe" if any(get_arch(a, variant).is_moe for a in archs) else "serve_hybrid"
        out[key] = serve_execution(archs, variant, dev, smi, "moe")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def serve_execution(archs, variant: str, dev, smi, phase: str) -> dict:
    """``FleetEngine`` on phase 14's N = 4, T = 6 execution run with one
    class per arch (``variant`` width, random fp32 weights), dispatch
    through ``gmsa_score``, executing the drained jobs: one ``gmsa_score``
    launch per slot, ``ssd_scan`` once per SSM layer per executed batch,
    exact ``exec_jobs``, finite logits, tokens in vocabulary, conservation.
    Returns the counts, seconds per job and ``exec_jobs``."""
    import torch

    from repro_torch.benchmarks import serve_bench
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve_traces
    from repro_torch.serve import FleetConfig as ServeFleetConfig
    from repro_torch.serve import FleetEngine, RequestClass

    x = SERVE_EXEC
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
        fail(f"{phase}: serving {list(archs)}: {exc}")
    n_jobs = sum(sum(w) for w in want.values())
    per_job = xout["exec_seconds"] / max(xout["exec_jobs"], 1)
    log(f"[{phase}] {smi} | FleetEngine with classes {list(archs)} ({variant} width, random "
        f"fp32 weights, built in {t_init:.2f} s), N={x['pods']}, T={x['slots']}, "
        f"dispatch='kernel': jobs per slot {want}, exec_jobs {xout['exec_jobs']}, prefill "
        f"batches {ok['batches']}; launches {x_counts}; logits finite {bool(ok['finite'])}, "
        f"tokens in vocabulary {bool(ok['vocab'])}; conservation max_rel {conserve:.3e}; run "
        f"wall {x_wall:.2f} s, {x_wall / x['slots']:.3f} s per slot, execution "
        f"{xout['exec_seconds']:.2f} s = {per_job:.3f} s per job; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not (xout["exec_jobs"] == n_jobs > 0 and ok["batches"] == batches_run
            and x_counts == {"gmsa_score": x["slots"], "ssd_scan": want_ssd, "ssd_scan_bwd": 0}
            and xout["exec_seconds"] > 0.0
            and bool(ok["finite"]) and bool(ok["vocab"])):
        fail(f"{phase}: serving execution gates for {list(archs)}: exec_jobs "
             f"{xout['exec_jobs']} (want {n_jobs}), launches {x_counts} (want "
             f"{x['slots']} gmsa_score, {want_ssd} ssd_scan)")
    del xeng
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"counts": x_counts, "per_job_s": per_job, "exec_jobs": xout["exec_jobs"]}


def phase_frontends(dev, smi, variant: str = "full", hubert_batch=None,
                    internvl_batch=None) -> dict:
    """Phase 17: hubert-xlarge at full width and depth and internvl2-76b at
    its published widths (8 of 80 layers), each on its frontend's stub
    batch from ``make_batch``; both smoke models on the card against the
    CPU; then ``FleetEngine`` executing with a full-width hubert-xlarge
    class beside qwen2-0.5b. ``variant="smoke"`` (with small batches)
    rehearses it on the CPU."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import SHAPES, ShapeConfig, get_arch, shape_applicable
    from repro_torch.models.attention import attend_blockwise
    from repro_torch.models.frontends import frontend_spec
    from repro_torch.models.inputs import make_batch
    from repro_torch.models.lm import (
        count_params,
        decode_step,
        forward,
        init_params,
        padded_vocab,
        prefill_step,
    )

    out = {}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    def prefill_profile(arch, cfg, fn, b, s, rec):
        """One call under torch.profiler: busy share, GEMM share, and
        attention's share (blockwise at the model's shape, timed alone, x
        layers)."""
        wall, events = device_profile(fn)
        dev_us = sum(us for _, us, _ in events)
        gemm_us = sum(us for name, us, _ in events if is_gemm_kernel(name))
        q, k, v, pos = attention_inputs(torch.Generator(device=dev).manual_seed(21), b, s,
                                        cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
                                        dev)
        with torch.inference_mode():
            t_attn = call_time_ms(lambda: attend_blockwise(
                q, k, v, pos, pos, causal=cfg.causal, window=cfg.sliding_window), iters=5)
        del q, k, v
        pct = lambda us: f"{100 * us / dev_us:.1f}%" if dev_us > 0 else "not measured"
        top = ", ".join(f"{name[:48]} {us / 1e3:.2f} ms x{c}" for name, us, c in events[:6])
        log(f"[frontends] {smi} | {arch} one forward ({b} x {s}) under torch.profiler: "
            f"{wall * 1e3:.1f} ms wall, device busy {dev_us / 1e3:.1f} ms "
            f"({100 * dev_us / 1e6 / wall:.1f}%); GEMM kernels {pct(gemm_us)}; attention "
            f"(blockwise, {t_attn:.2f} ms per layer timed alone, x{cfg.num_layers}) = "
            f"{pct(cfg.num_layers * t_attn * 1e3)} of device time; top: {top}")
        rec.update(busy_ms=dev_us / 1e3, busy_share=dev_us / 1e6 / wall,
                   gemm_share=gemm_us / dev_us if dev_us else None,
                   attn_ms_layer=t_attn,
                   attn_share=cfg.num_layers * t_attn * 1e3 / dev_us if dev_us else None)

    # (a) hubert-xlarge: the audio encoder at its published widths and depth.
    arch, n_params, (b, s) = HUBERT
    b, s = hubert_batch or (b, s)
    cfg = get_arch(arch, variant)
    if variant == "full" and count_params(cfg) != n_params:
        fail(f"{arch}: {count_params(cfg)} parameters, expected {n_params}")
    refused = {name: shape_applicable(cfg, shape)[1] for name, shape in SHAPES.items()
               if not shape_applicable(cfg, shape)[0]}
    if sorted(refused) != ["decode_32k", "long_500k"]:
        fail(f"frontends: {arch}'s refused shapes {refused}, expected its two decode shapes")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), torch.float32,
                         device=dev)
    pre = make_batch(cfg, ShapeConfig("audio", "prefill", s, b),
                     torch.Generator(device=dev).manual_seed(5), device=dev)["prefix_embeds"]
    torch.cuda.synchronize()
    log(f"[frontends] {arch} ({variant}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads x {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, {cfg.act}, causal "
        f"{cfg.causal}): {count_params(cfg)} random fp32 params initialised on the card in "
        f"{time.perf_counter() - t0:.2f} s; stub frames {tuple(pre.shape)} {pre.dtype}; refused "
        f"shapes {refused}")

    def encode(x, impl="blockwise"):
        with torch.inference_mode():
            return forward(params, cfg, None, prefix_embeds=x, attn_impl=impl)[0]

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logits = encode(pre)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    counts = read_counts()
    finite = bool(torch.isfinite(logits).all())
    got_shape, want_shape = tuple(logits.shape), (b, s, padded_vocab(cfg))
    del logits
    blk, naive = encode(pre[:1]), encode(pre[:1], "naive")
    attn_rel = float((blk - naive).abs().max() / naive.abs().max())
    del blk, naive
    log(f"[frontends] {arch} forward on {b} x {s} stub frames: logits {got_shape} (want "
        f"{want_shape}), finite {finite}, first call {t_first * 1e3:.1f} ms; main path launches "
        f"{counts}; blockwise vs naive at 1 x {s}: max |diff| / max |logit| = {attn_rel:.3e} "
        f"(tol {FRONTEND_ATTN_TOL:g})")
    if not (finite and got_shape == want_shape):
        fail(f"frontends: {arch}: logits {got_shape} (want {want_shape}), finite {finite}")
    if any(counts.values()):
        fail(f"frontends: {arch}: launch counts {counts}, expected none")
    if not attn_rel <= FRONTEND_ATTN_TOL:
        fail(f"frontends: {arch}: blockwise off naive by {attn_rel:.3e}")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        encode(pre)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    log(f"[frontends] {smi} | {arch} forward wall ({b} x {s} frames, calls 2-4): "
        f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms")
    rec = {"counts": counts, "forward_ms": [w * 1e3 for w in walls], "attn_rel": attn_rel}
    prefill_profile(arch, cfg, lambda: encode(pre), b, s, rec)
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[frontends] {smi} | {arch} peak device memory {rec['peak_gib']:.2f} GiB")
    out[arch] = rec
    del params, pre
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # (b) internvl2-76b: the vision-language decoder, depth cut, served.
    arch, n_full, layers, n_cut, (b, s, gen_len) = INTERNVL
    b, s, gen_len = internvl_batch or (b, s, gen_len)
    cfg = get_arch(arch, variant)
    if variant == "full" and count_params(cfg) != n_full:
        fail(f"{arch}: {count_params(cfg)} parameters, expected {n_full}")
    full_layers = cfg.num_layers
    cfg = dataclasses.replace(cfg, num_layers=min(layers, full_layers))
    if variant == "full" and count_params(cfg) != n_cut:
        fail(f"{arch}: {count_params(cfg)} parameters at {layers} layers, expected {n_cut}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), torch.float32,
                         device=dev)
    batch = make_batch(cfg, ShapeConfig("vision", "prefill", s, b),
                       torch.Generator(device=dev).manual_seed(7), device=dev)
    pre, tokens = batch["prefix_embeds"], batch["tokens"]
    torch.cuda.synchronize()
    vocab = cfg.vocab_size
    log(f"[frontends] {arch} ({variant}: {cfg.num_layers} of {full_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads on {cfg.num_kv_heads} x "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {vocab}): {count_params(cfg)} random "
        f"fp32 params initialised on the card in {time.perf_counter() - t0:.2f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held; stub batch: patches "
        f"{tuple(pre.shape)} {pre.dtype}, tokens {tuple(tokens.shape)}")

    def prefill(toks):
        with torch.inference_mode():
            return prefill_step(params, cfg, toks, prefix_embeds=pre, cache_dtype=torch.float32,
                                cache_len=s + gen_len)

    def serve():
        gemm_before = gemm_counters()
        t0 = time.perf_counter()
        logits, cache = prefill(tokens)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        gemm_pre = gemm_since(gemm_before)
        finite = torch.isfinite(logits).all()
        tok = torch.argmax(logits[:, -1:, :vocab], dim=-1)
        t0 = time.perf_counter()
        with torch.inference_mode():
            for _ in range(gen_len):
                logits, cache = decode_step(params, cfg, cache, tok)
                finite = finite & torch.isfinite(logits).all()
                tok = torch.argmax(logits[:, :, :vocab], dim=-1)
        torch.cuda.synchronize()
        return (bool(finite), cache["pos"].tolist(), t_pre, (time.perf_counter() - t0) / gen_len,
                gemm_pre)

    torch.cuda.synchronize()
    reset_counts()
    finite, pos, t_pre, t_dec, gemm_pre = serve()
    torch.cuda.synchronize()
    counts = read_counts()
    n_img = min(frontend_spec(cfg.frontend, s).prefix_tokens, s // 2)
    log(f"[frontends] {arch} served {b} x ({pre.shape[1]} image + {tokens.shape[1]} text) "
        f"tokens + {gen_len} greedy: logits finite {finite}, pos {sorted(set(pos))}; prefill "
        f"{t_pre * 1e3:.1f} ms (gemm_f32 {gemm_pre}), decode {t_dec * 1e3:.2f} ms/token (first "
        f"call); main path launches {counts}")
    if not (finite and pos == [s + gen_len] * b and pre.shape[1] == n_img):
        fail(f"frontends: {arch}: finite {finite}, pos {pos} (want {s + gen_len})")
    if any(counts.values()):
        fail(f"frontends: {arch}: launch counts {counts}, expected none")
    # Decode consistency: prefill(prefix + t[:, :-1]) + decode(t[:, -1]) ==
    # prefill(prefix + t)'s last position.
    _, cache = prefill(tokens[:, :-1])
    with torch.inference_mode():
        dec = decode_step(params, cfg, cache, tokens[:, -1:])[0][:, -1, :vocab]
    del cache
    whole = prefill(tokens)[0][:, -1, :vocab]
    scale = float(whole.abs().max())
    rel = float((dec - whole).abs().max()) / scale
    pick = torch.argmax(dec, dim=-1)
    gap = whole.max(dim=-1).values - torch.gather(whole, -1, pick[:, None])[:, 0]
    off_tie = int(((pick != torch.argmax(whole, dim=-1)) & (gap > DECODE_REL_TOL * scale)).sum())
    log(f"[frontends] {arch} decode consistency {b} x {s}: prefill + decode vs the whole "
        f"prefill, max |diff| / max |logit| = {rel:.3e} (tol {DECODE_REL_TOL:g}), greedy tokens "
        f"differing off near-ties {off_tie}")
    if not rel <= DECODE_REL_TOL or off_tie:
        fail(f"frontends: {arch} decode consistency: rel {rel:.3e}, off-tie {off_tie}")
    del dec, whole
    walls = [serve() for _ in range(3)]
    log(f"[frontends] {smi} | {arch} prefill wall per batch ({b} x {s}, calls 2-4): "
        f"{', '.join(f'{w[2] * 1e3:.1f}' for w in walls)} ms; decode wall per token (batch {b}, "
        f"{gen_len} tokens each): {', '.join(f'{w[3] * 1e3:.2f}' for w in walls)} ms")
    rec = {"counts": counts, "prefill_ms": [w[2] * 1e3 for w in walls],
           "decode_ms": [w[3] * 1e3 for w in walls], "decode_rel": rel}
    _, cache = prefill(tokens[:, :-1])

    def step():
        with torch.inference_mode():
            decode_step(params, cfg, cache, tokens[:, -1:])

    wall, events = device_profile(step)
    del cache
    dev_us = sum(us for _, us, _ in events)
    rec["decode_launches"] = sum(c for _, _, c in events)
    log(f"[frontends] {smi} | {arch} one decode step (batch {b}) under torch.profiler: "
        f"{wall * 1e3:.1f} ms wall, device busy {dev_us / 1e3:.2f} ms "
        f"({100 * dev_us / 1e6 / wall:.1f}%), {rec['decode_launches']} device kernels")
    prefill_profile(arch, cfg, lambda: prefill(tokens), b, s, rec)
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[frontends] {smi} | {arch} peak device memory {rec['peak_gib']:.2f} GiB")
    out[arch] = rec
    del params, pre, tokens, batch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # (c) both smoke models on the card against the CPU: the same weights
    # (drawn on the CPU, copied) and the same numpy stubs and tokens.
    rng = np.random.default_rng(17)
    for arch, n_pre, n_text in (("hubert-xlarge", 40, 0), ("internvl2-76b", 16, 24)):
        cfg = get_arch(arch, "smoke")
        p_cpu = init_params(cfg, torch.Generator().manual_seed(0), torch.float32, device="cpu")
        p_dev = {name: ({k: v.to(dev) for k, v in leaf.items()} if name == "blocks"
                        else leaf.to(dev)) for name, leaf in p_cpu.items()}
        stub = frontend_spec(cfg.frontend, n_pre).stub_dim
        pre_np = (0.02 * rng.standard_normal((2, n_pre, stub))).astype(np.float32)
        tok_np = rng.integers(0, cfg.vocab_size, (2, n_text)) if n_text else None
        errs = {}
        with torch.inference_mode():
            runs = {}
            for where, p, d in (("cpu", p_cpu, "cpu"), ("card", p_dev, dev)):
                pre_t = torch.from_numpy(pre_np).to(d)
                tok_t = None if tok_np is None else torch.from_numpy(tok_np).to(d)
                logits = forward(p, cfg, tok_t, prefix_embeds=pre_t)[0]
                last, cache = prefill_step(p, cfg, tok_t, prefix_embeds=pre_t,
                                           cache_dtype=torch.float32, cache_len=n_pre + n_text + 4)
                runs[where] = (logits.cpu(), last.cpu(), cache["k"].cpu())
        for i, name in enumerate(("forward", "prefill", "cache k")):
            errs[name] = rel_err(runs["card"][i], runs["cpu"][i])
        log(f"[frontends] {arch} smoke on the card against the CPU (same weights, same numpy "
            f"stubs): max_rel_err {', '.join(f'{k} {v:.3e}' for k, v in errs.items())} (tol "
            f"{MODEL_TOL:g})")
        if not max(errs.values()) <= MODEL_TOL:
            fail(f"frontends: {arch} smoke, card against CPU: {errs}")
        out[f"{arch}_card_vs_cpu"] = errs

    # (d) FleetEngine with a full-width audio class executing.
    out["serve"] = serve_execution(FRONTEND_SERVE, variant, dev, smi, "frontends")
    return out


def phase_entry_points(dev, smi, device_args=(), example_runs=None,
                      bench_runs: int = ENTRY_BENCH_RUNS) -> dict:
    """Phase 18: the four examples as a user runs them (each its own
    process, all at once; ``example_runs`` None: the reference's counts),
    each exiting 0 only where its claim holds; then ``python -m
    repro_torch.benchmarks.run --record build/bench_torch.json`` at
    ``bench_runs`` runs: every ported bench with a CSV line of positive µs
    per call (kernel_bench's kernel rows each), the roofline line over at
    least phase 21 (a)'s cells (both dtypes), no SKIPPED line, exit 0, the record
    labelled torch_full.
    ``device_args=("--device", "cpu")`` and small counts rehearse it on the
    CPU."""
    import re
    import tempfile

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        t0 = time.perf_counter()
        try:
            for name in ENTRY_EXAMPLES:
                log_path = Path(tmp) / f"{name}.log"
                with open(log_path, "w") as sink:
                    procs[name] = subprocess.Popen(
                        [sys.executable, "-m", f"repro_torch.examples.{name}", *device_args]
                        + (["--runs", str(example_runs)] if example_runs else []),
                        stdout=sink, stderr=subprocess.STDOUT, cwd=ROOT, env=env)
            for name, proc in procs.items():
                rc = proc.wait(timeout=900)
                text = (Path(tmp) / f"{name}.log").read_text()
                out[name] = {"rc": rc, "seconds": time.perf_counter() - t0}
                log(f"[entry] python -m repro_torch.examples.{name}: exit {rc}, done "
                    f"{out[name]['seconds']:.1f} s after the four started")
                for line in text.splitlines():
                    log(f"[entry] {name} | {line}")
                if rc != 0:
                    fail(f"entry points: examples.{name} exited {rc} (its claim, or an error)")
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()

    record = ROOT / ENTRY_RECORD
    record.unlink(missing_ok=True)
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "repro_torch.benchmarks.run", "--record",
                          ENTRY_RECORD, *device_args], capture_output=True, text=True,
                         timeout=900, cwd=ROOT, env={**env, "REPRO_BENCH_RUNS": str(bench_runs)})
    wall = time.perf_counter() - t0
    lines = [m.groups() for m in (re.match(r"^([\w.]+),(-?[0-9.]+),(.*)$", line)
                                  for line in run.stdout.splitlines()) if m]
    for name, us, derived in lines:
        log(f"[entry] {smi} | bench {name},{us},{derived}")
    ran = {bench: [float(us) for name, us, _ in lines if name.startswith(prefix)]
           for bench, prefix in ENTRY_BENCHES.items()}
    skipped = [name for name, _, derived in lines if derived.startswith("SKIPPED")]
    failed = [name for name, _, derived in lines if derived == "FAILED"]
    kernel_rows = [(float(us), derived) for name, us, derived in lines
                   if name.startswith(ENTRY_BENCHES["kernel_bench"]) and "_kernel_" in name]
    roof = [derived for name, _, derived in lines if name == ENTRY_ROOFLINE]
    roof_cells = int(roof[0].split("cells=")[1].split(";")[0]) if roof else 0
    history = json.loads(record.read_text()) if record.exists() else []
    n_records = len(history[-1]["benches"]) if history else 0
    log(f"[entry] python -m repro_torch.benchmarks.run (REPRO_BENCH_RUNS={bench_runs}): exit "
        f"{run.returncode} in {wall:.1f} s; CSV lines per bench "
        f"{ {k: len(v) for k, v in ran.items()} }; kernel_bench's kernel rows "
        f"{[us for us, _ in kernel_rows]} µs; {ENTRY_ROOFLINE} {roof}; skipped {skipped}; "
        f"failed {failed}; record {ENTRY_RECORD}: {[h['label'] for h in history]}, "
        f"{n_records} records")
    if not (run.returncode == 0 and not failed and all(v and max(v) > 0.0 for v in ran.values())
            and len(kernel_rows) == ENTRY_KERNEL_ROWS
            and all(us > 0.0 and "skipped" not in d for us, d in kernel_rows)
            and roof_cells >= len(DRY_CELLS) * len(DRY_DTYPES)
            and sorted(skipped) == sorted(ENTRY_SKIPPED)
            and [h["label"] for h in history] == ["torch_full"]
            and n_records == len(lines) - len(skipped)):
        fail(f"entry points: the orchestrator: exit {run.returncode}, failed {failed}, "
             f"skipped {skipped}, lines {ran}: {run.stdout[-2000:]} {run.stderr[-2000:]}")
    out["orchestrator"] = {"seconds": wall, "records": n_records}
    return out


def tree_diff(got, want, prefix="") -> list[str]:
    """The leaves of two like-structured output trees (named tuples,
    tuples, dicts of tensors) that are not bitwise equal."""
    import torch

    if isinstance(want, torch.Tensor):
        same = got.shape == want.shape and torch.equal(got, want)
        return [] if same else [prefix or "."]
    if isinstance(want, dict):
        return [d for k in want for d in tree_diff(got[k], want[k], f"{prefix}.{k}")]
    names = getattr(want, "_fields", range(len(want)))
    return [d for name, a, b in zip(names, got, want) for d in tree_diff(a, b, f"{prefix}.{name}")]


def chunked_call(call, chunks: int) -> dict:
    """``call(runs_mesh(chunks))`` with the launch counts set to 0 before
    and read after, its wall, and its peak device memory above what was
    held before it."""
    import torch

    from repro_torch.distributed.mesh import runs_mesh

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    outs = call(runs_mesh(chunks))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"outs": outs, "wall_s": wall, "counts": read_counts(),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "above_gib": (torch.cuda.max_memory_allocated() - mem0) / 2**30}


def chunked_arms(label: str, smi: str, call, chunk_counts, runs: int, t_slots: int) -> dict:
    """``call`` at each chunk count: gmsa_score launched t_slots x chunks
    times each, every output finite and bitwise the first count's; each
    call's wall and peak memory printed. Returns {chunks: launches}."""
    import torch

    first, launches = None, {}
    for n in chunk_counts:
        rec = chunked_call(call, n)
        outs = rec["outs"]
        launches[n] = rec["counts"]["gmsa_score"]
        per = -(-runs // n)
        log(f"[substrate] {label}, R = {runs} in {n} chunks of {per} runs"
            f"{' (padded)' if per * n != runs else ''}: launches {rec['counts']}; {smi} | wall "
            f"{rec['wall_s'] * 1e3:.1f} ms, peak device memory {rec['peak_gib']:.2f} GiB "
            f"({rec['above_gib']:.2f} GiB above what was held before the call)")
        if launches[n] != t_slots * n:
            fail(f"substrate: {label}: gmsa_score launched {launches[n]} times in {n} chunks, "
                 f"expected {t_slots * n}")
        flat = outs if not isinstance(outs, tuple) or hasattr(outs, "_fields") else outs[0]
        for name, x in flat._asdict().items():
            if not bool(torch.isfinite(x).all()):
                fail(f"substrate: {label}: non-finite {name} in {n} chunks")
        if first is None:
            first = (n, outs)
            continue
        diff = tree_diff(outs, first[1])
        log(f"[substrate] {label}: {n} chunks against {first[0]}: "
            f"{'every output bitwise equal' if not diff else f'differ in {diff}'}")
        if diff:
            fail(f"substrate: {label}: {n} chunks differ from {first[0]} in {diff}")
        del outs
    del first
    torch.cuda.empty_cache()
    return launches


def int8_sync_ms(params, efb, n_pods: int) -> float:
    """Device time of the int8 pod sync alone on one step's gradients
    (random, params-shaped): each pod's error-feedback add and quantization
    of every leaf, then every leaf's exchange and owned sums, as the train
    step runs them; CUDA events around one warm call."""
    import torch

    from repro_torch.distributed.compression import quantize_pod, reduce_pods
    from repro_torch.train.optimizer import leaves

    flat_p, flat_e = leaves(params), leaves(efb)
    grads = [torch.randn_like(p, dtype=torch.float32) for p in flat_p]

    def sync():
        sent = [[quantize_pod(g + e[pod], n_pods)[:2] for pod in range(n_pods)]
                for g, e in zip(grads, flat_e)]
        return [reduce_pods(torch.stack([x[0] for x in rows]), torch.stack([x[1] for x in rows]),
                            p.shape, torch.float32) for rows, p in zip(sent, flat_p)]

    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    sync()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def phase_substrate(dev, smi, cfg=None, runs: int = SUB_RUNS,
                    degraded_runs: int = SUB_DEGRADED_RUNS, shard_runs: int = SUB_RUNS,
                    variant: str = "full", pod_batch=TRAIN_BATCH,
                    serve_batch=SUB_SERVE_BATCH) -> dict:
    """Phase 20 (see the module docstring); the arguments cut it down for a
    rehearsal on the CPU with the phase 14 stubs."""
    import torch

    from repro_torch.benchmarks import shard_bench
    from repro_torch.configs import get_arch
    from repro_torch.configs.fleet_256 import FleetConfig, make_fleet_builder
    from repro_torch.core.gmsa import make_kernel_policy
    from repro_torch.core.simulator import simulate_many
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.jobs import simulate_staged_many, stage_oblivious
    from repro_torch.launch.train import token_batch
    from repro_torch.models.lm import init_params
    from repro_torch.serve.step import make_decode_step, make_local_exec, make_prefill_step
    from repro_torch.traces.bandwidth import link_fault_trace
    from repro_torch.traces.faults import health_trace
    from repro_torch.traces.tokens import SyntheticTokenStream, TokenPipelineConfig, lm_inputs
    from repro_torch.train import AdamWConfig, TrainStepConfig, adamw_init, make_train_step
    from repro_torch.train.optimizer import leaves, tree_map

    out = {}
    # (a) shard_bench on the card.
    t0 = time.perf_counter()
    res = shard_bench.run(shard_runs, SUB_SHARD_CHUNKS, dev)
    us1, usn = res["us"][1], res["us"][SUB_SHARD_CHUNKS]
    log(f"[substrate] shard_bench facebook_4dc T = {shard_bench.SHARD_SLOTS}, {shard_runs} runs, "
        f"GMSA: 1 chunk {us1 * shard_runs / 1e3:.1f} ms a call ({us1:.1f} us per run), "
        f"{SUB_SHARD_CHUNKS} chunks {usn * shard_runs / 1e3:.1f} ms ({usn:.1f} us per run), "
        f"ratio {us1 / usn:.2f}x (not gated: one card); bitwise {res['bitwise']}; {smi}; "
        f"{time.perf_counter() - t0:.1f} s")
    try:
        shard_bench.verify(res)
    except AssertionError as exc:
        fail(f"substrate: shard_bench: {exc}")

    # (b) fleet_256 simulate_many through the kernel at R = 1000.
    cfg = cfg or FleetConfig()
    _, build = make_fleet_builder(cfg, device=dev)
    gen = lambda: torch.Generator(device=dev).manual_seed(7)
    policy = make_kernel_policy(None)
    out["launches_fleet"] = chunked_arms(
        "fleet_256 simulate_many, make_kernel_policy(None)", smi,
        lambda mesh: simulate_many(build, policy, gen(), runs, cfg.v, device=dev, mesh=mesh),
        SUB_FLEET_CHUNKS, runs, cfg.t_slots)

    # (c) the staged fleet, then its degraded-link bill.
    sbuild, dag, wan = staged_fleet(cfg, dev)
    arm = stage_oblivious(make_kernel_policy(None), pin_map=True)
    staged = lambda r, **kw: (lambda mesh: simulate_staged_many(
        sbuild, dag, wan, arm, gen(), r, cfg.v, device=dev, mesh=mesh, **kw))
    out["launches_staged"] = chunked_arms(
        f"staged fleet (K = {cfg.k_types}, S = {dag.s_max})", smi, staged(runs),
        SUB_STAGED_CHUNKS, runs, cfg.t_slots)
    hgen = torch.Generator(device=dev).manual_seed(PLACED_DEGRADED_SEED)
    health_trace(hgen, cfg.t_slots, cfg.n_sites, death_prob=0.05, device=dev)
    link = link_fault_trace(hgen, cfg.t_slots, cfg.n_sites, sever_frac=0.0, device=dev)
    plans_gb = degraded_runs * cfg.t_slots * dag.s_max * cfg.k_types * cfg.n_sites ** 2 * 4 / 1e9
    log(f"[substrate] degraded-link bill: {float((link < 1).float().mean()):.4f} of link-slots "
        f"degraded; its (..., K, N, N) plans would take {plans_gb:.0f} GB in one call of "
        f"{degraded_runs} runs, {plans_gb / degraded_runs:.2f} GB a run")
    out["launches_degraded"] = chunked_arms(
        "staged fleet with the degraded-link bill", smi, staged(degraded_runs, link_health=link),
        SUB_DEGRADED_CHUNKS, degraded_runs, cfg.t_slots)
    ones = chunked_call(staged(degraded_runs, link_health=torch.ones_like(link)),
                        SUB_DEGRADED_CHUNKS[0])
    none = chunked_call(staged(degraded_runs), SUB_DEGRADED_CHUNKS[0])
    diff = tree_diff(ones["outs"], none["outs"])
    log(f"[substrate] all-ones link_health against None, {SUB_DEGRADED_CHUNKS[0]} chunks: "
        f"{'every output bitwise equal' if not diff else f'differ in {diff}'}; walls "
        f"{ones['wall_s'] * 1e3:.1f} / {none['wall_s'] * 1e3:.1f} ms, peaks "
        f"{ones['peak_gib']:.2f} / {none['peak_gib']:.2f} GiB; {smi}")
    if diff:
        fail(f"substrate: all-ones link_health differs from None in {diff}")
    del ones, none
    torch.cuda.empty_cache()

    # (d) the pod train step: native against int8 from the same params.
    pcfg = get_arch(SUB_POD_ARCH, variant)
    b, s = pod_batch
    ocfg = AdamWConfig()          # the reference's defaults: a run's first steps, in warm-up
    mesh = Mesh((2,), ("pod",))
    params0 = init_params(pcfg, torch.Generator(device=dev).manual_seed(0), torch.float32, dev)
    pipe = SyntheticTokenStream(TokenPipelineConfig(vocab_size=pcfg.vocab_size, seq_len=s + 1,
                                                    global_batch=b, seed=0))
    batches = [token_batch(lm_inputs(pipe.batch(i)), dev) for i in range(SUB_POD_STEPS)]
    pod = {}
    for sync in ("native", "int8"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = tree_map(lambda t: t.clone(), params0)
        opt = adamw_init(params)
        step, init_efb = make_train_step(pcfg, TrainStepConfig(
            microbatches=TRAIN_MICROBATCHES, remat=TRAIN_REMAT, grad_sync=sync, optimizer=ocfg),
            device=dev, mesh=mesh)
        efb = init_efb(params)
        rec = {"losses": [], "walls": []}
        for i in range(SUB_POD_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, met, efb = step(params, opt, batches[i], efb)
            torch.cuda.synchronize()
            rec["walls"].append(time.perf_counter() - t0)
            rec["losses"].append(float(met["loss"]))
            if i == 0:
                rec["after1"] = [t.detach().clone() for t in leaves(params)]
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        if sync == "int8":
            rec["sync_ms"] = int8_sync_ms(params, efb, 2)
        pod[sync] = rec
        del params, opt, efb, step
    nat, q8 = pod["native"], pod["int8"]
    dmax = max(float((a - c).abs().max()) for a, c in zip(nat.pop("after1"), q8.pop("after1")))
    for sync, rec in pod.items():
        log(f"[substrate] {SUB_POD_ARCH} ({variant}) on a 2-pod mesh, grad_sync={sync}: losses "
            f"{', '.join(f'{x:.6f}' for x in rec['losses'])}; {smi} | step walls "
            f"{', '.join(f'{w:.3f}' for w in rec['walls'])} s, peak device memory "
            f"{rec['peak_gib']:.2f} GiB"
            + (f", the int8 sync alone {rec['sync_ms']:.2f} ms of device time" if "sync_ms" in rec
               else ""))
    step1 = abs(q8["losses"][0] - nat["losses"][0]) / abs(nat["losses"][0])
    later = max(abs(a - c) / abs(c) for a, c in zip(q8["losses"][1:], nat["losses"][1:]))
    log(f"[substrate] pod step: step-1 losses differ by {step1:.2e} of the native loss (tol "
        f"{SUB_POD_STEP1_RTOL:g}), steps 2-{SUB_POD_STEPS} by at most {later:.2e} (tol "
        f"{SUB_POD_LOSS_RTOL:g}); the largest param difference after one step {dmax:.3e}")
    if not all(math.isfinite(x) for r in pod.values() for x in r["losses"]):
        fail(f"substrate: pod step: non-finite loss {pod}")
    if step1 > SUB_POD_STEP1_RTOL or later > SUB_POD_LOSS_RTOL:
        fail(f"substrate: pod step: int8 losses {q8['losses']} against native {nat['losses']}")
    out["pod"] = pod
    del batches
    torch.cuda.empty_cache()

    # (e) the sharded serving steps at world size 1.
    b, s = serve_batch
    tok = torch.randint(0, pcfg.vocab_size, (b, s), generator=torch.Generator(device=dev)
                        .manual_seed(5), device=dev)
    one = Mesh((1, 1), ("data", "model"))
    prefill, _, _ = make_prefill_step(pcfg, one, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params0, tokens=tok)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    local, _ = make_local_exec(pcfg, 16, device=dev)
    local_logits, _ = local(params0, tok)
    same = torch.equal(logits, local_logits)
    nxt = logits.argmax(-1)
    dec = {kv: make_decode_step(pcfg, one, kv_shard=kv, device=dev)[0](params0, cache, nxt)
           for kv in ("heads", "seq")}
    diff = tree_diff(dec["seq"], dec["heads"])
    log(f"[substrate] make_prefill_step {SUB_POD_ARCH} ({variant}) {b} x {s}: {wall * 1e3:.1f} ms, "
        f"logits finite {bool(torch.isfinite(logits).all())}, bitwise make_local_exec's: {same} "
        f"(only the cache differs: bf16 and as long as the prompt against fp32 with 16 more "
        f"slots); make_decode_step kv_shard heads against seq: "
        f"{'logits and cache bitwise equal' if not diff else f'differ in {diff}'}; {smi}")
    if not (same and bool(torch.isfinite(logits).all())) or diff:
        fail("substrate: the sharded serving steps differ from the local path")
    del params0, cache, dec, logits, local_logits
    torch.cuda.empty_cache()
    return out


def phase_dryrun() -> dict:
    """Phase 21 (a): ``lower_cell`` for each of DRY_CELLS on the meta
    device, in each of DRY_DTYPES, each artifact written to the dry-run's
    default directory (variant ``baseline``; shape
    ``card_<kind>_<B>x<S>_<dtype>``), where the orchestrator's ``roofline``
    bench reads it. The counters are set to 0 before and read after: a meta
    pass launches no kernel. Returns the records by (arch, kind, dtype).
    start_dryrun runs it in a process of its own."""
    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.dryrun import MESHES, artifact_path, lower_cell
    from repro_torch.train import TrainStepConfig

    recs = {}
    reset_counts()
    t0 = time.perf_counter()
    for (arch, kind, (b, s), phase), dname in ((c, d) for c in DRY_CELLS for d in DRY_DTYPES):
        shape = ShapeConfig(f"card_{kind}_{b}x{s}_{dname}", kind, s, b)
        tcfg = (TrainStepConfig(microbatches=TRAIN_MICROBATCHES, remat=TRAIN_REMAT)
                if kind == "train" else TrainStepConfig())
        rec = lower_cell(arch, shape, False, tcfg, param_dtype=getattr(torch, dname))
        path = artifact_path(arch, shape.name, MESHES[False][0], "baseline")
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(rec, indent=1))
        recs[(arch, kind, dname)] = rec
        rl, mem = rec["roofline"], rec["memory"]
        where = phase if kind == "train" or dname == "float32" else "21 (b)"
        log(f"[dryrun] {arch} {kind} {b} x {s} ({rec['variant']}, {dname}; measured in phase "
            f"{where}): one meta pass of {rec['aten_ops']} ATen ops in "
            f"{rec['compile_seconds']} s; {rec['flops']:.4e} FLOPs (matmul-class), "
            f"{rec['bytes_accessed']:.4e} bytes; arguments {mem['argument_bytes'] / 2**30:.2f} "
            f"GiB, peak {mem['peak_bytes'] / 2**30:.2f} GiB (fits one card "
            f"{rec['fits_one_card']}); H100 data-sheet roofline: compute {rl['compute_s']:.4f} "
            f"s, memory {rl['memory_s']:.4f} s, bound {rl['step_time_s']:.4f} s "
            f"({rl['dominant']}); {path.relative_to(ROOT)}")
    host = time.perf_counter() - t0
    counts = read_counts()
    log(f"[dryrun] {len(recs)} cells in {host:.1f} s of host time (budget "
        f"{DRY_HOST_BUDGET_S} s); launches {counts}")
    if any(counts.values()):
        fail(f"dryrun: a meta pass launched a kernel: {counts}")
    return recs


def dryrun_cells(out: Path) -> int:
    """``python3 chip_smoke.py --dryrun-cells OUT``: phase_dryrun alone,
    its records written to OUT as JSON by ``arch|kind|dtype``."""
    recs = phase_dryrun()
    out.write_text(json.dumps({"|".join(k): v for k, v in recs.items()}))
    return 0


def start_dryrun() -> tuple[subprocess.Popen, Path, Path]:
    """Phase 21 (a) in a process of its own, started before the build: the
    meta passes need no card (its CUDA_VISIBLE_DEVICES is empty) and take
    one host core, so they run beside the build and the phases after it.
    Returns the process, its log and its records' path (under build/)."""
    where = ROOT / "build"
    where.mkdir(exist_ok=True)
    log_path, out = where / "dryrun_cells.log", where / "dryrun_cells.json"
    out.unlink(missing_ok=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": ""}
    with open(log_path, "w") as sink:
        proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dryrun-cells",
                                 str(out)], stdout=sink, stderr=subprocess.STDOUT, cwd=ROOT,
                                env=env)
    return proc, log_path, out


def collect_dryrun(proc: subprocess.Popen, log_path: Path, out: Path, started: float) -> dict:
    """Wait for start_dryrun's process, relay its log, fail if it failed;
    returns phase_dryrun's records."""
    t0 = time.perf_counter()
    rc = proc.wait(timeout=600)
    waited = time.perf_counter() - t0
    for line in log_path.read_text().splitlines():
        log(line)
    if rc != 0:
        fail(f"dryrun: the meta passes' process exited {rc}")
    log(f"[dryrun] phase 21 (a) ran in its own process beside phases 2-17; phase 18 waited "
        f"{waited:.1f} s for it ({t0 + waited - started:.1f} s after it started)")
    return {tuple(k.split("|")): v for k, v in json.loads(out.read_text()).items()}


def prefill_walls(arch: str, dtype, dev, batch=TRAIN_BATCH, variant: str = "full") -> list[float]:
    """Phase 21 (b)'s walls of the dry-run's prefill step
    (make_prefill_step, blockwise attention) for ``arch`` at ``variant``
    with random ``dtype`` weights (init_params, seed 0), on the synthetic token
    stream's first batch of ``batch`` tokens: a warm-up call, then
    PREFILL_TIMED_CALLS, each ended by a synchronize."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import MESHES
    from repro_torch.launch.train import token_batch
    from repro_torch.models.lm import init_params
    from repro_torch.serve.step import make_prefill_step
    from repro_torch.traces.tokens import SyntheticTokenStream, TokenPipelineConfig, lm_inputs

    cfg = get_arch(arch, variant)
    b, s = batch
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dtype, dev)
    pipe = SyntheticTokenStream(TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=s + 1,
                                                    global_batch=b, seed=0))
    tokens = token_batch(lm_inputs(pipe.batch(0)), dev)["tokens"]
    prefill, _, _ = make_prefill_step(cfg, MESHES[False][1], "blockwise", device=dev)
    walls = []
    for i in range(1 + PREFILL_TIMED_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, tokens=tokens)
        torch.cuda.synchronize()
        if i:
            walls.append(time.perf_counter() - t0)
    del params, tokens
    torch.cuda.empty_cache()
    return walls


def phase_dryrun_against_card(smi, recs: dict, measured: dict) -> None:
    """Phase 21 (b), after phase 19: each DRY_CELLS record, in each of
    DRY_DTYPES, against what the card measured in this run. ``measured``:
    (arch, kind, dtype) -> (steady walls in seconds, peak GiB or None). The
    roofline's bound must not exceed the fastest wall (a bound above a wall
    means a wrong count or constant); a train cell's dry-run peak must be
    within DRY_PEAK_RTOL of ``max_memory_allocated``."""
    bad = []
    for (arch, kind, (b, s), phase), dname in ((c, d) for c in DRY_CELLS for d in DRY_DTYPES):
        rec = recs[(arch, kind, dname)]
        walls, peak_gib = measured[(arch, kind, dname)]
        rl = rec["roofline"]
        wall = min(walls)
        where = phase if kind == "train" or dname == "float32" else "21 (b)"
        share_3x = rec["flops_3xtf32"] / rec["flops"] if rec["flops"] else 0.0
        line = (f"[dryrun] {smi} | {arch} {kind} {b} x {s} {dname}: bound "
                f"{rl['step_time_s']:.4f} s ({rl['dominant']}; compute {rl['compute_s']:.4f} s "
                f"at {rec['peak_flops'] / 1e12:.1f} TFLOP/s {rec['param_dtype']}, "
                f"{100 * share_3x:.1f}% of the FLOPs as 3xTF32; memory "
                f"{rl['memory_s']:.4f} s at 3.35 TB/s) against phase {where}'s walls "
                f"{', '.join(f'{w:.4f}' for w in walls)} s: the fastest wall reaches "
                f"{100 * rl['step_time_s'] / wall:.1f}% of the roofline (compute alone "
                f"{100 * rl['compute_s'] / wall:.1f}%); roofline_fraction "
                f"{rl['roofline_fraction']:.3f}, useful_flops_ratio "
                f"{rl['useful_flops_ratio']:.3f}")
        if rl["step_time_s"] > wall:
            bad.append(f"{arch} {kind} {dname}: bound {rl['step_time_s']:.4f} s above the wall "
                       f"{wall:.4f}")
        if peak_gib is not None:
            dry_gib = rec["memory"]["peak_bytes"] / 2**30
            rel = abs(dry_gib - peak_gib) / peak_gib
            line += (f"; peak: dry-run {dry_gib:.2f} GiB, max_memory_allocated {peak_gib:.2f} "
                     f"GiB, {100 * rel:.1f}% apart (tol {100 * DRY_PEAK_RTOL:.0f}%)")
            if rel > DRY_PEAK_RTOL:
                bad.append(f"{arch} {kind} {dname}: peak {dry_gib:.2f} GiB against "
                           f"{peak_gib:.2f}")
        log(line)
    if bad:
        fail(f"dryrun against the card: {bad}")


#: --ssd-arm: the forward chain timed at the serving engine's prefill, the
#: serving shape, the training microbatch and hymba-1.5b's prefill, in fp32
#: and bf16, each kernel's mean by the profiler; the backward chain's
#: outputs at SSD_ARM_BWD_SHAPE on the first arm's forward workspaces.
SSD_ARM_SHAPES = [SSD_ENGINE_SHAPE, SSD_SERVE_SHAPE, (2, 2048, 80, 64, 128, 256),
                  (4, 2048, 50, 64, 16, 256)]
SSD_ARM_BWD_SHAPE = (2, 512, 80, 64, 128, 256)


#: gemm_f32's shapes (M, K, N), x (M, K) @ W (K, N): mamba2-2.7b's prefill
#: products at 4 x 2048 tokens (w_z / w_x, ssm_out, w_b / w_c, w_dt),
#: hymba-1.5b's (FFN up, FFN down, q / wo, k / v, B / C, the SSD's z / x and
#: out), ragged tiles of M, N and K, and the serving engine's 4 x 32 prompts.
GEMM_SHAPES = [
    (8192, 2560, 5120), (8192, 5120, 2560), (8192, 2560, 128), (8192, 2560, 80),
    (8192, 1600, 5504), (8192, 5504, 1600), (8192, 1600, 1600), (8192, 1600, 320),
    (8192, 1600, 16), (8192, 1600, 3200), (8192, 3200, 1600),
    (1000, 1036, 1100), (300, 68, 516), (257, 20, 132), (33, 4, 8), (128, 2560, 5120),
]
#: Accuracy gates, each the largest gap to fp64 over |x|·|W| (elementwise):
#: the kernel within GEMM_LIB_FACTOR times cuBLAS's fp32 SGEMM's own gap on
#: the same inputs, and GEMM_TF32_FACTOR times under one TF32 product's.
GEMM_LIB_FACTOR, GEMM_TF32_FACTOR = 4.0, 30.0
#: The kernel against its plain 3xTF32 version (the same products summed in
#: another order), over |x|·|W|.
GEMM_REF_TOL = 1e-5
#: The size rule's sweep: the kernel and torch.matmul at each (M, K, N).
GEMM_SWEEP_M = (128, 256, 512, 1024, 2048, 8192)
GEMM_SWEEP_N = (16, 64, 128, 320, 1600, 5120)
GEMM_SWEEP_K = (1600, 2560)
GEMM_MODELS = (MAMBA_ARCH, "hymba-1.5b")


def gemm_counters() -> dict[str, int]:
    """gemm_f32's counters: kernel launches, and the fp32 CUDA weight
    products that matmul_f32 left to torch.matmul."""
    from repro_torch.kernels.gemm_f32.kernel import gemm_f32_cuda
    from repro_torch.kernels.gemm_f32.ops import matmul_f32

    return {"gemm_f32_cuda.launches": gemm_f32_cuda.launches,
            "matmul_f32.library_calls": matmul_f32.library_calls}


def reset_gemm_counters() -> None:
    from repro_torch.kernels.gemm_f32.kernel import gemm_f32_cuda
    from repro_torch.kernels.gemm_f32.ops import matmul_f32

    gemm_f32_cuda.launches = matmul_f32.library_calls = 0


def gemm_since(before: dict[str, int]) -> dict[str, int]:
    """gemm_f32's counters since ``before`` (a gemm_counters() reading)."""
    return {k: v - before[k] for k, v in gemm_counters().items()}


def gemm_bound_ms(m: int, k: int, n: int) -> tuple[float, str]:
    """Least time of one (M, K) @ (K, N) as 3xTF32: three TF32 products at
    the tensor cores' 495 TFLOP/s, or the operands read and y written once
    at 3.35 TB/s, whichever is larger."""
    t_ops = 3 * 2 * m * n * k / H100_TF32_FLOPS
    t_bytes = 4 * (m * k + k * n + m * n) / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def gemm_check(m: int, k: int, n: int, dev, timed: bool = True) -> dict:
    """gemm_f32 at one (M, K, N) on unit-normal x and a W of the model's
    init scale (1/sqrt(K)): its gap to fp64 over |x|·|W| beside cuBLAS fp32
    SGEMM's and one TF32 product's, its gap to the plain 3xTF32 version,
    two launches bitwise; with ``timed``, its device time, torch.matmul's
    (library_ms) and the 3xTF32 bound."""
    import torch

    from repro_torch.kernels.gemm_f32.kernel import gemm_f32_cuda
    from repro_torch.kernels.gemm_f32.ref import gemm_f32_ref

    gen = torch.Generator(device=dev).manual_seed(1000 * m + 10 * n + k)
    x = torch.randn((m, k), generator=gen, device=dev)
    w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
    y = gemm_f32_cuda(x, w)
    again = gemm_f32_cuda(x, w)
    torch.cuda.synchronize()
    lib = torch.matmul(x, w)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = torch.matmul(x, w)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    ref = gemm_f32_ref(x, w)
    x64, w64 = x.double(), w.double()
    y64 = x64 @ w64
    scale = (x64.abs() @ w64.abs()).clamp_min(1e-300)
    del x64, w64

    def gap(got):
        return float(((got.double() - y64).abs() / scale).max())

    out = {"shape": (m, k, n), "err": gap(y), "err_lib": gap(lib), "err_tf32": gap(tf32),
           "err_ref": float(((y.double() - ref.double()).abs() / scale).max()),
           "bitwise": bool(torch.equal(y, again))}
    del y64, scale, lib, tf32, ref, again, y
    if timed:
        out["ms"] = device_time_ms(lambda: gemm_f32_cuda(x, w), reps=10, iters=5)
        out["library_ms"] = device_time_ms(lambda: torch.matmul(x, w), reps=10, iters=5)
        out["bound_ms"], out["bound_by"] = gemm_bound_ms(m, k, n)
        out["tflops"] = 2 * m * n * k / out["ms"] / 1e9
    return out


def gemm_model(arch: str, dev) -> dict:
    """One fp32 prefill batch of ``arch`` (full width and depth, random
    weights, 4 x 2048 tokens) through make_local_exec: gemm_f32's counters
    for the batch and its walls; then the same prefill with every product on
    torch.matmul (prefill_step under grad mode, no operand requiring grad),
    its walls, and the gaps of the last-position logits and of the cache
    leaves over the library path's largest entry (as the benchmark's
    logits_rel / state_rel read them)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.lm import init_params, prefill_step
    from repro_torch.serve.step import make_local_exec

    cfg = get_arch(arch)
    b, s = TRAIN_BATCH
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), torch.float32, dev)
    tokens = torch.randint(0, cfg.vocab_size, (b, s),
                           generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    prefill_fn, _ = make_local_exec(cfg, 16, device=dev)

    def library():
        with torch.enable_grad():
            return prefill_step(params, cfg, tokens, attn_impl="blockwise",
                                cache_dtype=torch.float32, cache_len=s + 16)

    out = {"arch": arch}
    for name, fn in (("kernel", lambda: prefill_fn(params, tokens)), ("library", library)):
        walls, counts = [], []
        for i in range(1 + PREFILL_TIMED_CALLS):
            torch.cuda.synchronize()
            reset_gemm_counters()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            counts.append(gemm_counters())
            if i:
                walls.append(time.perf_counter() - t0)
        out[name] = {"walls": walls, "counts": counts[-1], "result": res}
    (lk, ck), (ll, cl) = out["kernel"].pop("result"), out["library"].pop("result")
    out["logits_rel"] = rel_err_max(lk, ll)
    leaves = [(a, c) for a, c in zip(torch.utils._pytree.tree_leaves(ck),
                                     torch.utils._pytree.tree_leaves(cl))
              if isinstance(a, torch.Tensor) and a.is_floating_point()]
    out["state_rel"] = max(rel_err_max(a, c) for a, c in leaves)
    del params, tokens, lk, ck, ll, cl, leaves
    torch.cuda.empty_cache()
    return out


def gemm_train_counts(dev) -> dict:
    """Two-layer mamba2-2.7b training steps, bf16 and fp32 weights, 4 x 2048
    tokens: gemm_f32's counters over one step each. Every product is under
    autograd, so none may launch the kernel (and bf16 ones are not counted
    as fp32 library calls either)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.train import token_batch
    from repro_torch.models.lm import init_params
    from repro_torch.traces.tokens import SyntheticTokenStream, TokenPipelineConfig, lm_inputs
    from repro_torch.train import AdamWConfig, TrainStepConfig, adamw_init, make_train_step

    cfg = dataclasses.replace(get_arch(MAMBA_ARCH), num_layers=2)
    b, s = TRAIN_BATCH
    pipe = SyntheticTokenStream(TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=s + 1,
                                                    global_batch=b, seed=0))
    batch = token_batch(lm_inputs(pipe.batch(0)), dev)
    tcfg = TrainStepConfig(microbatches=TRAIN_MICROBATCHES, remat=TRAIN_REMAT,
                           optimizer=AdamWConfig(lr=3e-4, total_steps=2, warmup_steps=0))
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dtype, dev)
        opt = adamw_init(params)
        step, init_efb = make_train_step(cfg, tcfg, device=dev)
        efb = init_efb(params)
        reset_gemm_counters()
        step(params, opt, batch, efb)
        torch.cuda.synchronize()
        out[str(dtype).removeprefix("torch.")] = gemm_counters()
        del params, opt, efb
    torch.cuda.empty_cache()
    return out


def phase_gemm(dev, smi) -> dict:
    """Phase 22: gemm_f32 at every GEMM_SHAPES shape against fp64, cuBLAS
    fp32 SGEMM, one TF32 product and its plain version (the gates), its
    time beside torch.matmul's and the 3xTF32 bound; the size rule's grid
    (kernel and torch.matmul at each (M, K, N), and which route matmul_f32
    takes there); the counters per fp32 prefill batch of mamba2-2.7b and
    hymba-1.5b, their walls beside the all-library path's and the gaps
    between the two, and the counters of bf16 and fp32 training steps."""
    import torch

    from repro_torch.kernels.gemm_f32.kernel import gemm_f32_cuda
    from repro_torch.kernels.gemm_f32.ops import kernel_wins

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"shapes": []}
    for m, k, n in GEMM_SHAPES:
        rec = gemm_check(m, k, n, dev)
        out["shapes"].append(rec)
        log(f"[gemm] {smi} | (M, K, N) = ({m}, {k}, {n}): gap to fp64 over |x|·|W| "
            f"{rec['err']:.3e} (cuBLAS fp32 {rec['err_lib']:.3e}, TF32 {rec['err_tf32']:.3e}); "
            f"to the plain 3xTF32 version {rec['err_ref']:.3e}; bitwise repeat "
            f"{rec['bitwise']}; device {rec['ms']:.4f} ms ({rec['tflops']:.1f} TFLOP/s), "
            f"library_ms {rec['library_ms']:.4f}, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}, {100 * rec['bound_ms'] / rec['ms']:.1f}% reached)")
        if not (rec["err"] <= GEMM_LIB_FACTOR * rec["err_lib"]
                and GEMM_TF32_FACTOR * rec["err"] <= rec["err_tf32"]
                and rec["err_ref"] <= GEMM_REF_TOL and rec["bitwise"]):
            fail(f"gemm: accuracy gates at ({m}, {k}, {n}): {rec}")
    out["sweep"] = []
    for k in GEMM_SWEEP_K:
        for n in GEMM_SWEEP_N:
            for m in GEMM_SWEEP_M:
                x = torch.randn((m, k), device=dev)
                w = torch.randn((k, n), device=dev)
                t_k = device_time_ms(lambda: gemm_f32_cuda(x, w), reps=10, iters=3)
                t_l = device_time_ms(lambda: torch.matmul(x, w), reps=10, iters=3)
                out["sweep"].append((m, k, n, t_k, t_l))
                log(f"[gemm] sweep (M, K, N) = ({m}, {k}, {n}): kernel {t_k:.4f} ms, "
                    f"torch.matmul {t_l:.4f} ms, ratio {t_l / t_k:.2f}; matmul_f32 takes "
                    + ("the kernel" if kernel_wins(m, n, k) else "torch.matmul"))
    for arch in GEMM_MODELS:
        rec = gemm_model(arch, dev)
        out[arch] = rec
        log(f"[gemm] {smi} | {arch} fp32 prefill 4 x 2048: per batch {rec['kernel']['counts']}; "
            "walls " + ", ".join(f"{w:.4f}" for w in rec["kernel"]["walls"])
            + " s; every product on torch.matmul: "
            + ", ".join(f"{w:.4f}" for w in rec["library"]["walls"])
            + f" s ({rec['library']['counts']}); gaps to it: logits_rel "
            f"{rec['logits_rel']:.3e}, state_rel {rec['state_rel']:.3e}")
        if not rec["kernel"]["counts"]["gemm_f32_cuda.launches"]:
            fail(f"gemm: {arch}'s prefill launched no gemm_f32")
    out["train"] = gemm_train_counts(dev)
    log(f"[gemm] mamba2-2.7b (2 layers) training step counters: {out['train']}")
    if any(c["gemm_f32_cuda.launches"] for c in out["train"].values()) or \
            out["train"]["bfloat16"]["matmul_f32.library_calls"]:
        fail(f"gemm: a training step's product took the kernel: {out['train']}")
    return out


def gemm_only() -> int:
    """``python3 chip_smoke.py --gemm``: phase 2's build of gemm_f32 and its
    spill gate, then phase 22 alone."""
    import torch

    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = phase_device()
    t0 = time.perf_counter()
    logs = _build.build_all(["gemm_f32"])
    log(f"[build] gemm_f32 built in {time.perf_counter() - t0:.2f} s")
    spill_gate(logs)
    phase_gemm(dev, smi)
    return 0


def ssd_arm(dump: Path, steps: bool = False) -> int:
    """``python3 chip_smoke.py --ssd-arm SRC DUMP [--steps]``: one arm of a comparison
    of two checkouts' ssd_scan chains on one card, run in turns (parent,
    change, change, parent), the repro_torch under SRC imported (and its
    kernels built beside it). Logs each SSD_ARM_SHAPES shape's chain time
    (device_time_ms) and each kernel's mean per launch (phase_times); then
    the backward chain at SSD_ARM_BWD_SHAPE in fp32 and bf16: where DUMP
    does not exist, on this arm's forward workspaces, saved with the
    gradients into DUMP; where it does, on the saved workspaces, its
    gradients compared bitwise with the saved ones (exit 1 where they
    differ), and this arm's forward workspaces against the saved ones
    (logged: cum bitwise, G and h_in by max_rel_err). With ``--steps``,
    then the full-width mamba2-2.7b bf16 train step (train_step_record: its
    walls and the SSD chains' shares of its device time) and the fp32 4 x
    2048 prefill (prefill_walls)."""
    import torch

    from repro_torch.kernels._build import SOURCES
    from repro_torch.kernels.ssd_scan.kernel import (
        _ssd_scan_bwd_cuda_phases,
        _ssd_scan_cuda_phases,
        ssd_scan_cuda,
    )

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    phase_device()
    log(f"[arm] ssd_scan from {SOURCES['ssd_scan']}")
    for shape in SSD_ARM_SHAPES:
        b, s, h, p, n, q = shape
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=dev).manual_seed(31)
            ops = ssd_inputs(gen, b, s, h, p, n, dtype, dev, model_like=True)
            t_k = device_time_ms(lambda: ssd_scan_cuda(*ops, q), reps=5, iters=4)
            phase, total = phase_times(lambda: ssd_scan_cuda(*ops, q), 3,
                                       {ph: f"ssd_scan_{ph}_kernel" for ph in SSD_PHASES})
            log(f"[arm] B={b} S={s} H={h} P={p} N={n} chunk={q} "
                f"{str(dtype).removeprefix('torch.')}: chain {t_k:.4f} ms; by phase "
                + ", ".join(f"{ph} " + ("not measured" if ms is None else f"{ms:.4f} ms")
                            for ph, ms in phase.items()) + f"; total {total:.4f} ms")
            del ops
    first = not dump.exists()
    saved = {} if first else torch.load(dump, map_location=dev)
    b, s, h, p, n, q = SSD_ARM_BWD_SHAPE
    same = True
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype).removeprefix("torch.")
        gen = torch.Generator(device=dev).manual_seed(37)
        ops = ssd_inputs(gen, b, s, h, p, n, dtype, dev, model_like=True)
        dy = torch.randn((b, s, h, p), generator=gen, device=dev).to(dtype)
        dhf = torch.randn((b, h, p, n), generator=gen, device=dev)
        own = _ssd_scan_cuda_phases(*ops, q)[2:]
        ws = own if first else saved[f"{key}_ws"]
        if not first:
            tri = torch.ones(q, q, dtype=torch.bool, device=dev).tril()
            log(f"[arm] forward workspaces at {SSD_ARM_BWD_SHAPE} {key} against the first "
                f"arm's: cum bitwise {torch.equal(own[0], ws[0])}, G on and below the diagonal "
                f"max_rel_err {rel_err(own[1][..., tri], ws[1][..., tri]):.3e}, h_in "
                f"{rel_err(own[2], ws[2]):.3e}")
        got = _ssd_scan_bwd_cuda_phases(*ops, dy, dhf, *ws, q)[:5]
        torch.cuda.synchronize()
        if first:
            saved[f"{key}_ws"], saved[f"{key}_grads"] = ws, got
        else:
            eq = [torch.equal(u, v) for u, v in zip(got, saved[f"{key}_grads"])]
            same &= all(eq)
            log(f"[arm] backward at {SSD_ARM_BWD_SHAPE} {key} on the first arm's workspaces: "
                f"dx, ddt, da, dB, dC bitwise the first arm's: {eq}")
    if first:
        dump.parent.mkdir(parents=True, exist_ok=True)
        torch.save(saved, dump)
        log(f"[arm] backward outputs and forward workspaces saved to {dump}")
    del saved, ops, dy, dhf, ws, own, got
    if steps:
        rec = train_step_record(MAMBA_ARCH, "full", dev, TRAIN_BATCH, dtype=torch.bfloat16)
        log(f"[arm] {MAMBA_ARCH} bf16 train step (4 x 2048, 2 microbatches, full remat): walls "
            + ", ".join(f"{w:.4f}" for w in rec["walls"]) + f" s, median {rec['wall_s']:.4f} s; "
            f"device busy {rec['device_busy_ms']:.1f} ms, the forward chains "
            f"{100 * rec['fwd_share']:.2f}%, the backward chains {100 * rec['bwd_share']:.2f}% "
            "of it")
        walls = prefill_walls(MAMBA_ARCH, torch.float32, dev)
        log(f"[arm] {MAMBA_ARCH} fp32 prefill (4 x 2048): walls "
            + ", ".join(f"{w:.4f}" for w in walls) + " s")
    return 0 if same else 1


def main() -> int:
    if sys.argv[1:2] == ["--ssd-arm"]:
        sys.path.insert(0, str(Path(sys.argv[2]).resolve()))
        return ssd_arm(Path(sys.argv[3]), steps="--steps" in sys.argv[4:])
    sys.path.insert(0, str(ROOT / "src"))
    if sys.argv[1:2] == ["--dryrun-cells"]:
        return dryrun_cells(Path(sys.argv[2]))
    if sys.argv[1:2] == ["--gemm"]:
        return gemm_only()
    import torch

    from repro_torch.kernels._build import SOURCES  # noqa: F401 (fails outside the repo)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing run", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = phase_device()
    started = time.perf_counter()
    dry_run = start_dryrun()
    try:
        return run_phases(dev, smi, dry_run, started)
    finally:
        if dry_run[0].poll() is None:
            dry_run[0].kill()
            dry_run[0].wait()


def run_phases(dev, smi, dry_run, started) -> int:
    """Phases 2-23; ``dry_run``: start_dryrun's process, collected before
    phase 18."""
    import torch

    from repro_torch.kernels._build import SOURCES

    mma = phase_build()
    main_shape = phase_kernels(dev)
    mism, lock_rel = phase_lockstep(dev)
    launches, _ = phase_end_to_end(dev)
    phase_paper(dev)
    ssd = phase_ssd_kernel(dev)
    ssd_launches, mamba_prefill_s = phase_mamba2(dev, smi)
    sweep_launches = phase_sweep(dev, smi)
    phase_figures(dev, smi)
    tel_launches = phase_telemetry(dev, smi)
    staged_launches = phase_staged(dev, smi)
    placed = phase_placement(dev, smi)
    serve = phase_serve(dev, smi)
    dense_launches, dense_prefill_s = phase_dense(dev, smi)
    moe_hybrid = phase_moe_hybrid(dev, smi)
    t0 = time.perf_counter()
    front = phase_frontends(dev, smi)
    log(f"[frontends] phase 17 took {time.perf_counter() - t0:.1f} s")
    dry = collect_dryrun(*dry_run, started)
    t0 = time.perf_counter()
    phase_entry_points(dev, smi)
    log(f"[entry] phase 18 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ssd_bwd = phase_ssd_bwd(dev)
    train = phase_train(dev, smi)
    log(f"[train] phase 19 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    substrate = phase_substrate(dev, smi)
    log(f"[substrate] phase 20 took {time.perf_counter() - t0:.1f} s")
    bf = {arch: train[f"{arch} bf16"] for arch in TRAIN_ARCHS}
    t0 = time.perf_counter()
    bf16_prefill = {arch: prefill_walls(arch, torch.bfloat16, dev) for arch in TRAIN_ARCHS}
    phase_dryrun_against_card(smi, dry, {
        (MAMBA_ARCH, "train", "float32"): (train[MAMBA_ARCH]["walls"],
                                           train[MAMBA_ARCH]["peak_gib"]),
        ("qwen2-0.5b", "train", "float32"): (train["qwen2-0.5b"]["walls"],
                                             train["qwen2-0.5b"]["peak_gib"]),
        (MAMBA_ARCH, "prefill", "float32"): (mamba_prefill_s, None),
        ("qwen2-0.5b", "prefill", "float32"): (dense_prefill_s["qwen2-0.5b"], None),
        **{(arch, "train", "bfloat16"): (bf[arch]["walls"], bf[arch]["peak_gib"])
           for arch in TRAIN_ARCHS},
        **{(arch, "prefill", "bfloat16"): (bf16_prefill[arch], None) for arch in TRAIN_ARCHS},
    })
    log(f"[dryrun] phase 21 (b) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gemm = phase_gemm(dev, smi)
    log(f"[gemm] phase 22 took {time.perf_counter() - t0:.1f} s")

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
        "launches_frontends": front["hubert-xlarge"]["counts"]["gmsa_score"]
        + front["internvl2-76b"]["counts"]["gmsa_score"],
        "launches_serve_frontend": front["serve"]["counts"]["gmsa_score"],
        "launches_chunked_fleet": substrate["launches_fleet"],
        "launches_chunked_staged": substrate["launches_staged"],
        "launches_chunked_degraded": substrate["launches_degraded"],
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
        "launches_frontends": front["hubert-xlarge"]["counts"]["ssd_scan"]
        + front["internvl2-76b"]["counts"]["ssd_scan"],
        "launches_serve_frontend": front["serve"]["counts"]["ssd_scan"],
        "max_abs_err_hybrid": ssd["max_abs_err_hybrid"],
        "ms_hybrid": ssd["ms_hybrid"],
        "plain_ms_hybrid": ssd["plain_ms_hybrid"],
        "bound_ms_hybrid": ssd["bound_ms_hybrid"],
        "bound_by_hybrid": ssd["bound_by_hybrid"],
        "launches_train": train[MAMBA_ARCH]["counts"][1]["ssd_scan"],
        "launches_train_dense": train["qwen2-0.5b"]["counts"][1]["ssd_scan"],
        "launches_train_bf16": train[f"{MAMBA_ARCH} bf16"]["counts"][1]["ssd_scan"],
        **{k: ssd[k] for k in ssd
           if k.endswith(tuple(f"_{t}{d}" for t, _, _ in SSD_FWD_TIMED.values()
                               for d in ("", "_bf16")))
           and k.startswith(("ms_", "plain_ms_", "bound_", "phase_", "max_abs_err_", "library_ms_",
                             "ref_ms_"))},
        "max_excess_bf16": ssd["max_excess_bf16_fwd"],
        "hmma": mma["ssd_scan"],
    }
    mamba, mamba_bf16 = train[MAMBA_ARCH], train[f"{MAMBA_ARCH} bf16"]
    bwd_entry = {
        "name": "ssd_scan_bwd",
        "route": "cuda",
        "source": str(SOURCES["ssd_scan_bwd"].relative_to(ROOT)),
        # No TPU backward: the gradient of the forward kernel's function.
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:29",
        "launches": mamba["counts"][1]["ssd_scan_bwd"],
        "max_abs_err": ssd_bwd["train"]["max_abs_err"],
        "ms": ssd_bwd["train"]["ms"],
        "plain_ms": ssd_bwd["train"]["plain_ms"],
        "bound_ms": ssd_bwd["train"]["bound_ms"],
        "bound_by": ssd_bwd["train"]["bound_by"],
        "library_ms": None,   # no single PyTorch call computes the SSD scan's gradient
        "fwd_ms": ssd_bwd["train"]["fwd_ms"],
        "bound_ms_tc": ssd_bwd["train"]["bound_ms_tc"],
        "bound_by_tc": ssd_bwd["train"]["bound_by_tc"],
        "phase_ms": ssd_bwd["train"]["phase_ms"],
        "phase_bound_ms": ssd_bwd["train"]["phase_bound_ms"],
        "phase_bound_ms_tc": ssd_bwd["train"]["phase_bound_ms_tc"],
        "phase_ms_in_step": mamba["bwd_phase_ms"],
        "hmma": mma["ssd_scan_bwd"],
        "max_rel_err_plain": ssd_bwd["max_rel_err_plain"],
        "max_rel_err_autograd": ssd_bwd["max_rel_err_autograd"],
        "layer0_rel_err": mamba["layer0_err"],
        "launches_train_dense": train["qwen2-0.5b"]["counts"][1]["ssd_scan_bwd"],
        "ms_hybrid": ssd_bwd["hybrid"]["ms"],
        "fwd_ms_hybrid": ssd_bwd["hybrid"]["fwd_ms"],
        "plain_ms_hybrid": ssd_bwd["hybrid"]["plain_ms"],
        "bound_ms_hybrid": ssd_bwd["hybrid"]["bound_ms"],
        "bound_by_hybrid": ssd_bwd["hybrid"]["bound_by"],
        "bound_ms_tc_hybrid": ssd_bwd["hybrid"]["bound_ms_tc"],
        "phase_ms_hybrid": ssd_bwd["hybrid"]["phase_ms"],
        "phase_bound_ms_hybrid": ssd_bwd["hybrid"]["phase_bound_ms"],
        "phase_bound_ms_tc_hybrid": ssd_bwd["hybrid"]["phase_bound_ms_tc"],
        "train_step_s": mamba["wall_s"],
        "train_tokens_per_s": mamba["tokens_per_s"],
        "launches_bf16": mamba_bf16["counts"][1]["ssd_scan_bwd"],
        "max_abs_err_bf16": ssd_bwd["train_bf16"]["max_abs_err"],
        "max_excess_bf16": max(ssd_bwd["train_bf16"]["max_rel_err"],
                               ssd_bwd["max_excess_plain_bf16"]),
        "ms_bf16": ssd_bwd["train_bf16"]["ms"],
        "fwd_ms_bf16": ssd_bwd["train_bf16"]["fwd_ms"],
        "plain_ms_bf16": ssd_bwd["train_bf16"]["plain_ms"],
        "bound_ms_bf16": ssd_bwd["train_bf16"]["bound_ms"],
        "bound_by_bf16": ssd_bwd["train_bf16"]["bound_by"],
        "bound_ms_tc_bf16": ssd_bwd["train_bf16"]["bound_ms_tc"],
        "phase_ms_bf16": ssd_bwd["train_bf16"]["phase_ms"],
        "bound_by_tc_bf16": ssd_bwd["train_bf16"]["bound_by_tc"],
        "phase_bound_ms_bf16": ssd_bwd["train_bf16"]["phase_bound_ms"],
        "phase_bound_ms_tc_bf16": ssd_bwd["train_bf16"]["phase_bound_ms_tc"],
        "phase_ms_in_step_bf16": mamba_bf16["bwd_phase_ms"],
        "layer0_excess_bf16": mamba_bf16["layer0_err"],
        "ms_hybrid_bf16": ssd_bwd["hybrid_bf16"]["ms"],
        "plain_ms_hybrid_bf16": ssd_bwd["hybrid_bf16"]["plain_ms"],
        "bound_ms_hybrid_bf16": ssd_bwd["hybrid_bf16"]["bound_ms"],
        "bound_by_hybrid_bf16": ssd_bwd["hybrid_bf16"]["bound_by"],
        "phase_ms_hybrid_bf16": ssd_bwd["hybrid_bf16"]["phase_ms"],
        "train_step_s_bf16": mamba_bf16["wall_s"],
        "train_tokens_per_s_bf16": mamba_bf16["tokens_per_s"],
    }
    main_gemm = gemm["shapes"][0]
    gemm_entry = {
        "name": "gemm_f32",
        "route": "cuda",
        "source": str(SOURCES["gemm_f32"].relative_to(ROOT)),
        "replaces": None,   # no TPU kernel: the JAX package's weight products are jnp.matmul
        "launches_prefill": {a: gemm[a]["kernel"]["counts"] for a in GEMM_MODELS},
        "launches_train": gemm["train"],
        "shape": main_gemm["shape"],
        "max_rel_err": max(r["err"] for r in gemm["shapes"]),
        "ms": main_gemm["ms"],
        "library_ms": main_gemm["library_ms"],
        "bound_ms": main_gemm["bound_ms"],
        "bound_by": main_gemm["bound_by"],
        "by_shape": {str(r["shape"]): {k: r[k] for k in ("ms", "library_ms", "bound_ms", "err",
                                                          "err_lib", "err_tf32")}
                     for r in gemm["shapes"]},
        "prefill_walls": {a: {"kernel": gemm[a]["kernel"]["walls"],
                              "library": gemm[a]["library"]["walls"],
                              "logits_rel": gemm[a]["logits_rel"],
                              "state_rel": gemm[a]["state_rel"]} for a in GEMM_MODELS},
    }
    log(f"[device] phases 2-22 took {time.perf_counter() - started:.1f} s")
    log(f"[device] {smi}")
    print(json.dumps({"kernels": [entry, ssd_entry, bwd_entry, gemm_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
