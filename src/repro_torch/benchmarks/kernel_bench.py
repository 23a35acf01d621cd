"""Kernel-layer microbenchmarks and the fleet-scale end-to-end run — the
port of the JAX package's ``benchmarks/kernel_bench.py``, at its shapes.

The reference's matrix has three arms of one decision: the hoisted
``einsum``, the Pallas kernel under the interpreter, and the kernel
compiled for the TPU where there is one. The port's arms:

* ``einsum`` — the hoisted form in plain torch (the per-epoch cost table
  precomputed, per slot only the score and the argmin; for the SSD scan the
  chunked ``models.ssm.ssd_chunked``);
* ``plain`` — the kernel's ``ref.py`` (``gmsa_score_ref``, the sequential
  ``ssd_scan_ref``), in the place of the ``interpret`` row;
* ``kernel`` — the hand-written CUDA kernel through its wrapper
  (``gmsa_score``, ``ssd_scan`` on CUDA tensors); without a card its row is
  ``status=skipped_no_cuda``, as the reference records ``skipped_no_pallas``.

Every arm must agree with the plain version before its time is printed:
argmins equal except at near-ties (a differing pick whose plain score is
within ``TIE_RTOL`` of the row's minimum: the arms sum the cost in other
orders), the SSD outputs within ``SSD_TOL``. ``bench_fleet_e2e`` at T = 48
holds the kernel engine to the reference engine as the reference does:
dispatch agreement > 0.999 and mean cost within 1e-3.

    PYTHONPATH=src python -m repro_torch.benchmarks.kernel_bench [--device cpu] [--record PATH]
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from repro_torch.benchmarks.common import emit, timed, write_record
from repro_torch.configs.fleet_256 import FleetConfig, make_fleet_builder, make_score_operands
from repro_torch.core.gmsa import gmsa_policy, make_kernel_policy
from repro_torch.core.simulator import simulate
from repro_torch.device import resolve_device
from repro_torch.kernels.gmsa_score import gmsa_score
from repro_torch.kernels.gmsa_score.ref import gmsa_score_ref
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.models.ssm import ssd_chunked

#: End-to-end fleet horizon (the reference's): long enough that queues
#: develop, so the argmin runs against live backlogs.
FLEET_E2E_SLOTS = 48
#: The reference's SSD tolerance (``rtol = atol = 3e-4``).
SSD_TOL = 3e-4
#: A differing argmin is a near-tie where its plain score is within this
#: relative distance (plus TIE_ATOL) of the plain minimum.
TIE_RTOL = 1e-5
TIE_ATOL = 1e-4


def _skipped(name: str, backend: str) -> dict:
    return emit(name, 0.0, f"backend={backend};arm=kernel;status=skipped_no_cuda")


def _agreement(best, best_ref, s_ref) -> float:
    """Share of argmins equal to the plain version's; raises on a
    difference off a near-tie."""
    best, best_ref = best.long(), best_ref.long()
    diff = best != best_ref
    if diff.any():
        got = torch.gather(s_ref, -1, best[..., None])[..., 0]
        want = torch.gather(s_ref, -1, best_ref[..., None])[..., 0]
        off_tie = diff & ((got - want).abs() > TIE_ATOL + TIE_RTOL * want.abs())
        if off_tie.any():
            raise AssertionError(f"{int(off_tie.sum())} argmins differ off a near-tie")
    return 1.0 - float(diff.float().mean())


def bench_gmsa_dispatch(dev) -> list[dict]:
    """``gmsa_score``'s plain version, and the kernel on a card, at fleet
    scales (K classes x N pods): the per-slot control-plane latency."""
    records = []
    backend = dev.type
    for (k, n) in [(1, 4), (16, 64), (128, 1024)]:
        gen = torch.Generator(device=dev).manual_seed(0)
        uniforms = lambda *shape: torch.rand(shape, generator=gen, device=dev)
        q, mu = uniforms(k, n) * 100, uniforms(k, n) * 50
        a, vp = uniforms(k) * 40, uniforms(k) * 10
        # normalized uniforms, as the reference (not dirichlet)
        raw = uniforms(k, n, n) + 1e-3
        r = raw / raw.sum(-1, keepdim=True)
        del raw
        wpue = uniforms(n) * 20
        (s_ref, best_ref), us = timed(lambda: gmsa_score_ref(q, mu, a, vp, r, wpue), dev)
        records.append(emit(f"gmsa_dispatch_plain_K{k}_N{n}", us,
                            f"backend={backend};arm=plain;r_tensor_mb={r.numel() * 4 / 1e6:.1f}"))
        if dev.type == "cuda":
            (_, best), us = timed(lambda: gmsa_score(q, mu, a, vp, r, wpue), dev)
            agree = _agreement(best, best_ref, s_ref)
            records.append(emit(f"gmsa_dispatch_kernel_K{k}_N{n}", us,
                                f"backend={backend};arm=kernel;agree={agree:.4f}"))
        else:
            records.append(_skipped(f"gmsa_dispatch_kernel_K{k}_N{n}", backend))
    return records


def bench_gmsa_matrix(dev) -> list[dict]:
    """The einsum / plain / kernel matrix of one fleet-scale slot (N = 256,
    the scenario's prices and ratios, a developed backlog)."""
    backend = dev.type
    cfg = FleetConfig(t_slots=FLEET_E2E_SLOTS)
    q, mu, a, vp, r, wpue, e = make_score_operands(cfg, device=dev)
    k, n = q.shape
    s_ref, best_ref = gmsa_score_ref(q, mu, a, vp, r, wpue)
    records = []

    # einsum: the table V·P^k·(r·wpue) precomputed once per epoch (what
    # ``simulate`` closes over), so the per-slot work is score + argmin.
    e_hoist = cfg.v * e
    best, us = timed(lambda: torch.argmin(a[:, None] * (q - mu + e_hoist), dim=1), dev)
    agree = _agreement(best, best_ref, s_ref)
    records.append(emit(f"gmsa_matrix_einsum_N{n}_K{k}", us,
                        f"backend={backend};arm=einsum;agree={agree:.4f}"))

    (_, best), us = timed(lambda: gmsa_score_ref(q, mu, a, vp, r, wpue), dev)
    agree = _agreement(best, best_ref, s_ref)
    records.append(emit(f"gmsa_matrix_plain_N{n}_K{k}", us,
                        f"backend={backend};arm=plain;agree={agree:.4f}"))

    if dev.type == "cuda":
        (_, best), us = timed(lambda: gmsa_score(q, mu, a, vp, r, wpue), dev)
        agree = _agreement(best, best_ref, s_ref)
        records.append(emit(f"gmsa_matrix_kernel_N{n}_K{k}", us,
                            f"backend={backend};arm=kernel;agree={agree:.4f}"))
    else:
        records.append(_skipped(f"gmsa_matrix_kernel_N{n}_K{k}", backend))
    return records


def _ssd_inputs(gen, b, s, h, p, n, dev):
    x = torch.randn((b, s, h, p), generator=gen, device=dev)
    dt = F.softplus(torch.randn((b, s, h), generator=gen, device=dev))
    a = -torch.exp(torch.randn((h,), generator=gen, device=dev))
    bm = torch.randn((b, s, n), generator=gen, device=dev)
    cm = torch.randn((b, s, n), generator=gen, device=dev)
    return x, dt, a, bm, cm


def _close(got, want) -> None:
    torch.testing.assert_close(got, want, rtol=SSD_TOL, atol=SSD_TOL)


def bench_ssd_matrix(dev) -> list[dict]:
    """The same matrix for the SSD scan at the reference's reduced slice of
    the mamba2-2.7b layer geometry (b=1, s=256, h=2): chunked (einsum),
    sequential (plain) and the kernel."""
    backend = dev.type
    b, s, h, p, n, chunk = 1, 256, 2, 64, 128, 64
    x, dt, a, bm, cm = _ssd_inputs(torch.Generator(device=dev).manual_seed(2), b, s, h, p, n, dev)
    records = []

    (y_ein, _), us = timed(lambda: ssd_chunked(x, dt, a, bm, cm, chunk), dev)
    (y_ref, _), us_ref = timed(lambda: ssd_scan_ref(x, dt, a, bm, cm), dev, iters=1)
    _close(y_ein, y_ref)
    records.append(emit(f"ssd_matrix_einsum_S{s}_H{h}", us, f"backend={backend};arm=einsum"))
    records.append(emit(f"ssd_matrix_plain_S{s}_H{h}", us_ref, f"backend={backend};arm=plain"))

    if dev.type == "cuda":
        (y_k, _), us = timed(lambda: ssd_scan(x, dt, a, bm, cm, chunk=chunk), dev)
        _close(y_k, y_ref)
        records.append(emit(f"ssd_matrix_kernel_S{s}_H{h}", us, f"backend={backend};arm=kernel"))
    else:
        records.append(_skipped(f"ssd_matrix_kernel_S{s}_H{h}", backend))
    return records


def bench_fleet_e2e(dev) -> list[dict]:
    """N = 256 fleet GMSA end to end through the kernel dispatch path
    (``make_kernel_policy``: the kernel on a card, its plain version on the
    CPU) against the hoisted-table engine."""
    cfg = FleetConfig(t_slots=FLEET_E2E_SLOTS)
    template, _ = make_fleet_builder(cfg, device=dev)
    records = []

    o_ref, us_ref = timed(lambda: simulate(template, gmsa_policy, None, cfg.v), dev)
    records.append(emit(
        f"fleet256_e2e_ref_T{cfg.t_slots}", us_ref,
        f"n={cfg.n_sites};k={cfg.k_types};us_per_slot={us_ref / cfg.t_slots:.1f};"
        f"avg_cost={float(o_ref.cost.mean()):.0f};"
        f"final_backlog={float(o_ref.backlog_total[-1]):.1f}"))

    pol_k = make_kernel_policy(template.r, template.p_it)
    o_k, us_k = timed(lambda: simulate(template, pol_k, None, cfg.v), dev, iters=1)
    agree = float((o_k.f_trace == o_ref.f_trace).float().mean())
    cost_rel = abs(float(o_k.cost.mean()) - float(o_ref.cost.mean())) / max(
        float(o_ref.cost.mean()), 1e-9)
    records.append(emit(
        f"fleet256_e2e_kernel_T{cfg.t_slots}", us_k,
        f"kernel={dev.type == 'cuda'};dispatch_agreement={agree:.4f};"
        f"cost_rel_err={cost_rel:.2e}"))
    if not agree > 0.999:
        raise AssertionError(f"kernel dispatch must match the reference engine (got {agree})")
    if not cost_rel < 1e-3:
        raise AssertionError(f"fleet e2e cost diverged ({cost_rel})")
    return records


def bench_ssd(dev) -> list[dict]:
    """The SSD scan at the mamba2-2.7b layer geometry (1 x 2048, 80 heads):
    the chunked plain form (chunk 256), and the kernel against it."""
    backend = dev.type
    b, s, h, p, n = 1, 2048, 80, 64, 128
    x, dt, a, bm, cm = _ssd_inputs(torch.Generator(device=dev).manual_seed(1), b, s, h, p, n, dev)
    (y_ein, _), us = timed(lambda: ssd_chunked(x, dt, a, bm, cm, 256), dev)
    flops = 2 * b * s * h * (256 * p + 2 * p * n)   # per-token chunk matmuls (approx)
    records = [emit("ssd_chunked_einsum_mamba2_layer_S2048", us,
                    f"backend={backend};arm=einsum;approx_gflop={flops / 1e9:.1f}")]
    if dev.type == "cuda":
        (y_k, _), us = timed(lambda: ssd_scan(x, dt, a, bm, cm, chunk=256), dev)
        _close(y_k, y_ein)
        records.append(emit("ssd_chunked_kernel_mamba2_layer_S2048", us,
                            f"backend={backend};arm=kernel;approx_gflop={flops / 1e9:.1f}"))
    else:
        records.append(_skipped("ssd_chunked_kernel_mamba2_layer_S2048", backend))
    return records


def run(device=None) -> list[dict]:
    """The five benches, in the reference's order; prints the CSV lines and
    returns them as records."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    records = []
    for bench in (bench_gmsa_dispatch, bench_gmsa_matrix, bench_fleet_e2e, bench_ssd,
                  bench_ssd_matrix):
        records.extend(bench(dev))
    return records


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--record", default=None, metavar="PATH",
                    help="append the records to this JSON list (label torch_kernel_bench)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    records = run(dev)
    if args.record:
        write_record(args.record, "torch_kernel_bench", records, dev)
    return records


if __name__ == "__main__":
    main()
