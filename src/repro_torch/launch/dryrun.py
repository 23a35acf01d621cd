"""Dry-run of every (arch × shape × mesh) cell on one card — the port of
``repro.launch.dryrun``.

Per cell it answers the reference's three questions, does the step fit,
what does it cost, and what bounds it, without allocating anything:

  1. builds the train, prefill or decode step as the reference's
     ``_lower_one`` does, with the shardings from the port's
     ``serve.step`` / ``distributed.sharding`` (specs only: one card is a
     world of size 1);
  2. runs one pass of it on the ``meta`` device (shapes, no storage) under
     :class:`repro_torch.launch.cost.CostMode`, the counterpart of lowering
     on ``ShapeDtypeStruct`` stand-ins: FLOPs, bytes moved, argument /
     output / temporary / peak bytes;
  3. prices them with the H100's roofline (:mod:`repro_torch.launch.roofline`)
     and writes one JSON artifact under
     ``benchmarks/artifacts/dryrun_torch/``.

Not ported, with the reason: the 512 placeholder XLA devices (one card
runs the whole program), the HLO parse of collectives (there is no HLO:
the int8 pod exchange is counted from shapes) and the L = 1 / L = 2
extrapolation (it corrects XLA counting a ``while`` body once; the port's
layers are a Python loop, so the pass is counted whole).

Meshes: ``single`` is one card (tag ``1x1``); ``multi`` is
``Mesh((2, 1, 1), ("pod", "data", "model"))`` (tag ``2x1x1``), whose two
pods run one after another on the card as ``make_train_step(mesh=...)``
runs them. ``chips`` is 1 in both.

Params are bf16 in every cell, as the reference's ``_param_structs``
builds them (``param_dtype`` in the artifact; the roofline takes that
dtype's peak, and 3xTF32's for ``flops_3xtf32``, the fp32 weight products
the card gives ``gemm_f32``: ``peak_flops`` in the artifact); a caller may
ask for another dtype, as ``chip_smoke.py`` asks for fp32 beside bf16.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
      --mesh both [--variant baseline] [--force]

Inapplicable cells (encoder decode, full-attention 500k) are written as
skipped with the reference's reason; a cell that raises writes
``.FAILED.json`` and the run exits 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback

import torch

from repro_torch.configs import SHAPES, ShapeConfig, get_arch, list_archs, shape_applicable
from repro_torch.distributed.mesh import Mesh
from repro_torch.distributed.sharding import batch_pspecs, param_pspecs
from repro_torch.launch.cost import CostMode
from repro_torch.launch.roofline import (
    HBM_BW,
    HBM_BYTES,
    pass_peak_flops,
    pod_sync_bytes,
    roofline_terms,
)
from repro_torch.models.inputs import cache_spec, make_batch, make_decode_tokens
from repro_torch.models.lm import param_structs
from repro_torch.serve.step import make_decode_step, make_prefill_step
from repro_torch.train.optimizer import adamw_init, leaves
from repro_torch.train.step import TrainStepConfig, make_train_step

ART_DIR = pathlib.Path(__file__).resolve().parents[3] / "benchmarks" / "artifacts" / "dryrun_torch"

#: Mesh choice -> (artifact tag, mesh).
MESHES = {
    False: ("1x1", Mesh((1, 1), ("data", "model"))),
    True: ("2x1x1", Mesh((2, 1, 1), ("pod", "data", "model"))),
}
KV_DTYPES = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}
_FLASH_NOTE = ("equal to bytes_accessed: the port has no fused attention, so every score "
               "tile goes through HBM")


def _shape(shape) -> ShapeConfig:
    return SHAPES[shape] if isinstance(shape, str) else shape


def _run_one(cfg, shape: ShapeConfig, mesh: Mesh, tcfg: TrainStepConfig, dtype,
             kv_shard: str, kv_dtype):
    """One pass of the cell's step on ``meta`` under a CostMode. Returns
    (the mode, the step's outputs, the collective bytes {"total",
    "by_kind"}). The specs are resolved as the reference's
    ``shardings_for`` resolves them, and place nothing."""
    mode = CostMode()
    params = param_structs(cfg, dtype)
    coll = {"total": 0.0, "by_kind": {}}
    if shape.kind == "train":
        step, init_efb = make_train_step(cfg, tcfg, device="meta", mesh=mesh)
        opt = adamw_init(params)
        batch = make_batch(cfg, shape, as_spec=True)
        efb = init_efb(params)
        param_pspecs(cfg, mesh)
        batch_pspecs(batch, mesh, shape.global_batch)
        mode.hold(params, opt, batch, efb)
        with mode:
            out = step(params, opt, batch, efb)
        if tcfg.grad_sync == "int8" and "pod" in mesh.shape:
            coll = pod_sync_bytes(leaves(params), mesh.shape["pod"])
    elif shape.kind == "prefill":
        fn, _, shardings_for = make_prefill_step(cfg, mesh, tcfg.attn_impl, device="meta")
        batch = make_batch(cfg, shape, as_spec=True)
        shardings_for(batch, shape.global_batch)
        mode.hold(params, batch)
        with mode:
            out = fn(params, **batch)
    else:
        fn, _, shardings_for = make_decode_step(cfg, mesh, kv_shard=kv_shard, device="meta")
        cache = cache_spec(cfg, shape, dtype=kv_dtype)
        toks = make_decode_tokens(cfg, shape, as_spec=True)
        shardings_for(cache, shape.global_batch)
        mode.hold(params, cache, toks)
        with mode:
            out = fn(params, cache, toks)
    return mode, out, coll


def lower_cell(arch: str, shape_name, multi_pod: bool, tcfg: TrainStepConfig,
               pad_heads: int = 0, kv_shard: str = "auto", kv_dtype=torch.bfloat16,
               param_dtype=torch.bfloat16) -> dict:
    """Build one cell's step and count one pass of it on ``meta``; returns
    the record. ``shape_name``: a key of ``SHAPES`` or a ``ShapeConfig``;
    ``param_dtype``: the params' dtype, bf16 as the reference's."""
    cfg = get_arch(arch)
    if pad_heads and cfg.has_attention and cfg.num_heads < pad_heads:
        # Deployment head-padding: extra zero-init heads make the q
        # projection shardable on the model axis; arch-equivalent at init.
        cfg = dataclasses.replace(cfg, num_heads=pad_heads, head_dim=cfg.resolved_head_dim)
    shape = _shape(shape_name)
    tag, mesh = MESHES[multi_pod]
    n_chips = 1
    dtype = param_dtype

    t0 = time.time()
    mode, out, coll = _run_one(cfg, shape, mesh, tcfg, dtype, kv_shard, kv_dtype)
    pass_s = time.time() - t0
    memory = mode.memory(out)
    del out

    record = {
        "arch": arch,
        "shape": shape.name,
        "mesh": tag,
        "chips": n_chips,
        "variant": tcfg_signature(tcfg, shape.kind),
        "param_dtype": str(dtype).removeprefix("torch."),
        "compile_seconds": round(pass_s, 1),
        "flops": float(mode.flops),
        "flops_3xtf32": float(mode.flops_3xtf32),
        "bytes_accessed": float(mode.bytes),
        "bytes_accessed_flash": float(mode.bytes),
        "bytes_accessed_flash_note": _FLASH_NOTE,
        "collective_bytes": coll["total"],
        "collective_breakdown": coll["by_kind"],
        "production_program_raw_cost": None,
        "aten_ops": mode.ops,
        "memory": memory,
        "fits_one_card": memory["peak_bytes"] <= HBM_BYTES,
        "model_flops_6nd": model_flops(cfg, shape),
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
    }
    record["peak_flops"] = pass_peak_flops(record["flops"], record["flops_3xtf32"], dtype)
    record["roofline"] = roofline_terms(
        flops=record["flops"],
        bytes_accessed=record["bytes_accessed_flash"],
        collective_bytes=record["collective_bytes"],
        chips=n_chips,
        peak_flops=record["peak_flops"],
    )
    record["roofline"]["memory_s_naive_upper"] = record["bytes_accessed"] / HBM_BW
    record["roofline"]["useful_flops_ratio"] = (
        record["model_flops_6nd"] / (record["flops"] * n_chips) if record["flops"] > 0 else None
    )
    return record


def model_flops(cfg, shape_name) -> float:
    """MODEL_FLOPS = 6·N_active·D tokens (train: ×1 fwd+bwd already in 6;
    decode: per-step tokens = batch)."""
    shape = _shape(shape_name)
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.tokens_per_step
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.tokens_per_step
    return 2.0 * n_active * shape.global_batch


def tcfg_signature(tcfg: TrainStepConfig, kind: str) -> str:
    if kind != "train":
        return f"{kind}:attn={tcfg.attn_impl}"
    return (
        f"train:mb={tcfg.microbatches},remat={tcfg.remat},"
        f"attn={tcfg.attn_impl},sync={tcfg.grad_sync}"
    )


def artifact_path(arch: str, shape_name: str, mesh_tag: str, variant: str) -> pathlib.Path:
    return ART_DIR / f"{arch}__{shape_name}__{mesh_tag}__{variant}.json"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="dots", choices=["none", "dots", "full"])
    ap.add_argument("--attn", default="blockwise", choices=["blockwise", "naive"])
    ap.add_argument("--grad-sync", default="native", choices=["native", "int8"])
    ap.add_argument("--pad-heads", type=int, default=0)
    ap.add_argument("--kv-shard", default="auto", choices=["auto", "heads", "seq"])
    ap.add_argument("--kv-dtype", default="bf16", choices=sorted(KV_DTYPES))
    ap.add_argument("--variant", default="baseline",
                    help="artifact filename tag for perf iterations")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    tcfg = TrainStepConfig(
        microbatches=args.microbatches, remat=args.remat,
        attn_impl=args.attn, grad_sync=args.grad_sync,
    )
    ART_DIR.mkdir(parents=True, exist_ok=True)

    n_ok = n_skip = n_fail = 0
    for arch in archs:
        cfg = get_arch(arch)
        for shape_name in shapes:
            ok, reason = shape_applicable(cfg, SHAPES[shape_name])
            for multi in meshes:
                mesh_tag = MESHES[multi][0]
                out = artifact_path(arch, shape_name, mesh_tag, args.variant)
                if out.exists() and not args.force:
                    print(f"[cached] {out.name}")
                    n_ok += 1
                    continue
                if not ok:
                    out.write_text(json.dumps(
                        {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                         "skipped": reason}, indent=1))
                    print(f"[skip]   {arch} × {shape_name} × {mesh_tag}: {reason}")
                    n_skip += 1
                    continue
                try:
                    t0 = time.time()
                    rec = lower_cell(arch, shape_name, multi, tcfg,
                                     pad_heads=args.pad_heads, kv_shard=args.kv_shard,
                                     kv_dtype=KV_DTYPES[args.kv_dtype])
                    out.write_text(json.dumps(rec, indent=1))
                    print(
                        f"[ok]     {arch} × {shape_name} × {mesh_tag}: "
                        f"pass={rec['compile_seconds']}s "
                        f"flops={rec['flops']:.3e} bytes={rec['bytes_accessed']:.3e} "
                        f"peak={rec['memory']['peak_bytes'] / 2**30:.2f}GiB "
                        f"coll={rec['collective_bytes']:.3e} "
                        f"(total {time.time() - t0:.0f}s)", flush=True,
                    )
                    n_ok += 1
                except Exception as e:  # noqa: BLE001 — record and continue
                    out.with_suffix(".FAILED.json").write_text(json.dumps(
                        {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                         "error": str(e), "trace": traceback.format_exc()}, indent=1))
                    print(f"[FAIL]   {arch} × {shape_name} × {mesh_tag}: {e}", flush=True)
                    n_fail += 1
    print(f"dry-run done: ok={n_ok} skip={n_skip} fail={n_fail}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
