"""The port's dry-run, roofline and kernel_bench against the JAX package's,
on the CPU.

* ``roofline_terms`` against ``repro.launch.roofline.roofline_terms`` given
  the same constants: the same float arithmetic, so exactly equal.
* ``model_flops`` and ``tcfg_signature`` against ``repro.launch.dryrun``'s
  for every arch x shape; ``pod_sync_bytes`` by kind against
  ``collective_bytes_from_hlo`` of the reference's ``compressed_psum_pod``
  compiled under ``shard_map`` on 2 and 4 XLA host devices. Importing
  ``repro.launch.dryrun`` sets ``XLA_FLAGS`` and the host devices exist
  only in a process that sets the flag before JAX starts, so one
  subprocess (with a timeout) makes every reference call; it starts in the
  background when this file's first test begins. Exact: counts of bytes
  and pure Python arithmetic.
* The cost count (``repro_torch.launch.cost.CostMode``) on ``meta`` equal
  to the count on real CPU tensors for a smoke train and prefill cell of a
  dense, an SSM and a MoE config: FLOPs, bytes and the four memory sizes
  exactly (the same ops see the same shapes). One layer's FLOPs equal to
  the hand sum of its products' 2·m·n·k, and at most the reference's
  ``cost_analysis()["flops"]`` of the same forward (L = 1, unrolled, naive
  attention), which counts elementwise work too.
* The peak tracker on a scripted sequence of allocations and frees, and
  ``as_kernel`` (a plain version counted as one kernel): exact.
* ``fmt_row`` against ``benchmarks.roofline.fmt_row`` on the same records:
  equal dicts.
* ``unroll_layers`` accepted and bitwise without effect.
* ``kernel_bench`` on the CPU (a subprocess, in the background): the rows
  of the reference's five benches with the ``plain`` arm timed and every
  ``kernel`` row skipped.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import pytest
import torch

import repro.configs as JC
from repro.launch import roofline as jroofline
from repro.models import lm as jlm
from repro_torch.benchmarks import roofline as troofline
from repro_torch.configs import SHAPES, ShapeConfig, get_arch, list_archs
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_scan_phases_ref
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.cost import CostMode, as_kernel
from repro_torch.models import lm
from repro_torch.models.inputs import make_batch, make_decode_tokens
from repro_torch.serve.step import make_decode_step, make_prefill_step
from repro_torch.train import TrainStepConfig, adamw_init, make_train_step
from repro_torch.train.optimizer import leaves

torch.set_float32_matmul_precision("highest")

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
REF_TIMEOUT = 300
#: Leaves for the int8 pod exchange: sizes 2 and 4 divide or do not.
POD_SHAPES = {"a": (5, 3), "b": (7,), "c": (4, 4), "d": (64, 33)}
TCFGS = [TrainStepConfig(), TrainStepConfig(microbatches=4, remat="full", attn_impl="naive",
                                            grad_sync="int8")]


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test: the suite runs files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The reference's calls, in background subprocesses
# ---------------------------------------------------------------------------

_REFERENCE_PROG = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, sys.argv[1])
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.distributed.compat import shard_map
    from repro.distributed.compression import compressed_psum_pod
    from repro.launch.roofline import collective_bytes_from_hlo

    out = {"pod": {}, "model_flops": {}, "sig": []}
    for n in (2, 4):
        mesh = jax.make_mesh((n,), ("pod",), devices=jax.devices()[:n])

        def one(leaf):
            total, resid = compressed_psum_pod(leaf[0], n, "pod")
            return total, resid[None]

        fn = jax.jit(shard_map(one, mesh=mesh, in_specs=P("pod"), out_specs=(P(), P("pod")),
                               check_vma=False))
        for name, shape in {SHAPES}.items():
            hlo = fn.lower(jax.ShapeDtypeStruct((n,) + shape, jnp.float32)).compile().as_text()
            out["pod"][f"{n}_{name}"] = collective_bytes_from_hlo(hlo)["by_kind"]

    # Sets XLA_FLAGS to 512 devices on import; the backend above is up.
    from repro.launch import dryrun
    from repro.configs import get_arch, list_archs
    from repro.configs.base import SHAPES
    from repro.train.step import TrainStepConfig
    for a in list_archs():
        out["model_flops"][a] = {s: dryrun.model_flops(get_arch(a), s) for s in SHAPES}
    for kw in {TCFGS}:
        out["sig"].append({k: dryrun.tcfg_signature(TrainStepConfig(**kw), k)
                           for k in ("train", "prefill", "decode")})
    json.dump(out, open(sys.argv[2], "w"))
""").replace("{SHAPES}", repr(POD_SHAPES)).replace("{TCFGS}", repr(
    [{f.name: getattr(t, f.name) for f in dataclasses.fields(t) if f.name != "optimizer"}
     for t in TCFGS]))

_KERNEL_BENCH_ARGS = ["-m", "repro_torch.benchmarks.kernel_bench", "--device", "cpu"]


class _Background:
    """A subprocess started once; ``result()`` waits for it (timeout) and
    returns its stdout, or the JSON it wrote."""

    def __init__(self, args, out: Path | None = None):
        self.out = out
        env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT / "src"),
               "OMP_NUM_THREADS": "1"}
        self.proc = subprocess.Popen([sys.executable, *args], stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, env=env, cwd=ROOT)
        self._data = None

    def result(self):
        if self._data is None:
            try:
                log, _ = self.proc.communicate(timeout=REF_TIMEOUT)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.communicate()
                pytest.fail(f"the subprocess took over {REF_TIMEOUT} s")
            assert self.proc.returncode == 0, log.decode()[-4000:]
            self._data = json.loads(self.out.read_text()) if self.out else log.decode()
        return self._data

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def background(tmp_path_factory):
    out = tmp_path_factory.mktemp("reference") / "reference.json"
    runs = {"reference": _Background(["-c", _REFERENCE_PROG, str(ROOT / "src"), str(out)], out),
            "kernel_bench": _Background(_KERNEL_BENCH_ARGS)}
    yield runs
    for run in runs.values():
        run.close()


# ---------------------------------------------------------------------------
# Roofline terms, model FLOPs, signatures, the pod exchange's bytes
# ---------------------------------------------------------------------------

def test_h100_constants_and_peaks():
    assert (roofline.PEAK_FLOPS_FP32, roofline.PEAK_FLOPS_TF32, roofline.PEAK_FLOPS_BF16) == \
           (67e12, 495e12, 989e12)
    assert (roofline.HBM_BW, roofline.NVLINK_BW, roofline.HBM_BYTES) == (3.35e12, 900e9, 80e9)
    assert roofline.PEAK_FLOPS == roofline.peak_flops_for(torch.float32) == 67e12
    assert roofline.peak_flops_for(torch.bfloat16) == roofline.peak_flops_for(torch.float16)
    assert roofline.peak_flops_for("tf32") == 495e12
    with pytest.raises(ValueError, match="no H100 peak"):
        roofline.peak_flops_for(torch.float64)


@pytest.mark.parametrize("flops,nbytes,coll", [(4.2e13, 1.1e12, 0.0), (1e9, 5e12, 3e9),
                                                (0.0, 0.0, 0.0), (7e15, 1e10, 5e13)])
@pytest.mark.parametrize("peak", [roofline.PEAK_FLOPS_FP32, roofline.PEAK_FLOPS_BF16])
def test_roofline_terms_match_the_reference(flops, nbytes, coll, peak):
    kw = dict(peak_flops=peak, hbm_bw=roofline.HBM_BW, ici_bw=roofline.ICI_BW)
    want = jroofline.roofline_terms(flops, nbytes, coll, 1, **kw)
    assert roofline.roofline_terms(flops, nbytes, coll, 1, **kw) == want
    assert roofline.roofline_terms(flops, nbytes, coll, 1, peak_flops=peak) == want


def test_model_flops_and_signatures_match_the_reference(background):
    ref = background["reference"].result()
    assert sorted(ref["model_flops"]) == list_archs()
    for arch in list_archs():
        cfg = get_arch(arch)
        assert {s: dryrun.model_flops(cfg, s) for s in SHAPES} == ref["model_flops"][arch], arch
    for tcfg, sigs in zip(TCFGS, ref["sig"]):
        assert {k: dryrun.tcfg_signature(tcfg, k) for k in sigs} == sigs


@pytest.mark.parametrize("n", [2, 4])
def test_pod_sync_bytes_match_the_compiled_reference(background, n):
    ref = background["reference"].result()["pod"]
    for name, shape in POD_SHAPES.items():
        got = roofline.pod_sync_bytes([shape], n)
        assert got["by_kind"] == ref[f"{n}_{name}"], (n, name)
        assert got["total"] == sum(ref[f"{n}_{name}"].values())
    tensors = [torch.empty(s, device="meta") for s in POD_SHAPES.values()]
    whole = roofline.pod_sync_bytes(tensors, n)
    assert whole["total"] == sum(roofline.pod_sync_bytes([s], n)["total"]
                                 for s in POD_SHAPES.values())


# ---------------------------------------------------------------------------
# The cost count: meta against real tensors, by hand, against XLA
# ---------------------------------------------------------------------------

def _real_params(cfg, dtype):
    return lm.init_params(cfg, torch.Generator().manual_seed(0), dtype, CPU)


def _count_cpu(cfg, shape: ShapeConfig, tcfg: TrainStepConfig, dtype):
    """The dry-run's pass on real CPU tensors (what ``dryrun._run_one``
    does on meta): (the mode, its memory sizes)."""
    gen = torch.Generator().manual_seed(1)
    mode = CostMode()
    params = _real_params(cfg, dtype)
    batch = make_batch(cfg, shape, gen, device=CPU)
    if shape.kind == "train":
        step, init_efb = make_train_step(cfg, tcfg, device=CPU, mesh=dryrun.MESHES[False][1])
        opt, efb = adamw_init(params), init_efb(params)
        mode.hold(params, opt, batch, efb)
        with mode:
            out = step(params, opt, batch, efb)
    else:
        fn, _, _ = make_prefill_step(cfg, dryrun.MESHES[False][1], tcfg.attn_impl, device=CPU)
        mode.hold(params, batch)
        chunk = min(cfg.ssm_chunk, shape.seq_len)
        as_kernel = ssd_ops.as_kernel

        def chained(plain, *args):
            # The CPU's own prefill runs the sequential recurrence; meta runs
            # the CUDA chain's algorithm (ssd_scan_phases_ref): count that on
            # both, as the meta branch calls it.
            if plain is ssd_ops.ssd_scan_ref:
                return as_kernel(ssd_scan_phases_ref, *args, chunk)[:2]
            return as_kernel(plain, *args)

        with mock.patch.object(ssd_ops, "as_kernel", chained), mode:
            out = fn(params, **batch)
    return mode, mode.memory(out)


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-2.7b", "deepseek-moe-16b"])
def test_meta_count_equals_the_count_on_real_tensors(arch, kind):
    cfg = get_arch(arch, "smoke")
    shape = ShapeConfig(f"smoke_{kind}", kind, 48, 4)
    tcfg = TrainStepConfig(microbatches=2, remat="full")
    dtype = torch.bfloat16   # every cell's dtype, as the reference's
    meta, out, coll = dryrun._run_one(cfg, shape, dryrun.MESHES[False][1], tcfg, dtype,
                                      "auto", torch.bfloat16)
    real, mem = _count_cpu(cfg, shape, tcfg, dtype)
    assert meta.flops > 0 and meta.bytes > 0 and coll == {"total": 0.0, "by_kind": {}}
    assert (meta.flops, meta.bytes) == (real.flops, real.bytes)
    assert meta.memory(out) == mem
    assert mem["peak_bytes"] >= mem["argument_bytes"] + mem["temp_bytes"] > mem["argument_bytes"]


def _one_layer(arch):
    cfg = dataclasses.replace(get_arch(arch, "smoke"), num_layers=1)
    cfg_j = dataclasses.replace(JC.get_arch(arch, "smoke"), num_layers=1)
    return cfg, cfg_j


def test_one_layer_flops_by_hand_and_against_the_reference_cost_analysis():
    cfg, cfg_j = _one_layer("qwen2-0.5b")
    b, s = 2, 40
    t, d, hd = b * s, cfg.d_model, cfg.resolved_head_dim
    h, hkv, f, vp = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff, lm.padded_vocab(cfg)
    by_hand = (2 * t * d * (h + 2 * hkv) * hd      # q, k, v
               + 2 * t * h * hd * d                # o
               + 2 * 2 * b * h * s * s * hd        # scores and probs @ v
               + 3 * 2 * t * d * f                 # gate, up, down
               + 2 * t * d * vp)                   # the (tied) head
    params = _real_params(cfg, torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=torch.Generator().manual_seed(3))
    mode = CostMode()
    with mode:
        lm.forward(params, cfg, tokens, attn_impl="naive", unroll_layers=True)
    assert mode.flops == by_hand

    p_j = jlm.init_params(jax.random.key(0), cfg_j, jnp.float32)
    cost = jax.jit(lambda p, x: jlm.forward(p, cfg_j, x, attn_impl="naive", unroll_layers=True)
                   ).lower(p_j, jnp.asarray(tokens.numpy(), jnp.int32)).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    assert by_hand <= cost["flops"]


def test_peak_tracker_on_a_scripted_sequence():
    meta = lambda n: torch.empty(n, dtype=torch.float32, device="meta")
    held = meta(100)                                   # 400 B, an argument
    mode = CostMode()
    mode.hold({"x": held, "again": held[10:]})         # a view: one storage
    with mode:
        a = held + 1                                   # +400 -> 800
        b = torch.ones(300, device="meta")             # +1200 -> 2000
        v = b.view(3, 100)                             # a view: nothing
        a.add_(1)                                      # in place: nothing
        del b                                          # v keeps b's storage
        c = held * 2                                   # +400 -> 2400 (the peak)
        del v, a                                       # -1600 -> 800
        d = c.sum()                                    # +4 -> 804
    assert mode.argument_bytes == 400
    assert mode.peak_bytes == 2400 and mode.live_bytes == 804
    assert mode.memory((d, held)) == {"argument_bytes": 400, "output_bytes": 404,
                                      "temp_bytes": 2400 - 400 - 4, "peak_bytes": 2400}
    del c
    assert mode.live_bytes == 404
    # bytes moved: add (400 in, 400 out), ones (1200 out), add_ (400 + 400),
    # mul (400 + 400), sum (400 + 4); views move nothing.
    assert mode.bytes == 800 + 1200 + 800 + 800 + 404


def test_as_kernel_counts_a_plain_version_as_one_kernel():
    """A kernel's plain version under as_kernel: its products' FLOPs, one
    op's bytes (the arguments and the returned tensors), and alive after it
    only what it returns; without a CostMode, the plain call."""
    meta = lambda *shape: torch.empty(shape, dtype=torch.float32, device="meta")
    x, w = meta(8, 16), meta(16, 32)

    def plain(x, w, k):
        tmp = (x @ w) * k              # a (8, 32) temporary
        return tmp.sum(dim=1), tmp.amax(dim=1)

    mode = CostMode()
    mode.hold(x, w)
    with mode:
        y, z = as_kernel(plain, x, w, 2.0)
    assert mode.flops == 2 * 8 * 16 * 32
    assert mode.bytes == (8 * 16 + 16 * 32 + 8 + 8) * 4
    assert mode.peak_bytes == mode.live_bytes == (8 * 16 + 16 * 32 + 8 + 8) * 4
    assert [t.shape for t in as_kernel(plain, x, w, 2.0)] == [(8,), (8,)]


# ---------------------------------------------------------------------------
# Specs on meta, ssd_scan on meta, the dry-run's cells
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_param_structs_and_specs_mirror_the_real_trees(arch):
    cfg = get_arch(arch, "smoke")
    for dtype in (torch.float32, torch.bfloat16):
        real, spec = _real_params(cfg, dtype), lm.param_structs(cfg, dtype)
        assert [(x.shape, x.dtype) for x in leaves(spec)] == \
               [(x.shape, x.dtype) for x in leaves(real)]
        assert all(x.is_meta for x in leaves(spec))
    assert adamw_init(spec)["m"]["embed"].is_meta
    gen = torch.Generator().manual_seed(0)
    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig(kind, kind, 24, 2)
        if kind == "decode":
            want = make_decode_tokens(cfg, shape, gen, device=CPU)
            got = make_decode_tokens(cfg, shape, as_spec=True)
            assert (got.shape, got.dtype, got.is_meta) == (want.shape, want.dtype, True)
            continue
        want, got = make_batch(cfg, shape, gen, device=CPU), make_batch(cfg, shape, as_spec=True)
        assert {k: (v.shape, v.dtype) for k, v in got.items()} == \
               {k: (v.shape, v.dtype) for k, v in want.items()}
        assert all(v.is_meta for v in got.values())
    with pytest.raises(ValueError, match="generator"):
        make_batch(cfg, ShapeConfig("p", "prefill", 8, 2), device=CPU)


def test_ssd_scan_on_meta_takes_the_chain_with_and_without_grad():
    b, s, h, p, n = 2, 40, 3, 8, 16
    ops = [torch.empty(sh, device="meta") for sh in ((b, s, h, p), (b, s, h), (h,),
                                                      (b, s, n), (b, s, n))]
    y, state = ssd_ops.ssd_scan(*ops, chunk=16)
    assert (y.shape, state.shape, y.is_meta) == ((b, s, h, p), (b, h, p, n), True)
    x = ops[0].requires_grad_()
    y, _ = ssd_ops.ssd_scan(x, *ops[1:], chunk=16)
    (dx,) = torch.autograd.grad(y.sum(), x)
    assert dx.shape == x.shape and dx.is_meta


def test_int8_pod_cell_counts_the_exchange():
    cfg = get_arch("qwen2-0.5b", "smoke")
    shape = ShapeConfig("smoke_train", "train", 16, 4)
    mode, out, coll = dryrun._run_one(cfg, shape, dryrun.MESHES[True][1],
                                      TrainStepConfig(grad_sync="int8"), torch.float32,
                                      "auto", torch.bfloat16)
    assert coll == roofline.pod_sync_bytes(leaves(out[0]), 2)
    assert set(coll["by_kind"]) == {"all-to-all", "all-gather"} and mode.flops > 0
    efb = out[3]
    assert all(e.shape[0] == 2 and e.is_meta for e in leaves(efb))


def test_dryrun_main_writes_the_cells(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "ART_DIR", tmp_path)
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "mamba2-2.7b", "--shape", "long_500k", "--mesh", "both"])
    assert done.value.code == 0
    recs = {p.name: json.loads(p.read_text()) for p in tmp_path.glob("*.json")}
    assert sorted(recs) == ["mamba2-2.7b__long_500k__1x1__baseline.json",
                            "mamba2-2.7b__long_500k__2x1x1__baseline.json"]
    rec = recs["mamba2-2.7b__long_500k__1x1__baseline.json"]
    for key in ("flops", "bytes_accessed", "bytes_accessed_flash", "collective_bytes",
                "collective_breakdown", "model_flops_6nd", "params_total", "params_active",
                "compile_seconds", "fits_one_card", "param_dtype"):
        assert key in rec, key
    assert rec["production_program_raw_cost"] is None and rec["chips"] == 1
    assert rec["bytes_accessed_flash"] == rec["bytes_accessed"] > 0
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes"}
    assert {"useful_flops_ratio", "memory_s_naive_upper", "step_time_s", "dominant"} <= \
           set(rec["roofline"])
    assert rec["param_dtype"] == "bfloat16" and rec["fits_one_card"] is True
    assert rec["params_total"] == get_arch("mamba2-2.7b").param_count()
    # An inapplicable cell is written as skipped; a failing one as .FAILED.
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "qwen2-0.5b", "--shape", "long_500k", "--mesh", "single"])
    assert done.value.code == 0
    skipped = json.loads((tmp_path / "qwen2-0.5b__long_500k__1x1__baseline.json").read_text())
    assert skipped["skipped"] == "full quadratic attention: 500k context inapplicable"
    with mock.patch.object(dryrun, "lower_cell", side_effect=RuntimeError("boom")), \
            pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "hymba-1.5b", "--shape", "decode_32k", "--mesh", "single"])
    assert done.value.code == 1
    failed = json.loads((tmp_path / "hymba-1.5b__decode_32k__1x1__baseline.FAILED.json")
                        .read_text())
    assert failed["error"] == "boom"


def test_roofline_table_matches_the_reference_rows(tmp_path, monkeypatch):
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks import roofline as bench_ref
    finally:
        sys.path.remove(str(ROOT))
    dry = tmp_path / "dry"
    dry.mkdir()
    monkeypatch.setattr(troofline, "DRY", dry)
    monkeypatch.setattr(troofline, "ART", tmp_path)
    with pytest.raises(FileNotFoundError, match="no usable dry-run records"):
        troofline.tabulate("baseline")
    rec = dryrun.lower_cell("mamba2-2.7b", "long_500k", False, TrainStepConfig())
    skipped = {"arch": "qwen2-0.5b", "shape": "long_500k", "mesh": "1x1", "skipped": "why"}
    for name, r in (("a__baseline.json", rec), ("b__baseline.json", skipped)):
        (dry / name).write_text(json.dumps(r))
    for r in (rec, skipped):
        assert troofline.fmt_row(r) == bench_ref.fmt_row(r)
    rows, record = troofline.tabulate("baseline")
    assert [r["status"] for r in rows] == ["ok", "skipped: why"]
    assert record["name"] == "roofline_table_baseline" and record["us_per_call"] == 0.0
    assert record["derived"]["cells"] == 1.0
    csv = (tmp_path / "roofline_torch_baseline.csv").read_text().splitlines()
    assert csv[0].split(",") == troofline.COLS and len(csv) == 2
    md = (tmp_path / "roofline_torch_baseline.md").read_text().splitlines()
    assert len(md) == 4 and "skipped: why" in md[3]


# ---------------------------------------------------------------------------
# unroll_layers, kernel_bench
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-2.7b"])
def test_unroll_layers_changes_nothing(arch):
    cfg = get_arch(arch, "smoke")
    params = _real_params(cfg, torch.float32)
    gen = torch.Generator().manual_seed(2)
    batch = make_batch(cfg, ShapeConfig("t", "train", 24, 2), gen, device=CPU,
                       embed_dtype=torch.float32)
    mesh = dryrun.MESHES[False][1]
    with torch.no_grad():
        outs = {}
        for unroll in (False, True):
            logits, aux = lm.forward(params, cfg, batch["tokens"], unroll_layers=unroll)
            loss, _ = lm.loss_fn(params, cfg, batch, unroll_layers=unroll)
            last, cache = lm.prefill_step(params, cfg, batch["tokens"], unroll_layers=unroll)
            step, _ = lm.decode_step(params, cfg, cache, batch["tokens"][:, :1],
                                     unroll_layers=unroll)
            fn, _, _ = make_prefill_step(cfg, mesh, unroll_layers=unroll, device=CPU)
            served, _ = fn(params, tokens=batch["tokens"])
            dec, _, _ = make_decode_step(cfg, mesh, unroll_layers=unroll, device=CPU)
            decoded, _ = dec(params, cache, batch["tokens"][:, :1])
            outs[unroll] = [logits, aux, loss, last, step, served, decoded] + leaves(cache)
    assert all(torch.equal(a, b) for a, b in zip(outs[False], outs[True]))


def test_kernel_bench_on_the_cpu_times_plain_and_skips_the_kernel(background):
    csv = re.compile(r"^[\w.]+,-?[0-9.]+,")
    lines = [line.split(",", 2) for line in background["kernel_bench"].result().splitlines()
             if csv.match(line)]
    rows = {name: (float(us), derived) for name, us, derived in lines}
    # The reference's rows (jnp / interpret / compiled arms) as the port's:
    # gmsa_score_ref and ssd_scan_ref are ``plain``, the hoisted table and
    # ssd_chunked ``einsum``, the compiled kernel ``kernel``.
    assert list(rows) == [
        "gmsa_dispatch_plain_K1_N4", "gmsa_dispatch_kernel_K1_N4",
        "gmsa_dispatch_plain_K16_N64", "gmsa_dispatch_kernel_K16_N64",
        "gmsa_dispatch_plain_K128_N1024", "gmsa_dispatch_kernel_K128_N1024",
        "gmsa_matrix_einsum_N256_K8", "gmsa_matrix_plain_N256_K8", "gmsa_matrix_kernel_N256_K8",
        "fleet256_e2e_ref_T48", "fleet256_e2e_kernel_T48",
        "ssd_chunked_einsum_mamba2_layer_S2048", "ssd_chunked_kernel_mamba2_layer_S2048",
        "ssd_matrix_einsum_S256_H2", "ssd_matrix_plain_S256_H2", "ssd_matrix_kernel_S256_H2",
    ]
    for name, (us, derived) in rows.items():
        if "_kernel_" in name and not name.startswith("fleet"):
            assert us == 0.0 and "status=skipped_no_cuda" in derived, name
        else:
            assert us > 0.0 and "skipped" not in derived, name
    assert "agree=1.0000" in rows["gmsa_matrix_plain_N256_K8"][1]
    assert "dispatch_agreement=1.0000" in rows["fleet256_e2e_kernel_T48"][1]
