"""Carry the JAX package's state into the port.

* The simulator's "parameters" are the trace bundle: a ``SimInputs``-shaped
  bundle of numpy arrays (a mapping or an object with the fields as
  attributes — a caller converts framework arrays with ``np.asarray``
  first) becomes the port's :class:`SimInputs`, and per-run bundles stack
  into the port's leading runs axis.
* A stage chain (``repro.jobs.dag.StageDag``) and a WAN model
  (``repro.placement.wan.WanModel``), fields as numpy arrays, become the
  port's :class:`~repro_torch.jobs.dag.StageDag` / :class:`WanModel`.
* A serving scenario (``repro.serve.engine.ServeScenario``: the trace
  bundle, the prefill → decode chain, the WAN model and the admission and
  routing arrays, each as numpy) becomes the port's
  :class:`~repro_torch.serve.engine.ServeScenario`.
* A model's parameter pytree (``repro.models.lm.init_params``, leaves
  through ``np.asarray``) and its decode cache (a KV ring, an SSM state, or
  both) become the port's dicts of tensors, checked leaf for leaf against
  the port's specs; so do an AdamW state (m and v under the params'
  names, and the step) and a training batch (tokens, labels, loss_mask,
  prefix_embeds), so that a JAX training state carries over whole.

Random streams do not carry across (counter-based threefry on one side,
torch generators on the other), so end-to-end parity runs both engines on
the same bridged traces.
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.simulator import SimInputs
from repro_torch.device import resolve_device
from repro_torch.jobs.dag import StageDag
from repro_torch.models.lm import _ssm_dims, layer_param_specs, top_param_specs
from repro_torch.placement.wan import WanModel
from repro_torch.serve.engine import ServeScenario

#: Fields that carry the Monte-Carlo randomness; the rest are shared by runs.
STOCHASTIC_FIELDS = ("arrivals", "mu")


def sim_inputs_from_numpy(fields, device=None) -> SimInputs:
    """numpy ``SimInputs`` fields -> the port's ``SimInputs`` on ``device``
    (``None``: CUDA), every field cast to float32 (numpy float64 would
    otherwise survive ``torch.from_numpy``)."""
    dev = resolve_device(device)
    out = {}
    for name in SimInputs._fields:
        x = fields[name] if isinstance(fields, Mapping) else getattr(fields, name)
        if not isinstance(x, np.ndarray):
            raise TypeError(
                f"field {name!r} is {type(x).__name__}, not a numpy array; "
                "convert with np.asarray first"
            )
        out[name] = torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)
    return SimInputs(**out)


def _fields_f32(what: str, names, fields, shapes: dict, dev: torch.device):
    """numpy fields ``names`` of ``what`` -> fp32 tensors on ``dev``, each
    checked against its expected shape (``None`` skips the check)."""
    out = {}
    for name in names:
        x = fields[name] if isinstance(fields, Mapping) else getattr(fields, name)
        if not isinstance(x, np.ndarray):
            raise TypeError(
                f"{what} field {name!r} is {type(x).__name__}, not a numpy "
                "array; convert with np.asarray first"
            )
        if not np.issubdtype(x.dtype, np.floating):
            raise TypeError(f"{what} field {name!r} has dtype {x.dtype}, not a float")
        want = shapes[name]
        if want is not None and tuple(x.shape) != want:
            raise ValueError(
                f"{what} field {name!r} has shape {tuple(x.shape)}, expected {want}"
            )
        out[name] = torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)
    return out


def dag_from_numpy(fields, device=None) -> StageDag:
    """numpy ``StageDag`` fields (``compute``, ``shuffle_gb``,
    ``stage_mask``, all (K, S) floats) -> the port's :class:`StageDag` on
    ``device`` (``None``: CUDA), cast to float32."""
    dev = resolve_device(device)
    compute = fields["compute"] if isinstance(fields, Mapping) else fields.compute
    ks = tuple(np.shape(compute))
    if len(ks) != 2:
        raise ValueError(f"StageDag field 'compute' has shape {ks}, expected (K, S)")
    return StageDag(**_fields_f32("StageDag", StageDag._fields, fields,
                                  dict.fromkeys(StageDag._fields, ks), dev))


def wan_from_numpy(fields, device=None) -> WanModel:
    """numpy ``WanModel`` fields (``up``/``down`` (N,), ``link_bw`` (N, N),
    ``energy_per_gb`` 0-d) -> the port's :class:`WanModel` on ``device``
    (``None``: CUDA), cast to float32."""
    dev = resolve_device(device)
    up = fields["up"] if isinstance(fields, Mapping) else fields.up
    n = tuple(np.shape(up))
    if len(n) != 1:
        raise ValueError(f"WanModel field 'up' has shape {n}, expected (N,)")
    shapes = {"up": n, "down": n, "link_bw": n + n, "energy_per_gb": ()}
    return WanModel(**_fields_f32("WanModel", WanModel._fields, fields, shapes, dev))


def serve_scenario_from_numpy(fields, device=None) -> ServeScenario:
    """A numpy ``ServeScenario`` -> the port's on ``device`` (``None``:
    CUDA), every array fp32.

    ``fields`` maps (or carries as attributes) ``inputs`` (``SimInputs``
    fields), ``dag`` (``StageDag`` fields), ``wan`` (``WanModel`` fields)
    and the arrays ``raw_arrivals``/``rejected`` (T, K), ``layout`` (K, N)
    and ``reads`` (K, N, N); each shape is checked against the inputs'.
    """
    dev = resolve_device(device)
    get = lambda name: fields[name] if isinstance(fields, Mapping) else getattr(fields, name)
    inputs = sim_inputs_from_numpy(get("inputs"), dev)
    t_slots, n, k = inputs.mu.shape
    shapes = {"raw_arrivals": (t_slots, k), "rejected": (t_slots, k), "layout": (k, n),
              "reads": (k, n, n)}
    arrays = _fields_f32("ServeScenario", shapes, fields, shapes, dev)
    return ServeScenario(inputs=inputs, dag=dag_from_numpy(get("dag"), dev),
                         wan=wan_from_numpy(get("wan"), dev), **arrays)


def stack_runs(runs: Sequence[SimInputs]) -> SimInputs:
    """Stack single-run bundles on a leading runs axis of arrivals and mu.

    The shared fields must be identical across runs (they are closed over
    by the Monte-Carlo builders); a mismatch raises.
    """
    if not runs:
        raise ValueError("stack_runs needs at least one run")
    first = runs[0]
    for i, run in enumerate(runs[1:], start=1):
        for name in SimInputs._fields:
            if name in STOCHASTIC_FIELDS:
                continue
            if not torch.equal(getattr(run, name), getattr(first, name)):
                raise ValueError(f"run {i} differs from run 0 in shared field {name!r}")
    return first._replace(**{
        name: torch.stack([getattr(run, name) for run in runs])
        for name in STOCHASTIC_FIELDS
    })


_ML_DTYPES = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn,
              "float8_e5m2": torch.float8_e5m2}


def _leaf(name: str, x, shape: tuple, dev: torch.device) -> torch.Tensor:
    if not isinstance(x, np.ndarray):
        raise TypeError(f"leaf {name!r} is {type(x).__name__}, not a numpy array; "
                        "convert with np.asarray first")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"leaf {name!r} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if x.dtype.name in _ML_DTYPES:     # ml_dtypes' types: no torch.from_numpy (exact via fp32)
        return torch.from_numpy(x.astype(np.float32)).to(dev, _ML_DTYPES[x.dtype.name])
    return torch.from_numpy(np.array(x)).to(dev)


def _check_names(what: str, got, want) -> None:
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"{what}: missing leaves {missing}, unexpected leaves {extra}")


def lm_params_from_numpy(tree: Mapping, cfg: ModelConfig, device=None) -> dict:
    """A JAX ``init_params`` pytree (numpy leaves) -> the port's params dict
    on ``device`` (``None``: CUDA). Every name and shape is checked against
    the port's ``top_param_specs`` / ``layer_param_specs`` (blocks stacked
    on L); a missing or extra leaf raises. Leaf dtypes are kept."""
    dev = resolve_device(device)
    tspecs, lspecs = top_param_specs(cfg), layer_param_specs(cfg)
    _check_names("params", tree, list(tspecs) + ["blocks"])
    _check_names("params['blocks']", tree["blocks"], lspecs)
    out = {name: _leaf(name, tree[name], shape, dev) for name, (shape, _, _) in tspecs.items()}
    out["blocks"] = {
        name: _leaf(f"blocks/{name}", tree["blocks"][name], (cfg.num_layers,) + shape, dev)
        for name, (shape, _, _) in lspecs.items()
    }
    return out


def opt_state_from_numpy(tree: Mapping, cfg: ModelConfig, device=None) -> dict:
    """A JAX ``adamw_init`` / ``adamw_update`` state (numpy leaves: m and v
    shaped as the params, step an int scalar) -> the port's state on
    ``device`` (``None``: CUDA): m and v checked as
    :func:`lm_params_from_numpy` checks params, step int32."""
    _check_names("opt_state", tree, ["m", "v", "step"])
    dev = resolve_device(device)
    step = np.asarray(tree["step"])
    if step.shape != ():
        raise ValueError(f"opt_state step has shape {step.shape}, expected a scalar")
    return {"m": lm_params_from_numpy(tree["m"], cfg, dev),
            "v": lm_params_from_numpy(tree["v"], cfg, dev),
            "step": torch.tensor(int(step), dtype=torch.int32, device=dev)}


_BATCH_DTYPES = {"tokens": torch.int64, "labels": torch.int64, "loss_mask": torch.float32}


def batch_from_numpy(batch: Mapping, device=None) -> dict:
    """A training batch (numpy: tokens and labels int, loss_mask float,
    optional prefix_embeds) -> tensors on ``device`` (``None``: CUDA):
    token ids and labels int64 (the port's index type), loss_mask fp32,
    prefix_embeds in its own dtype (bf16 too). Other keys raise."""
    dev = resolve_device(device)
    extra = sorted(set(batch) - set(_BATCH_DTYPES) - {"prefix_embeds"})
    if extra:
        raise ValueError(f"batch: unexpected keys {extra}")
    out = {}
    for name, x in batch.items():
        if not isinstance(x, np.ndarray):
            raise TypeError(f"batch[{name!r}] is {type(x).__name__}, not a numpy array; "
                            "convert with np.asarray first")
        t = _leaf(name, x, x.shape, dev)
        out[name] = t.to(_BATCH_DTYPES[name]) if name in _BATCH_DTYPES else t
    return out


def cache_from_numpy(tree: Mapping, cfg: ModelConfig, device=None) -> dict:
    """A JAX decode cache (``prefill_step`` / ``init_cache``, numpy leaves)
    -> the port's cache dict on ``device`` (``None``: CUDA), names and
    shapes checked by family: ``k``/``v`` (L, B, sc, Hkv, hd) for attention
    (any ring size ``sc``), ``ssm_state``/``conv_state`` for SSM layers;
    ``pos`` becomes int32. Leaf dtypes are kept (bf16 and float8 too)."""
    dev = resolve_device(device)
    want = ["pos"] + (["k", "v"] if cfg.has_attention else []) + (
        ["ssm_state", "conv_state"] if cfg.has_ssm else [])
    _check_names("cache", tree, want)
    b = np.shape(tree["pos"])[0] if np.ndim(tree["pos"]) == 1 else -1
    shapes = {"pos": (b,)}
    if cfg.has_attention:
        sc = np.shape(tree["k"])[2] if np.ndim(tree["k"]) == 5 else -1
        shapes["k"] = shapes["v"] = (cfg.num_layers, b, sc, cfg.num_kv_heads,
                                     cfg.resolved_head_dim)
    if cfg.has_ssm:
        dims = _ssm_dims(cfg)
        shapes["ssm_state"] = (cfg.num_layers, b, dims["heads"], cfg.ssm_head_dim, dims["n"])
        shapes["conv_state"] = (cfg.num_layers, b, cfg.ssm_conv_width - 1, dims["conv_dim"])
    out = {name: _leaf(name, tree[name], shape, dev) for name, shape in shapes.items()}
    out["pos"] = out["pos"].to(torch.int32)
    return out
