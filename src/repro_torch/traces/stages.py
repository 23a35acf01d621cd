"""Shuffle-volume / selectivity traces for stage-structured jobs.

Production analytics mixes are stage-structured: a map/filter pass over
the input, one or more shuffle+reduce rounds, a small aggregation at the
end. Two numbers characterize each stage for the geo control plane:

* **selectivity** — output/input volume ratio. Filter-heavy map stages
  shrink data 3–30x (selectivity 0.03–0.3); join/expand stages can exceed
  1. Log-normal across a mix is the standard empirical fit.
* **compute share** — the fraction of the job's IT work the stage burns.

These generators draw padded (K, S) profiles for the K job types of a
scenario — depths, compute splits, selectivities — which
:mod:`repro_torch.jobs.dag` assembles into a
:class:`~repro_torch.jobs.dag.StageDag` (volumes via
``shuffle_volumes_from_selectivity``). Every draw comes from an explicit
``torch.Generator``, in the order the functions are called; tensors are made
on ``device`` (``None``: CUDA), which must be the generator's. The JAX
package draws from threefry keys, so the two agree by distribution, and
exactly in shapes, masks and clips.
"""

from __future__ import annotations

import torch
from torch import Tensor

from repro_torch.device import resolve_device

_EPS = 1e-6


def stage_depth_mask(
    generator: torch.Generator, k_types: int, s_max: int, min_stages: int = 2, device=None
) -> Tensor:
    """(K, S) monotone activity masks with uniform depths in [min, S].

    Every row is a prefix of ones — the padded-chain precedence contract
    of :class:`repro_torch.jobs.dag.StageDag`.
    """
    if not 1 <= min_stages <= s_max:
        raise ValueError(f"need 1 <= min_stages <= {s_max}, got {min_stages}")
    dev = resolve_device(device)
    depths = torch.randint(min_stages, s_max + 1, (k_types,), generator=generator, device=dev)
    return (torch.arange(s_max, device=dev)[None, :] < depths[:, None]).to(torch.float32)


def stage_compute_profile(
    generator: torch.Generator,
    mask: Tensor,
    conc: float = 12.0,
    map_weight: float = 0.8,
) -> Tensor:
    """(K, S) per-stage compute shares (active entries sum to 1 per row).

    Dirichlet over the active stages (normalised standard-gamma draws) with
    a mildly *down-weighted* map stage (``map_weight`` < 1): shuffle-heavy
    analytics burn most of their cycles in the reduce rounds, and a lean map
    stage keeps the data-local map placement stable (the map stage's
    effective service rate is ``mu / share``). Padded stages get the
    identity share 1.0. Drawn on ``mask``'s device.

    Args:
        generator: torch generator on ``mask``'s device.
        mask: (K, S) monotone activity mask.
        conc: Dirichlet concentration (larger = closer to the prior mix).
        map_weight: prior weight of stage 0 relative to the others.
    """
    k_types, s_max = mask.shape
    prior = torch.ones((s_max,), dtype=torch.float32, device=mask.device)
    prior[0] = map_weight
    alpha = (conc * prior)[None, :].expand(k_types, s_max).contiguous()
    gam = torch._standard_gamma(alpha, generator=generator) * mask
    shares = gam / torch.clamp_min(gam.sum(dim=1, keepdim=True), _EPS)
    return torch.where(mask > 0.5, shares, 1.0)


def selectivity_trace(
    generator: torch.Generator,
    k_types: int,
    s_max: int,
    log10_mean: float = -0.65,
    log10_std: float = 0.35,
    clip: tuple[float, float] = (0.02, 1.2),
    device=None,
) -> Tensor:
    """(K, S) per-stage selectivities (output/input ratio), log-normal.

    The default centers stages around ~0.22x shrink with occasional
    near-1 (shuffle-heavy joins) and deep filters. ``selectivity[k, s]`` is
    the ratio *out of* stage s, so the volume entering stage s is
    ``input_gb * prod_{u<s} selectivity[k, u]`` — see
    :func:`repro_torch.jobs.dag.shuffle_volumes_from_selectivity`.
    """
    dev = resolve_device(device)
    logs = log10_mean + log10_std * torch.randn((k_types, s_max), generator=generator, device=dev)
    return torch.clamp(10.0 ** logs, clip[0], clip[1])


def staged_mix_profile(
    generator: torch.Generator,
    k_types: int,
    s_max: int,
    min_stages: int = 2,
    conc: float = 12.0,
    map_weight: float = 0.8,
    log10_mean: float = -0.65,
    log10_std: float = 0.35,
    device=None,
) -> tuple[Tensor, Tensor, Tensor]:
    """Draw one scenario's full (mask, compute, selectivity) bundle.

    The three generators in turn on one generator; returns padded (K, S)
    tensors ready for :func:`repro_torch.jobs.dag.chain_dag` +
    :func:`repro_torch.jobs.dag.shuffle_volumes_from_selectivity`.
    """
    dev = resolve_device(device)
    mask = stage_depth_mask(generator, k_types, s_max, min_stages, device=dev)
    compute = stage_compute_profile(generator, mask, conc, map_weight)
    selectivity = selectivity_trace(generator, k_types, s_max, log10_mean, log10_std, device=dev)
    return mask, compute, selectivity
