"""Padded stage-DAG representation of geo-analytics jobs.

The paper's fine-grained paradigm (Sec. III) decomposes an analytics job
into map tasks at the data sites, an intermediate-data transfer over the
WAN, and aggregation at the global manager — a *chain of stages* with data
shrinking (or occasionally growing) at each hop. The base simulator
collapses this structure into a single dispatch fraction per job; the
:mod:`repro_torch.jobs` subsystem makes it first-class.

A :class:`StageDag` describes the per-type stage chain in three padded
(K, S) tensors — S is the maximum stage count over the K job types, shorter
chains are padded with identity stages and masked out:

* ``compute[k, s]``   — compute intensity of stage s (fraction of the
  job's total IT work P^k; active rows typically sum to 1). A stage with
  intensity c consumes service capacity at rate c — its effective service
  rate is ``mu / c`` — and bills ``c * e[k, i]`` per job at its chosen
  site.
* ``shuffle_gb[k, s]`` — GB of input data a type-k job must feed *into*
  stage s. For s = 0 this is the map stage's remote-input pull (zero under
  the paper's data-local-map premise); for s > 0 it is the intermediate
  (shuffle) volume produced by stage s-1.
* ``stage_mask[k, s]`` — 1.0 while the chain is active, then 0.0. Masks
  are monotone (a prefix of ones): precedence is the linear chain
  s -> s+1.

Volumes are conveniently derived from *selectivities* (output/input volume
ratio per stage): ``shuffle_gb[k, s] = input_gb[k] * prod_{u<s}
selectivity[k, u]`` — see :func:`shuffle_volumes_from_selectivity` and the
trace generators in :mod:`repro_torch.traces.stages`.

Builders from Python data take ``device=None``, which means CUDA; tensors
given to :func:`chain_dag` stay on their device unless ``device`` is named.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch import Tensor

from repro_torch.device import as_float32, resolve_device


class StageDag(NamedTuple):
    """Padded stage-chain description of K job types (shapes (K, S)).

    Attributes:
        compute: per-stage compute intensity (fraction of P^k; padded 1.0).
        shuffle_gb: GB entering each stage per job (padded 0.0).
        stage_mask: {0, 1} activity mask, monotone non-increasing per row.
    """

    compute: Tensor
    shuffle_gb: Tensor
    stage_mask: Tensor

    @property
    def k_types(self) -> int:
        return self.compute.shape[0]

    @property
    def s_max(self) -> int:
        return self.compute.shape[1]

    @property
    def n_stages(self) -> Tensor:
        """(K,) number of active stages per job type."""
        return self.stage_mask.sum(dim=1).to(torch.int32)


def chain_dag(
    compute: Tensor | Sequence,
    shuffle_gb: Tensor | Sequence,
    stage_mask: Tensor | Sequence | None = None,
    device=None,
) -> StageDag:
    """Build a :class:`StageDag` from (K, S) arrays, normalizing dtypes.

    ``stage_mask`` defaults to all-active. Padded (masked-out) entries are
    forced to the identity values — compute 1.0 (so the padded stage's
    effective service rate stays finite) and shuffle 0.0 — regardless of
    what the caller put there, keeping the engine's arithmetic on dead
    stages exact no-ops.
    """
    compute = as_float32(compute, device)
    dev = compute.device
    shuffle_gb = as_float32(shuffle_gb, dev)
    stage_mask = torch.ones_like(compute) if stage_mask is None else as_float32(stage_mask, dev)
    live = stage_mask > 0.5
    compute = torch.where(live, compute, 1.0)
    shuffle_gb = torch.where(live, shuffle_gb, 0.0)
    return StageDag(compute, shuffle_gb, stage_mask)


def single_stage_dag(k_types: int, device=None) -> StageDag:
    """The trivial one-stage chain: the base paper's monolithic job.

    compute 1, no shuffle — :func:`repro_torch.jobs.engine.simulate_staged`
    over this dag reproduces :func:`repro_torch.core.simulator.simulate`'s
    dispatch and queues bit for bit.
    """
    dev = resolve_device(device)
    ones = torch.ones((k_types, 1), dtype=torch.float32, device=dev)
    return StageDag(ones, torch.zeros((k_types, 1), dtype=torch.float32, device=dev), ones)


def map_reduce_dag(
    k_types: int,
    intermediate_gb: float | Tensor = 5.0,
    map_share: float = 0.6,
    input_gb: float | Tensor = 0.0,
    device=None,
) -> StageDag:
    """The canonical two-stage map -> reduce/aggregate chain.

    Args:
        k_types: number of job types (the scalars broadcast).
        intermediate_gb: per-job map-output volume shuffled into the
            reduce stage.
        map_share: compute fraction of the map stage (reduce gets the rest).
        input_gb: optional remote-input pull billed to the map stage
            (0 under the paper's data-local-map premise).
        device: ``None`` means CUDA.
    """
    dev = resolve_device(device)
    compute = torch.tensor([map_share, 1.0 - map_share], dtype=torch.float32,
                           device=dev).broadcast_to((k_types, 2))
    col = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev).broadcast_to((k_types,))
    shuffle = torch.stack([col(input_gb), col(intermediate_gb)], dim=1)
    return chain_dag(compute, shuffle)


def pad_chains(
    computes: Sequence[Sequence[float]],
    shuffles: Sequence[Sequence[float]],
    device=None,
) -> StageDag:
    """Assemble per-type chains of *different* depths into one padded dag.

    Args:
        computes: K lists of per-stage compute intensities.
        shuffles: K lists of per-stage input volumes (same lengths).
        device: ``None`` means CUDA.

    Returns:
        A (K, S_max) :class:`StageDag` with monotone masks.
    """
    if len(computes) != len(shuffles):
        raise ValueError("computes and shuffles must list the same K types")
    s_max = max(len(c) for c in computes)
    comp, shuf, mask = [], [], []
    for c, g in zip(computes, shuffles):
        if len(c) != len(g):
            raise ValueError(
                f"stage count mismatch: {len(c)} intensities vs "
                f"{len(g)} volumes"
            )
        pad = s_max - len(c)
        comp.append(list(c) + [1.0] * pad)
        shuf.append(list(g) + [0.0] * pad)
        mask.append([1.0] * len(c) + [0.0] * pad)
    return chain_dag(comp, shuf, mask, device=resolve_device(device))


def shuffle_volumes_from_selectivity(
    input_gb: Tensor | float,
    selectivity: Tensor,
    bill_input: bool = False,
) -> Tensor:
    """(K, S) per-stage input volumes from per-stage selectivities.

    Stage s's input volume is the job input shrunk by every upstream
    stage: ``input_gb * prod_{u<s} selectivity[:, u]``. Stage 0's entry is
    0 unless ``bill_input`` (the data-local-map premise — map input never
    crosses the WAN). The result lies on ``selectivity``'s device.

    Args:
        input_gb: (K,) or scalar per-job input dataset size.
        selectivity: (K, S) per-stage output/input volume ratios.
        bill_input: charge the full input to stage 0 (remote-map model).
    """
    selectivity = selectivity.to(torch.float32)
    k_types = selectivity.shape[0]
    dev = selectivity.device
    base = torch.as_tensor(input_gb, dtype=torch.float32, device=dev).broadcast_to((k_types,))
    # Volume entering stage s = input * prod of selectivities before s.
    shifted = torch.cat(
        [torch.ones((k_types, 1), dtype=torch.float32, device=dev), selectivity[:, :-1]], dim=1
    )
    vols = base[:, None] * torch.cumprod(shifted, dim=1)          # (K, S)
    if not bill_input:
        vols = torch.cat([torch.zeros_like(vols[:, :1]), vols[:, 1:]], dim=1)
    return vols


def validate_dag(dag: StageDag) -> None:
    """Eager sanity checks (call at construction time; reads to the host)."""
    k, s = dag.compute.shape
    if tuple(dag.shuffle_gb.shape) != (k, s) or tuple(dag.stage_mask.shape) != (k, s):
        raise ValueError(
            f"inconsistent dag shapes: compute {tuple(dag.compute.shape)}, "
            f"shuffle {tuple(dag.shuffle_gb.shape)}, mask {tuple(dag.stage_mask.shape)}"
        )
    mask = dag.stage_mask
    if not bool(((mask == 0.0) | (mask == 1.0)).all()):
        raise ValueError("stage_mask must be {0, 1}")
    if not bool((mask[:, 0] == 1.0).all()):
        raise ValueError("every job type needs at least one active stage")
    if not bool((mask[:, :-1] >= mask[:, 1:]).all()):
        raise ValueError("stage_mask rows must be monotone (a prefix of 1s)")
    if not bool((torch.where(mask > 0.5, dag.compute, 1.0) > 0.0).all()):
        raise ValueError("active stages need strictly positive compute")
    if not bool((dag.shuffle_gb >= 0.0).all()):
        raise ValueError("shuffle volumes must be non-negative")
