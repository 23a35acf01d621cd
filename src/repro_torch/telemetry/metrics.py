"""Fixed-bucket histograms — latency and cost distributions on the device.

A static :class:`HistogramSpec` describes a log-spaced bucket layout (plus
an underflow bucket below ``lo`` and an overflow bucket at ``hi``); the
accumulators are plain ``(..., n_buckets)`` float32 count tensors updated
with masked index-adds, so an update needs no host round trip. Engines
either fold values into a carried histogram (the FIFO sojourn clock below)
or histogram a stream derived after the slot loop in one vectorized pass
(``simulate``'s per-site energy cost).

Host-side, :func:`hist_quantiles` decodes counts into percentile estimates
with **error bounds**: within a bucket the estimate linearly interpolates
the bucket's range, so the true quantile is within one bucket width
(log-spaced: a fixed *relative* resolution of ``ratio - 1``); the overflow
bucket yields its lower edge with an unbounded error — widen ``hi`` if p99
lands there. The host-side functions are numpy, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import Tensor

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class HistogramSpec:
    """Static log-spaced bucket layout.

    Buckets: ``[0, lo)`` (underflow), ``n_buckets - 2`` log-spaced buckets
    covering ``[lo, hi)`` at ratio ``(hi/lo)**(1/(n_buckets-2))``, and
    ``[hi, inf)`` (overflow). The relative quantile resolution is
    ``ratio - 1``: the default 26-bucket 0.5..512 layout resolves ~33%
    anywhere in range.
    """

    lo: float = 0.5
    hi: float = 512.0
    n_buckets: int = 26

    def __post_init__(self):
        if not (self.lo > 0.0 and self.hi > self.lo):
            raise ValueError(f"need 0 < lo < hi, got [{self.lo}, {self.hi})")
        if self.n_buckets < 3:
            raise ValueError("need >= 3 buckets (under, interior, over)")

    @property
    def ratio(self) -> float:
        return (self.hi / self.lo) ** (1.0 / (self.n_buckets - 2))

    def edges(self) -> np.ndarray:
        """(n_buckets + 1,) bucket edges: 0, lo, lo*r, ..., hi, inf."""
        interior = self.lo * self.ratio ** np.arange(self.n_buckets - 1)
        interior[-1] = self.hi          # kill the **(n-2) rounding drift
        return np.concatenate([[0.0], interior, [np.inf]])

    def bucket_index(self, values: Tensor) -> Tensor:
        """int32 bucket of each value, clipped into [0, n_buckets).

        fp32 throughout, as the JAX package computes it: ``log(max(v, lo))
        - log(lo)``, divided by ``log(ratio)`` (both constants rounded to
        fp32 and held in device tensors, so that no kernel swaps the
        division for a product with the reciprocal), floored."""
        v = torch.as_tensor(values, dtype=torch.float32)
        const = lambda x: torch.tensor(x, dtype=torch.float32, device=v.device)
        pos = torch.floor(
            (torch.log(torch.maximum(v, const(self.lo))) - const(np.log(self.lo)))
            / const(np.log(self.ratio))
        )
        # Clamp before the cast: an infinite value lands in the overflow bucket.
        idx = 1 + torch.clamp(pos, -1.0, float(self.n_buckets)).to(torch.int32)
        idx = torch.where(v < self.lo, 0, idx)
        return torch.clamp(idx, 0, self.n_buckets - 1)


def hist_init(spec: HistogramSpec, *lead: int, device=None) -> Tensor:
    """A zeroed ``(*lead, n_buckets)`` count accumulator on ``device``
    (``None``: CUDA)."""
    return torch.zeros((*lead, spec.n_buckets), dtype=torch.float32,
                       device=resolve_device(device))


def hist_add(
    spec: HistogramSpec,
    counts: Tensor,
    values: Tensor,
    weights: Tensor | None = None,
) -> Tensor:
    """Fold ``values`` (any shape) into a 1-D ``(n_buckets,)`` accumulator.

    ``weights`` defaults to 1 per value; a masked update is a zero weight.
    Returns the new accumulator; ``counts`` is not written.
    """
    idx = spec.bucket_index(values).reshape(-1).long()
    w = (torch.ones(idx.shape, dtype=torch.float32, device=counts.device) if weights is None
         else torch.as_tensor(weights, dtype=torch.float32, device=counts.device).reshape(-1))
    return counts.index_add(0, idx, w)


def hist_series(spec: HistogramSpec, values: Tensor, axis: int = -1) -> Tensor:
    """Histogram a batched series along ``axis`` in one vectorized pass:
    values (..., T) (after moving ``axis`` last) become (..., n_buckets)
    counts."""
    v = torch.movedim(torch.as_tensor(values, dtype=torch.float32), axis, -1)
    idx = spec.bucket_index(v)                                       # (..., T)
    buckets = torch.arange(spec.n_buckets, dtype=torch.int32, device=v.device)
    return (idx.unsqueeze(-1) == buckets).to(torch.float32).sum(dim=-2)


# ---------------------------------------------------------------------------
# The FIFO sojourn clock: a carried age ring for fluid request queues
# ---------------------------------------------------------------------------

def sojourn_init(spec: HistogramSpec, k: int, max_age: int,
                 device=None) -> tuple[Tensor, Tensor]:
    """Carried state for :func:`sojourn_step`: (age ring, histogram), on
    ``device`` (``None``: CUDA).

    ``age[k, a]`` is class-k request mass admitted ``a`` slots ago and not
    yet served; ``max_age`` >= the horizon keeps the ring exact (mass older
    than ``max_age`` pools in the last lane and still drains FIFO).
    """
    dev = resolve_device(device)
    return (torch.zeros((k, max_age + 1), dtype=torch.float32, device=dev),
            hist_init(spec, k, device=dev))


def sojourn_step(
    spec: HistogramSpec,
    age: Tensor,
    hist: Tensor,
    admitted: Tensor,
    completed: Tensor,
) -> tuple[Tensor, Tensor]:
    """One slot of the per-class FIFO sojourn clock.

    ``admitted`` (K,) mass enters at age 0, ``completed`` (K,) mass drains
    oldest-first, and each drained sliver lands in the sojourn histogram at
    its age in slots. Returns the advanced ``(age, hist)`` pair.
    """
    f32 = torch.float32
    k, a_max = age.shape
    # Admit this slot's arrivals at age 0 (they may complete this slot).
    age = torch.cat([age[:, :1] + torch.as_tensor(admitted, dtype=f32, device=age.device)[:, None],
                     age[:, 1:]], dim=1)
    # FIFO drain, oldest age first: tail[k, a] is the mass strictly older
    # than lane a; lane a gives up min(its mass, the demand left).
    rev_cum = torch.flip(torch.cumsum(torch.flip(age, [1]), dim=1), [1])
    tail = rev_cum - age
    c = torch.as_tensor(completed, dtype=f32, device=age.device)[:, None]
    take = torch.minimum(torch.clamp_min(c - tail, 0.0), age)          # (K, A)
    idx = spec.bucket_index(torch.arange(a_max, dtype=f32, device=age.device))
    hist = hist.index_add(1, idx.long(), take)
    age = age - take
    # Every survivor is one slot older; mass at the ring's edge pools in
    # the last lane.
    shifted = torch.cat([torch.zeros((k, 1), dtype=f32, device=age.device), age[:, :-1]], dim=1)
    return torch.cat([shifted[:, :-1], shifted[:, -1:] + age[:, -1:]], dim=1), hist


def fifo_sojourn_replay(
    admitted: np.ndarray, completed: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Exact host-side FIFO replay: per-class sojourn samples + weights.

    ``admitted``/``completed`` are (T, K) fluid counts. Returns
    ``(sojourn, weight)`` of shape (K, T*T) where ``sojourn[k, i]`` is a
    sojourn in slots and ``weight[k, i]`` the mass that experienced it —
    the ground truth :func:`sojourn_step` is checked against.
    """
    admitted = np.asarray(admitted, np.float64)
    completed = np.asarray(completed, np.float64)
    t_slots, k = admitted.shape
    soj = np.zeros((k, t_slots * t_slots))
    wgt = np.zeros((k, t_slots * t_slots))
    for ki in range(k):
        ca = np.concatenate([[0.0], np.cumsum(admitted[:, ki])])
        cc = np.concatenate([[0.0], np.cumsum(completed[:, ki])])
        out = 0
        for t in range(t_slots):
            # Mass completing at slot t occupies [cc[t], cc[t+1]) of the
            # cumulative-arrival axis; intersect with each admit slot's
            # segment [ca[s], ca[s+1]) to attribute sojourn t - s.
            lo_c, hi_c = cc[t], cc[t + 1]
            if hi_c <= lo_c:
                continue
            for s in range(t + 1):
                m = min(hi_c, ca[s + 1]) - max(lo_c, ca[s])
                if m > 1e-12:
                    soj[ki, out] = t - s
                    wgt[ki, out] = m
                    out += 1
    return soj, wgt


def weighted_percentile(
    values: np.ndarray, weights: np.ndarray, qs
) -> np.ndarray:
    """Exact weighted percentiles (inverse empirical CDF) of mass samples."""
    values = np.asarray(values, np.float64).reshape(-1)
    weights = np.asarray(weights, np.float64).reshape(-1)
    keep = weights > 0
    values, weights = values[keep], weights[keep]
    if values.size == 0:
        return np.full(np.shape(qs), np.nan)
    order = np.argsort(values)
    values, weights = values[order], weights[order]
    cum = np.cumsum(weights)
    targets = np.asarray(qs, np.float64) / 100.0 * cum[-1]
    return values[np.searchsorted(cum, targets, side="left").clip(0, values.size - 1)]


# ---------------------------------------------------------------------------
# Host-side decode: counts -> percentiles with error bounds
# ---------------------------------------------------------------------------

def hist_quantiles(
    counts, spec: HistogramSpec, qs=(50.0, 95.0, 99.0)
) -> tuple[np.ndarray, np.ndarray]:
    """Percentile estimates + error bounds from bucket counts.

    ``counts`` is (..., n_buckets) (a tensor is copied to the host); returns
    ``(est, err)`` of shape (..., len(qs)). ``|est - true| <= err`` with
    ``err`` the bucket width (``inf`` for the overflow bucket, whose
    estimate is its lower edge ``hi``; ``nan`` where the histogram is empty).
    """
    counts = _host(counts)
    lead = counts.shape[:-1]
    flat = counts.reshape(-1, spec.n_buckets)
    edges = spec.edges()
    width = np.diff(edges)
    qs = np.asarray(qs, np.float64)
    est = np.full((flat.shape[0], qs.size), np.nan)
    err = np.full((flat.shape[0], qs.size), np.nan)
    for i, row in enumerate(flat):
        total = row.sum()
        if total <= 0:
            continue
        cum = np.cumsum(row)
        targets = qs / 100.0 * total
        b = np.searchsorted(cum, targets, side="left").clip(0, spec.n_buckets - 1)
        prev = np.where(b > 0, cum[b - 1], 0.0)
        frac = np.where(row[b] > 0, (targets - prev) / np.maximum(row[b], 1e-300), 0.0)
        overflow = b == spec.n_buckets - 1
        est[i] = np.where(
            overflow, edges[-2], edges[b] + frac * np.where(np.isfinite(width[b]), width[b], 0.0)
        )
        err[i] = width[b]
    return est.reshape(*lead, qs.size), err.reshape(*lead, qs.size)


def percentile_table(
    counts, spec: HistogramSpec, qs=(50.0, 95.0, 99.0), names=None
) -> list[dict]:
    """JSON-ready per-row percentile summaries for (R, n_buckets) counts."""
    counts = _host(counts)
    if counts.ndim == 1:
        counts = counts[None]
    est, err = hist_quantiles(counts, spec, qs)
    rows = []
    for i in range(counts.shape[0]):
        row = {"count": float(counts[i].sum())}
        if names is not None:
            row = {"name": names[i], **row}
        for j, q in enumerate(qs):
            row[f"p{q:g}"] = float(est[i, j])
            row[f"p{q:g}_err"] = float(err[i, j])
        rows.append(row)
    return rows


def _host(counts) -> np.ndarray:
    """Counts as a float64 numpy array (a tensor is copied to the host)."""
    if isinstance(counts, Tensor):
        counts = counts.detach().cpu().numpy()
    return np.asarray(counts, np.float64)
