"""Percentile SLOs with multi-window burn-rate alerts (SRE-style).

The backlog-threshold SLO the engines already track is a level check;
this module evaluates *latency-percentile* SLOs — "p99 sojourn ≤ target
slots" — against the serving engine's fluid request flow, and raises
burn-rate alerts the way an error-budget policy would: the per-slot
fraction of served mass that missed the target is an error rate, the SLO
leaves a budget of ``1 - percentile/100``, and an alert fires only when
BOTH a short and a long rolling window burn the budget faster than a
threshold multiple — fast enough to matter, long enough to not be noise.

Inputs are host-side (T, K) admitted/completed arrays (the engine's own
accounting), replayed FIFO — the same order the device-side sojourn
histogram assumes — so the monitor needs no extra device work. numpy, as
in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.telemetry.metrics import HistogramSpec, hist_quantiles

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """One latency SLO: percentile ``percentile`` of sojourn ≤ ``target``.

    ``windows`` is a tuple of ``(short, long, threshold)`` triples in
    slots: an alert fires when the budget burn rate over BOTH windows
    exceeds ``threshold`` (the classic multi-window guard — the short
    window gives fast detection, the long window keeps one bad slot from
    paging). The default pair is sized for the smoke horizons used in
    tests and benches; production horizons would scale them up.
    """

    target: float                 # sojourn target, in slots
    percentile: float = 99.0
    windows: tuple = ((4, 16, 2.0),)

    def __post_init__(self):
        if not (0.0 < self.percentile < 100.0):
            raise ValueError("percentile must be in (0, 100)")
        if self.target < 0:
            raise ValueError("target must be >= 0")
        for short, long_, thr in self.windows:
            if not (0 < short <= long_) or thr <= 0:
                raise ValueError(f"bad window triple {(short, long_, thr)}")

    @property
    def budget(self) -> float:
        """Allowed bad fraction: 1 - percentile/100."""
        return 1.0 - self.percentile / 100.0


def bad_fraction(admitted: np.ndarray, completed: np.ndarray,
                 target: float) -> np.ndarray:
    """(T, K) per-slot fraction of served mass with sojourn > ``target``.

    FIFO replay: mass completing at slot ``t`` that was admitted at slot
    ``s`` experienced sojourn ``t - s``; the bad fraction at ``t`` is the
    over-target share of everything completing at ``t`` (0 where nothing
    completes — an idle slot burns no budget).
    """
    admitted = np.asarray(admitted, np.float64)
    completed = np.asarray(completed, np.float64)
    t_slots, k = admitted.shape
    bad = np.zeros((t_slots, k))
    tot = np.zeros((t_slots, k))
    for ki in range(k):
        ca = np.concatenate([[0.0], np.cumsum(admitted[:, ki])])
        cc = np.concatenate([[0.0], np.cumsum(completed[:, ki])])
        for t in range(t_slots):
            lo_c, hi_c = cc[t], cc[t + 1]
            if hi_c - lo_c <= _EPS:
                continue
            for s in range(t + 1):
                m = min(hi_c, ca[s + 1]) - max(lo_c, ca[s])
                if m > _EPS:
                    tot[t, ki] += m
                    if t - s > target:
                        bad[t, ki] += m
    return np.where(tot > _EPS, bad / np.maximum(tot, _EPS), 0.0)


def _rolling_mean(x: np.ndarray, w: int) -> np.ndarray:
    """Trailing rolling mean over ``w`` slots (shorter at the start)."""
    c = np.concatenate([[0.0], np.cumsum(x, dtype=np.float64)])
    t = np.arange(1, x.shape[0] + 1)
    lo = np.maximum(t - w, 0)
    return (c[t] - c[lo]) / (t - lo)


def burn_events(admitted, completed, slo: SloSpec,
                class_names=None) -> list[dict]:
    """Multi-window burn-rate alert events for one serving run.

    Returns ``{"type": "event", "code": "slo_burn", ...}`` records in the
    flight-record stream shape, one per (class, window pair, rising
    edge): an alert opens when both windows' burn rates cross the
    threshold and does not re-fire while it stays open.
    """
    admitted = np.asarray(admitted, np.float64)
    completed = np.asarray(completed, np.float64)
    t_slots, k = admitted.shape
    names = list(class_names or [f"class{i}" for i in range(k)])
    frac = bad_fraction(admitted, completed, slo.target)
    budget = max(slo.budget, _EPS)
    events: list[dict] = []
    for ki in range(k):
        for short, long_, thr in slo.windows:
            burn_s = _rolling_mean(frac[:, ki], short) / budget
            burn_l = _rolling_mean(frac[:, ki], long_) / budget
            firing = (burn_s > thr) & (burn_l > thr)
            edges = np.flatnonzero(firing & ~np.concatenate([[False],
                                                             firing[:-1]]))
            for t in edges:
                events.append({
                    "type": "event", "code": "slo_burn", "t": int(t),
                    "class": names[ki], "percentile": slo.percentile,
                    "target": slo.target, "window": [int(short), int(long_)],
                    "threshold": float(thr),
                    "burn_short": float(burn_s[t]),
                    "burn_long": float(burn_l[t]),
                })
    events.sort(key=lambda e: (e["t"], e["class"]))
    return events


def evaluate_slo(counts, spec: HistogramSpec, slo: SloSpec,
                 names=None) -> list[dict]:
    """End-of-run SLO verdicts from device-side histogram counts.

    ``counts`` is (K, n_buckets); each row yields
    ``{"name", "percentile", "target", "estimate", "err", "ok"}`` where
    ``ok`` is conservative: the SLO only passes when the estimate passes
    by more than the decode error bound (an overflow-bucket estimate —
    infinite error — can never certify a pass).
    """
    counts = np.asarray(counts, np.float64)
    if counts.ndim == 1:
        counts = counts[None]
    est, err = hist_quantiles(counts, spec, (slo.percentile,))
    rows = []
    for i in range(counts.shape[0]):
        e, b = float(est[i, 0]), float(err[i, 0])
        ok = bool(np.isfinite(e) and np.isfinite(b) and e + b <= slo.target)
        rows.append({
            "name": (names[i] if names else f"class{i}"),
            "percentile": slo.percentile, "target": slo.target,
            "estimate": e, "err": b, "ok": ok,
        })
    return rows
