"""Job-arrival and service-rate draws (paper Sec. V-A).

The paper drives its evaluation with the production rate of Facebook's
Hadoop cluster — 350K jobs/month — and models slot-level arrivals as
Poisson. Draws are exact truncated Poisson by inverse CDF: the rates are
static per configuration, so a precomputed CDF table and one batched
``searchsorted`` replace a rejection sampler.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from repro_torch.device import resolve_device

#: Facebook Hadoop production trace rate used by the paper.
FACEBOOK_MONTHLY_JOBS = 350_000

#: Minutes per month used to convert the monthly rate (30-day month).
_MINUTES_PER_MONTH = 30 * 24 * 60


def rate_per_slot(slot_minutes: float, monthly_jobs: float = FACEBOOK_MONTHLY_JOBS) -> float:
    """Poisson rate per slot for a given slot length (paper: 5-minute slots)."""
    return monthly_jobs * slot_minutes / _MINUTES_PER_MONTH


def poisson_arrivals(
    generator: torch.Generator,
    t_slots: int,
    k_types: int,
    lam: float | Tensor,
    a_max: float | None = None,
    device=None,
) -> Tensor:
    """(T, K) Poisson arrival counts on ``device`` (``None``: CUDA),
    optionally truncated at A_max (the paper's finite A^k_max; for the
    defaults P[X > 3*lam] ~ 1e-9)."""
    dev = resolve_device(device)
    rate = torch.as_tensor(lam, dtype=torch.float32, device=dev).broadcast_to((k_types,))
    draws = torch.poisson(rate.expand(t_slots, k_types).contiguous(), generator=generator)
    if a_max is not None:
        draws = torch.clamp_max(draws, a_max)
    return draws


def admission_split(arrivals: Tensor, admit_max: float | Tensor | None) -> tuple[Tensor, Tensor]:
    """Per-class per-slot admission control: (admitted, rejected).

    The serving front end caps each class's per-slot intake at
    ``admit_max`` (a number broadcasts over classes, a (K,) tensor gives
    per-class caps, ``None`` admits everything). Rejected mass is shed at
    the door: it never enters a queue and is never billed. The split is
    exact, ``arrivals == admitted + rejected`` elementwise (a difference of
    two fp32 counts below 2**24).
    """
    arrivals = torch.as_tensor(arrivals, dtype=torch.float32)
    if admit_max is None:
        return arrivals, torch.zeros_like(arrivals)
    cap = torch.as_tensor(admit_max, dtype=torch.float32, device=arrivals.device)
    admitted = torch.minimum(arrivals, cap.broadcast_to(arrivals.shape[-1:]))
    return admitted, arrivals - admitted


def serve_rate_tables(rates, shares, mu_headroom: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """Inverse-CDF tables for a serving front end's (arrivals, capacity).

    Args:
        rates: (K,) per-class Poisson request rates (jobs/slot).
        shares: (N,) per-pod capacity shares; pod i's per-class service rate
            is ``shares[i] * sum(rates) / K * mu_headroom``, so the whole
            horizon is one batched ``searchsorted``
            (:func:`poisson_pair_from_tables`).
        mu_headroom: fleet capacity over offered load.

    Returns:
        (arr_cdf (K, M+1), mu_cdf (N, K, M+1)) float32 numpy CDF tables
        sharing one truncation width M (Poisson tails beyond mean +
        8·sqrt(mean) are below ~1e-9, the finite A_max of Lemma 1).
    """
    rates = np.asarray(rates, np.float64)
    shares = np.asarray(shares, np.float64)
    k = rates.shape[0]
    mu_mean = shares[:, None] * rates.sum() / k * mu_headroom * np.ones((1, k))
    top = max(float(rates.max()), float(mu_mean.max()), 1.0)
    m = int(np.ceil(top + 8.0 * np.sqrt(top) + 8.0))
    return poisson_table(rates, m), poisson_table(mu_mean, m)


def poisson_table(lam, max_value: int) -> np.ndarray:
    """(..., max_value+1) float32 CDF table(s) for static rate(s) ``lam``,
    computed in float64 numpy and renormalized over the truncation."""
    import scipy.special

    lam = np.asarray(lam, np.float64)[..., None]
    k = np.arange(max_value + 1, dtype=np.float64)
    logpmf = k * np.log(np.maximum(lam, 1e-300)) - lam - scipy.special.gammaln(k + 1)
    cdf = np.cumsum(np.exp(logpmf), axis=-1)
    cdf = cdf / cdf[..., -1:]
    return cdf.astype(np.float32)


def _pad_cdf(cdf: Tensor, width: int) -> Tensor:
    """Pad a CDF table with trailing 1.0s: for u in [0, 1) the left-side
    ``searchsorted`` result is unchanged."""
    extra = width - cdf.shape[-1]
    if extra == 0:
        return cdf
    return torch.nn.functional.pad(cdf, (0, extra), value=1.0)


def poisson_counts_from_uniforms(
    u_arr: Tensor, u_mu: Tensor, arr_cdf: Tensor, mu_cdf: Tensor
) -> tuple[Tensor, Tensor]:
    """Turn uniform draws into (arrivals, mu) counts by inverse CDF.

    Args:
        u_arr: (*B, T, K) uniforms in [0, 1) for the arrivals.
        u_mu: (*B, T, N, K) uniforms for the service rates.
        arr_cdf: (K, M_a+1) arrival CDF tables.
        mu_cdf: (N, K, M_mu+1) service-rate CDF tables. Tables of different
            widths are padded with 1.0 to the wider one.

    Returns:
        (arrivals (*B, T, K), mu (*B, T, N, K)) float32 counts; a count is
        the first index whose CDF value is >= u (``side="left"``).
    """
    k_types = arr_cdf.shape[0]
    n, k2 = mu_cdf.shape[:2]
    m1 = max(arr_cdf.shape[-1], mu_cdf.shape[-1])
    tables = torch.cat(
        [_pad_cdf(arr_cdf, m1).reshape(-1, m1), _pad_cdf(mu_cdf, m1).reshape(-1, m1)]
    )                                                              # (K+NK, M+1)
    batch_t = u_arr.shape[:-1]                                     # (*B, T)
    u = torch.cat(
        [u_arr.reshape(-1, k_types).T, u_mu.reshape(-1, n * k2).T]
    ).contiguous()                                                 # (K+NK, B*T)
    out = torch.searchsorted(tables, u, right=False)
    arrivals = out[:k_types].T.reshape(batch_t + (k_types,)).to(torch.float32)
    mu = out[k_types:].T.reshape(batch_t + (n, k2)).to(torch.float32)
    return arrivals, mu


def poisson_pair_from_tables(
    generator: torch.Generator,
    arr_cdf: Tensor,
    mu_cdf: Tensor,
    t_slots: int,
    batch: tuple[int, ...] = (),
) -> tuple[Tensor, Tensor]:
    """Draw (arrivals (*batch, T, K), mu (*batch, T, N, K)) in ONE batched
    binary search over K + N·K tables, on the tables' device."""
    k_types = arr_cdf.shape[0]
    n, k2 = mu_cdf.shape[:2]
    dev = arr_cdf.device
    u_arr = torch.rand(tuple(batch) + (t_slots, k_types), generator=generator, device=dev)
    u_mu = torch.rand(tuple(batch) + (t_slots, n, k2), generator=generator, device=dev)
    return poisson_counts_from_uniforms(u_arr, u_mu, arr_cdf, mu_cdf)


def _inverse_cdf(u: Tensor, cdf: Tensor) -> Tensor:
    """Counts for uniforms ``u`` of shape ``(*T, *cdf.shape[:-1])``: the
    first index whose CDF value is >= u, each table searching its own draws."""
    batch_dims = tuple(cdf.shape[:-1])
    m1 = cdf.shape[-1]
    if not batch_dims:
        return torch.searchsorted(cdf, u.reshape(-1)).reshape(u.shape).to(torch.float32)
    t_shape = tuple(u.shape[: u.ndim - len(batch_dims)])
    flat = u.reshape(-1, cdf.reshape(-1, m1).shape[0]).T.contiguous()     # (B, prod T)
    out = torch.searchsorted(cdf.reshape(-1, m1).contiguous(), flat)
    return out.T.reshape(t_shape + batch_dims).to(torch.float32)


def poisson_from_table(generator: torch.Generator, cdf: Tensor, shape: tuple) -> Tensor:
    """Exact truncated-Poisson draws by inverse CDF (binary search), on the
    table's device.

    Args:
        generator: torch generator on the table's device.
        cdf: (..., M+1) tables; leading dims must equal ``shape``'s trailing
            dims (e.g. cdf (N, K, M+1) with shape (T, N, K)).
        shape: output shape (leading axes = time/slot axes).
    Returns: float32 counts in [0, M].
    """
    batch_dims = tuple(cdf.shape[:-1])
    if batch_dims and tuple(shape[len(shape) - len(batch_dims):]) != batch_dims:
        raise ValueError(f"shape {tuple(shape)} does not end in the tables' dims {batch_dims}")
    u = torch.rand(tuple(shape), generator=generator, device=cdf.device)
    return _inverse_cdf(u, cdf)
