"""GMSA — dynamic Global Manager Selection Algorithm (paper Sec. IV-B).

Per slot the algorithm observes (A, Q, mu, omega, PUE) and picks dispatch
fractions f(t) minimizing the drift-plus-penalty upper bound (Lemma 1):

    min_f  sum_{i,k} [ f_i^k A^k (Q_i^k - mu_i^k) - Q_i^k mu_i^k ]  +  V * Cost(t)
    s.t.   sum_i f_i^k = 1,   f_i^k >= 0.

The objective is linear in ``f`` over a product of K simplices, so the LP
optimum is a vertex: all type-k mass goes to

    i*(k) = argmin_i  A^k * [ Q_i^k - mu_i^k + V * e_i^k ].

Every function takes optional leading Monte-Carlo run dimensions on the
per-run state (q, arrivals, mu); the cost table ``e`` and the raw
``(r, wpue)`` operands are shared by all runs.

V is a number, a 0-d tensor, or a tensor with the batch's leading shape and
trailing ones — ``(V, 1)`` against a (V, R) batch of a sweep — and each
function appends the trailing dims its operand needs (:func:`per_lane`).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import Tensor


def per_lane(v: float | Tensor, trailing: int) -> float | Tensor:
    """V against an operand with ``trailing`` more dims than the batch: a
    number or 0-d tensor is returned as it is (so its products stay those
    of a scalar); a batched V gets ``trailing`` unit dims appended."""
    if isinstance(v, Tensor) and v.ndim:
        return v.reshape(v.shape + (1,) * trailing)
    return v


@dataclasses.dataclass(frozen=True)
class GMSAConfig:
    """Control knobs of GMSA.

    Attributes:
        v: the Lyapunov trade-off parameter V >= 0. Larger V weights energy
            cost more (cost -> within O(1/V) of optimal) at the price of
            O(V) average backlog.
    """

    v: float = 1.0


def drift_plus_penalty_scores(
    q: Tensor, arrivals: Tensor, mu: Tensor, e: Tensor, v: float | Tensor
) -> Tensor:
    """score[..., k, i] = A^k * ( Q_i^k - mu_i^k + V * e[k, i] ).

    Args:
        q: (..., N, K) backlogs.
        arrivals: (..., K) arrivals this slot.
        mu: (..., N, K) service rates this slot.
        e: (K, N) per-job manager energy costs.
        v: V, a scalar or batched as :func:`per_lane` takes it.

    Returns:
        (..., K, N) scores.
    """
    drift = (q - mu).mT
    return arrivals.unsqueeze(-1) * (drift + per_lane(v, 2) * e)


def gmsa_dispatch(
    q: Tensor,
    arrivals: Tensor,
    mu: Tensor,
    e: Tensor | None,
    v: float | Tensor,
    *,
    impl: str = "ref",
    r: Tensor | None = None,
    wpue: Tensor | None = None,
    p_it: Tensor | None = None,
) -> Tensor:
    """Exact per-slot GMSA decision f(t): the (..., N, K) one-hot-per-column
    dispatch placing all type-k jobs on the score-minimizing manager, ties
    to the lowest index.

    * ``impl="ref"`` with a cost table ``e`` — the closed form against the
      simulator's precomputed (K, N) table.
    * ``impl="kernel"`` — the fused ``gmsa_score`` kernel on the raw
      ``(r, wpue)`` operands (``p_it`` defaults to ones). CUDA tensors
      launch the hand-written kernel; CPU tensors take its plain version.
    * ``impl="ref"`` with ``e=None`` and ``r``/``wpue`` — the plain PyTorch
      version of that kernel, chosen explicitly by the caller.
    """
    n = q.shape[-2]
    if impl == "kernel" or (impl == "ref" and e is None):
        if r is None or wpue is None:
            raise ValueError(
                f"impl={impl!r} without a precomputed cost table needs the "
                "raw operands: pass r=(K, N, N) and wpue=(N,)"
            )
        p = torch.ones(arrivals.shape[-1], dtype=torch.float32,
                       device=arrivals.device) if p_it is None else p_it
        v = torch.as_tensor(v, dtype=torch.float32, device=p.device)
        vp = per_lane(v, 1) * p                                  # (K,) or (*B, K)
        if impl == "kernel":
            from repro_torch.kernels.gmsa_score.ops import gmsa_score

            _, best = gmsa_score(q.mT, mu.mT, arrivals, vp, r, wpue)
        else:
            from repro_torch.kernels.gmsa_score.ref import gmsa_score_ref

            _, best = gmsa_score_ref(q.mT, mu.mT, arrivals, vp, r, wpue)
    elif impl == "ref":
        best = torch.argmin(drift_plus_penalty_scores(q, arrivals, mu, e, v), dim=-1)
    else:
        raise ValueError(f"unknown impl {impl!r}; use 'ref' or 'kernel'")
    # One-hot built directly in (N, K) orientation.
    idx = torch.arange(n, device=q.device)
    return (idx[:, None] == best.unsqueeze(-2)).to(q.dtype)


def lp_objective(
    f: Tensor, q: Tensor, arrivals: Tensor, mu: Tensor, e: Tensor, v: float | Tensor
) -> Tensor:
    """The full per-slot LP objective (including the f-independent term).

    obj(f) = sum_{i,k} [ f_i^k A^k (Q_i^k - mu_i^k) - Q_i^k mu_i^k ]
             + V * sum_{i,k} f_i^k A^k e[k, i]
    """
    fa = f * arrivals.unsqueeze(-2)
    dims = (-2, -1)
    drift_term = (fa * (q - mu)).sum(dim=dims)
    const_term = -(q * mu).sum(dim=dims)
    cost_term = v * (fa * e.mT).sum(dim=dims)
    return drift_term + const_term + cost_term


def lyapunov_drift_bound_B(a_max: Tensor, mu_max: Tensor, n: int) -> Tensor:
    """The Lemma-1 constant  B = N/2 * sum_k (A_max^k)^2 + N/2 * sum_k (mu_max^k)^2."""
    return 0.5 * n * (a_max.square().sum() + mu_max.square().sum())


def gmsa_policy(generator, q, arrivals, mu, e, aux, scalar):
    """GMSA with V supplied as the simulator's ``scalar``."""
    del generator, aux
    return gmsa_dispatch(q, arrivals, mu, e, scalar)


gmsa_policy.consumes_key = False


def dispatch_fn(v: float):
    """Policy binding a fixed V, with the simulator's signature
    ``(generator, q, arrivals, mu, e, aux, scalar) -> f``."""

    def _policy(generator, q, arrivals, mu, e, aux, scalar):
        del generator, aux, scalar
        return gmsa_dispatch(q, arrivals, mu, e, v)

    _policy.consumes_key = False
    return _policy


def make_kernel_policy(
    r: Tensor | None = None,
    p_it: Tensor | None = None,
    impl: str = "kernel",
):
    """GMSA policy driving every slot's decision through ``gmsa_score``.

    V rides in as the simulator's ``scalar``, as in :func:`gmsa_policy`.

    * ``r=None`` (carried r) — declares ``wants_r = True`` and reads the
      ratio tensor in force this slot from its aux,
      ``aux = (data_dist, omega_t * pue_t, r_t)``.
    * an explicit (K, N, N) ``r`` — bound statically; the policy is marked
      ``static_r = True`` and the simulator raises if a time-varying ratio
      trace reaches it.

    Either way it declares ``wants_wpue = True`` so the simulator hands it
    raw per-slot prices. ``impl="kernel"`` (default) launches the CUDA
    kernel for CUDA tensors; ``impl="ref"`` is the plain PyTorch version.
    """
    if r is not None:
        r = torch.as_tensor(r, dtype=torch.float32)

    def policy(generator, q, arrivals, mu, e, aux, scalar):
        del generator, e
        if r is None:
            _, wpue, r_t = aux
        else:
            wpue, r_t = aux[1], r
        return gmsa_dispatch(
            q, arrivals, mu, None, scalar,
            impl=impl, r=r_t, wpue=wpue, p_it=p_it,
        )

    policy.consumes_key = False
    policy.wants_wpue = True
    policy.wants_r = r is None
    policy.static_r = r is not None
    return policy
