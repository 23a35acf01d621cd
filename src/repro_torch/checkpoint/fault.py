"""Fault tolerance: failure injection, restart orchestration, elastic
shrink — the port of ``repro.checkpoint.fault``.

* checkpoint/restart: :func:`run_with_restarts` drives a step function,
  checkpointing on the manager's schedule and replaying from the last
  checkpoint after a (simulated or real) failure. The token stream is
  seeded by step (:mod:`repro_torch.traces.tokens`), so replayed batches
  are identical and a restarted run is bitwise the uninterrupted one
  (tests/test_torch_checkpoint.py).
* elastic shrink: ``drop_site`` removes the dead site (a shape change,
  host-side); ``drop_site_mask`` zeroes it under an ``alive`` mask so the
  placement controller can run it inside its slot loop with N fixed. Both
  take optional leading run dimensions on the per-run state (q,
  data_dist), written with negative axes; masks are shared or carry the
  same leading dims.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch import Tensor

from repro_torch.checkpoint.checkpoint import CheckpointManager


class SimulatedFailure(RuntimeError):
    """Raised by FailureInjector to model a node/pod loss."""


@dataclasses.dataclass
class FailureInjector:
    """Fail at given steps, or by a seeded coin per step.

    The schedule is a pure function of the config: :meth:`fails_at` draws
    the ``probability`` path's coin from numpy's generator seeded by
    ``(seed, step)`` alone (the JAX package's draw, so both packages see
    one schedule). ``_fired`` records the failures this run has already
    survived (a transient failure does not recur when the step is
    replayed); :func:`run_with_restarts` keeps it in checkpoint metadata so
    a restarted process does not see them again either."""

    fail_at_steps: tuple[int, ...] = ()
    probability: float = 0.0
    seed: int = 0
    _fired: set = dataclasses.field(default_factory=set)

    def fails_at(self, step: int) -> bool:
        """Pure schedule membership: does the config fail at ``step``?"""
        if step in self.fail_at_steps:
            return True
        if self.probability > 0:
            rng = np.random.default_rng((self.seed, step))
            return bool(rng.random() < self.probability)
        return False

    def maybe_fail(self, step: int):
        if step not in self._fired and self.fails_at(step):
            self._fired.add(step)
            raise SimulatedFailure(f"injected failure at step {step}")

    def fired_steps(self) -> list[int]:
        """JSON-serializable record of already-experienced failures."""
        return sorted(self._fired)

    def mark_fired(self, steps) -> None:
        """Restore the experienced-failure record (from checkpoint meta)."""
        self._fired.update(int(s) for s in steps)


def run_with_restarts(
    init_state: Callable[[], dict],
    step_fn: Callable[[dict, int], dict],
    manager: CheckpointManager,
    total_steps: int,
    injector: FailureInjector | None = None,
    max_restarts: int = 10,
) -> tuple[dict, dict]:
    """Drive ``step_fn(state, step) -> state`` with checkpoint/restart.

    ``state`` is a nested dict of tensors. Checkpoints are written with
    ``save_async`` on the manager's schedule; a :class:`SimulatedFailure`
    restores the latest one (or restarts cold) and replays. Returns
    (final_state, stats) with the counts of restarts, replayed steps and
    checkpoints."""
    stats = {"restarts": 0, "replayed_steps": 0, "checkpoints": 0}
    state = init_state()
    start = 0
    if manager.latest_step() is not None:
        state, meta, start = manager.restore(state)
        # A restarted process sees the failure schedule of the one it
        # replaced: failures survived before the checkpoint do not recur.
        if injector is not None:
            injector.mark_fired(meta.get("fired_steps", ()))
    step = start
    while step < total_steps:
        try:
            if injector is not None:
                injector.maybe_fail(step)
            state = step_fn(state, step)
            step += 1
            if manager.should_save(step):
                meta = {"step": step}
                if injector is not None:
                    meta["fired_steps"] = injector.fired_steps()
                manager.save_async(step, state, meta)
                stats["checkpoints"] += 1
        except SimulatedFailure:
            stats["restarts"] += 1
            if stats["restarts"] > max_restarts:
                raise
            manager.wait()   # join any in-flight write before listing
            latest = manager.latest_step()
            if latest is None:
                stats["replayed_steps"] += step   # cold restart: all lost
                state, step = init_state(), 0
            else:
                state, _, ckpt_step = manager.restore(state)
                stats["replayed_steps"] += step - ckpt_step
                step = ckpt_step
    manager.wait()
    return state, stats


def drop_site(q: Tensor, r: Tensor, data_dist: Tensor, dead: int):
    """Elastic shrink of the GDA control plane when DC/pod ``dead`` is lost.

    Args:
        q: (..., N, K) backlogs; r: (..., K, N, N) ratios; data_dist:
            (..., K, N) dataset distribution.

    Returns (q', r', data_dist', burst) over the surviving N-1 sites:
      * q'          — backlogs with the dead row removed;
      * burst       — the dead site's backlog (..., K), to be re-injected
                      as arrivals (those jobs must be re-dispatched);
      * r'          — ratios with dead row/column removed, renormalized;
      * data_dist'  — dataset distribution renormalized (the dead site's
                      replica share redistributes proportionally).
    """
    n = q.shape[-2]
    keep = torch.tensor([i for i in range(n) if i != dead], device=q.device)
    burst = q[..., dead, :]
    q2 = q[..., keep, :]
    r2 = r[..., keep, :][..., keep]
    r2 = r2 / torch.clamp_min(r2.sum(-1, keepdim=True), 1e-9)
    d2 = data_dist[..., keep]
    d2 = d2 / torch.clamp_min(d2.sum(-1, keepdim=True), 1e-9)
    return q2, r2, d2, burst


def drop_site_mask(q: Tensor, data_dist: Tensor, alive: Tensor, died: Tensor | None = None):
    """Static-shape ``drop_site`` for the controller's loop (N stays N).

    Same semantics as :func:`drop_site`: the dead sites' backlog comes back
    as an arrival burst, and their dataset share re-distributes
    proportionally over the surviving replicas. A dataset whose replicas
    were *all* on dead sites falls back to uniform-over-survivors
    (restore-from-backup; the WAN bill for it is the caller's to charge).

    Args:
        q: (..., N, K) backlogs.
        data_dist: (..., K, N) dataset distribution (rows on the simplex).
        alive: (N,) or (..., N) {0,1} mask of surviving sites.
        died: optional mask of *newly* dead sites (shaped as ``alive``)
            whose backlog forms the burst; defaults to every dead site.

    Returns:
        (q', d_masked, d_drop, burst):
          * q'        — (..., N, K) backlogs, dead rows zeroed;
          * d_masked  — (..., K, N) placement with dead shares zeroed (rows
                        sum to the surviving fraction — what is still held);
          * d_drop    — (..., K, N) renormalized survivor placement (rows
                        back on the simplex — what must be held after
                        recovery);
          * burst     — (..., K) the newly-dead sites' backlog to re-inject.
    """
    alive = torch.as_tensor(alive, dtype=data_dist.dtype, device=data_dist.device)
    if died is None:
        died = 1.0 - alive
    burst = (q * died.unsqueeze(-1)).sum(dim=-2)                  # (..., K)
    # The wipe is a select, never ``q * alive``: the select returns the
    # live rows untouched, so an all-alive mask leaves the backlog
    # recurrence bit for bit that of the no-fault program.
    q2 = torch.where(alive.unsqueeze(-1) > 0.5, q, 0.0)
    d_masked = data_dist * alive.unsqueeze(-2)                     # (..., K, N)
    surviving = d_masked.sum(dim=-1, keepdim=True)                 # (..., K, 1)
    n_alive = torch.clamp_min(alive.sum(dim=-1, keepdim=True), 1.0)
    uniform = (alive / n_alive).unsqueeze(-2).broadcast_to(d_masked.shape)
    d_drop = torch.where(
        surviving > 1e-9, d_masked / torch.clamp_min(surviving, 1e-9), uniform
    )
    return q2, d_masked, d_drop, burst
