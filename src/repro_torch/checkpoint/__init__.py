"""repro_torch.checkpoint — atomic checkpoints, restart orchestration and
the control plane's elastic shrink on site loss.

* :mod:`repro_torch.checkpoint.checkpoint` — ``save_tree`` /
  ``restore_tree`` (the JAX package's layout and manifest) and
  ``CheckpointManager`` (retention, asynchronous saves from an explicit
  host copy);
* :mod:`repro_torch.checkpoint.fault` — ``SimulatedFailure``,
  ``FailureInjector`` (a schedule pure in (seed, step)),
  ``run_with_restarts`` (replay from the latest checkpoint), and
  ``drop_site`` / ``drop_site_mask``, the semantics the placement
  controller's recovery epochs run on.
"""

from repro_torch.checkpoint.checkpoint import CheckpointManager, restore_tree, save_tree
from repro_torch.checkpoint.fault import (
    FailureInjector,
    SimulatedFailure,
    drop_site,
    drop_site_mask,
    run_with_restarts,
)

__all__ = [
    "CheckpointManager",
    "save_tree",
    "restore_tree",
    "SimulatedFailure",
    "FailureInjector",
    "run_with_restarts",
    "drop_site",
    "drop_site_mask",
]
