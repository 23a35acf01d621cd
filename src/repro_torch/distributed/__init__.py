"""repro_torch.distributed — the port of ``repro.distributed`` on one card.

* :mod:`~repro_torch.distributed.mesh` — the Monte-Carlo runs axis in
  chunks (``runs_mesh``, ``sharded_runs``), bitwise identical at every
  chunk count;
* :mod:`~repro_torch.distributed.compression` — the int8 cross-pod
  gradient sum with error feedback, the pod axis a leading axis;
* :mod:`~repro_torch.distributed.sharding` — the logical-axis sharding
  rules, as specs (pure rules; nothing is moved at world size 1).

The JAX package's ``compat`` (a jax 0.4.x shim) and its XLA host-device
bootstrap (``ensure_host_devices``, ``host_platform_flag``) have no torch
meaning and are not ported.
"""

from repro_torch.distributed.compression import compressed_psum_pod, sync_tree
from repro_torch.distributed.mesh import RUNS_AXIS, Mesh, runs_mesh, sharded_runs

__all__ = ["RUNS_AXIS", "Mesh", "compressed_psum_pod", "runs_mesh", "sharded_runs", "sync_tree"]
