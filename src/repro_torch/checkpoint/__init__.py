"""repro_torch.checkpoint — the control plane's elastic shrink on site loss.

* :mod:`repro_torch.checkpoint.fault` — ``drop_site`` (host-side, removes
  the dead site) and ``drop_site_mask`` (static-shape, masks it), the
  semantics the placement controller's recovery epochs run on.

The checkpoint manager and ``run_with_restarts`` of the JAX package's
``repro.checkpoint`` come with a later slice of the port.
"""

from repro_torch.checkpoint.fault import drop_site, drop_site_mask

__all__ = ["drop_site", "drop_site_mask"]
