"""repro_torch — the GMSA system ported to PyTorch and CUDA (NVIDIA Hopper).

A second package beside the JAX reference :mod:`repro`. It mirrors that
package's layout module for module (``repro.core.gmsa`` ->
``repro_torch.core.gmsa`` and so on) and imports nothing of it:

    repro_torch.core      — queues (Eq. 1), energy model, GMSA, baselines,
                            Iridium placement, the time-slotted simulator
    repro_torch.kernels   — hand-written CUDA kernels (``gmsa_score``) with
                            their plain PyTorch versions beside them
    repro_torch.traces    — arrival / price / PUE / bandwidth / dataset traces
    repro_torch.configs   — the paper's 4-DC scenario and the N = 256 fleet
    repro_torch.bridge    — numpy trace bundles -> the port's ``SimInputs``

Device rule: every entry point that makes tensors takes ``device=None``,
which means ``"cuda"``, and raises when no CUDA device is present; the CPU
is used only when the caller asks for it (``device="cpu"``).
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
