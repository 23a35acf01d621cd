"""repro_torch — the GMSA system ported to PyTorch and CUDA (NVIDIA Hopper).

A second package beside the JAX reference :mod:`repro`. It mirrors that
package's layout module for module (``repro.core.gmsa`` ->
``repro_torch.core.gmsa`` and so on) and imports nothing of it:

    repro_torch.core       — queues (Eq. 1), energy model, GMSA, baselines,
                             Iridium placement, the time-slotted simulator,
                             V-sweep grids
    repro_torch.kernels    — hand-written CUDA kernels (``gmsa_score``,
                             ``ssd_scan``) with their plain PyTorch versions
    repro_torch.traces     — arrival / price / PUE / bandwidth / dataset
                             traces, dataset drift, site and link faults
    repro_torch.placement  — the WAN model, replica selection and the
                             two-timescale placement controller
    repro_torch.checkpoint — the control plane's elastic shrink on site loss
    repro_torch.configs    — the paper's 4-DC scenario, the N = 256 fleet and
                             the Mamba-2 2.7B model config
    repro_torch.models     — the Mamba-2 language model (prefill, decode)
    repro_torch.serve      — the serving control plane (``FleetEngine``) and
                             its local prefill/decode executor
    repro_torch.launch     — ``python -m repro_torch.launch.serve``
    repro_torch.telemetry  — the flight recorder's device side: levels, the
                             event ring, histograms, SLOs
    repro_torch.benchmarks — the paper's Figs. 5 and 6, the simulator, jobs,
                             placement and serving benches and
                             ``python -m repro_torch.benchmarks.paper_repro``
    repro_torch.bridge     — numpy trace bundles, serving scenarios and
                             parameter trees -> the port

Device rule: every entry point that makes tensors takes ``device=None``,
which means ``"cuda"``, and raises when no CUDA device is present; the CPU
is used only when the caller asks for it (``device="cpu"``).
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
