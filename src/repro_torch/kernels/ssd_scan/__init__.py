from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_scan_phases_ref, ssd_scan_ref

__all__ = ["ssd_scan", "ssd_scan_phases_ref", "ssd_scan_ref"]
