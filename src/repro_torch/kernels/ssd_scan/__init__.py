from repro_torch.kernels.ssd_scan.ops import SsdScanFn, ssd_scan
from repro_torch.kernels.ssd_scan.ref import (
    ssd_scan_bwd_phases_ref,
    ssd_scan_bwd_ref,
    ssd_scan_phases_ref,
    ssd_scan_ref,
)

__all__ = ["SsdScanFn", "ssd_scan", "ssd_scan_bwd_phases_ref", "ssd_scan_bwd_ref",
           "ssd_scan_phases_ref", "ssd_scan_ref"]
