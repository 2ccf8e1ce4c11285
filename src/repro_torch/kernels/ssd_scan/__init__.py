from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_cuda
from repro_torch.kernels.ssd_scan.ref import ssd_decode_step_ref, ssd_scan_ref

__all__ = ["ssd_scan", "ssd_scan_cuda", "ssd_decode_step_ref", "ssd_scan_ref"]
