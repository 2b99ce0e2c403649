from .cuda import ssd_scan_cuda
from .ops import (SsdScanKernel, ssd_scan, ssd_scan_backward,
                  ssd_scan_chunked)
from .ref import ssd_scan_ref

__all__ = ["SsdScanKernel", "ssd_scan", "ssd_scan_backward",
           "ssd_scan_chunked", "ssd_scan_cuda", "ssd_scan_ref"]
