"""Mamba2 SSD chunked scan (CUDA kernel ``csrc/ssd.cu`` with its plain
PyTorch version and the stepwise oracle)."""

from .ops import ssd, ssd_scan
from .ref import ssd_ref, ssd_scan_plain

__all__ = ["ssd", "ssd_ref", "ssd_scan", "ssd_scan_plain"]
