"""Fused window vet (``csrc/windowvet.cu`` with its plain PyTorch twin, the
host wrapper, and the scalar reference loop)."""

from .ops import (BLOCK_ROWS, LANES, MAX_LMAX, fused_window_vet,
                  fused_window_vet_plain, fused_window_vet_scan, staged_bytes)
from .ref import ref_window_vet

__all__ = ["BLOCK_ROWS", "LANES", "MAX_LMAX", "fused_window_vet",
           "fused_window_vet_plain", "fused_window_vet_scan",
           "ref_window_vet", "staged_bytes"]
