"""Causal / sliding-window GQA flash attention (CUDA kernel
``csrc/flash_attention.cu`` with its plain PyTorch version)."""

from .ops import flash_attention
from .ref import attention_plain, live_pairs

__all__ = ["attention_plain", "flash_attention", "live_pairs"]
