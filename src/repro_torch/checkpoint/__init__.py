"""Atomic, async, keep-N checkpoints in the reference's layout (the port of
``repro.checkpoint``)."""

from .checkpoint import (AsyncCheckpointer, cleanup_keep_n, latest_step,
                         restore, save)

__all__ = ["AsyncCheckpointer", "cleanup_keep_n", "latest_step", "restore",
           "save"]
