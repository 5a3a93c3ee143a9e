"""Synthetic, seeded training data (a copy of ``repro.data``)."""

from .pipeline import SyntheticTokenPipeline

__all__ = ["SyntheticTokenPipeline"]
