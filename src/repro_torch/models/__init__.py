"""The model substrate, ``ssm`` family (the port of ``repro.models``):
Mamba2 layers and blocks, stacked-layer parameters, prefill and decode."""

from .convert import params_from_numpy
from .model import (decode_step, embed_inputs, init_cache, init_params,
                    prefill, segments_of)

__all__ = ["decode_step", "embed_inputs", "init_cache", "init_params",
           "params_from_numpy", "prefill", "segments_of"]
