"""The model substrate, ``dense``, ``moe``, ``vlm``, ``audio`` and ``ssm``
families (the port of ``repro.models``): attention (GQA / sliding window /
bidirectional, KV cache), gated MLP, MoE and Mamba2 layers and blocks, the
frontend stubs, stacked-layer parameters, the training forward and loss,
prefill and decode."""

from .convert import params_from_numpy
from .model import (decode_step, embed_inputs, forward, init_cache,
                    init_params, loss_fn, prefill, segments_of)

__all__ = ["decode_step", "embed_inputs", "forward", "init_cache",
           "init_params", "loss_fn", "params_from_numpy", "prefill",
           "segments_of"]
