"""The model substrate, every family of the repo (the port of
``repro.models``): attention (GQA / sliding window / bidirectional / MLA,
KV cache), gated MLP, MoE and Mamba2 layers (fused or split projections)
and blocks, the frontend stubs, stacked-layer parameters, the training
forward and loss, prefill and decode, on one device or on a mesh
(``ShardCtx``)."""

from .convert import fused_to_split, params_from_numpy, split_to_fused
from .layers import NULL_CTX, ShardCtx
from .model import (decode_step, embed_inputs, forward, init_cache,
                    init_params, loss_fn, prefill, segments_of)

__all__ = ["NULL_CTX", "ShardCtx", "decode_step", "embed_inputs", "forward", "fused_to_split",
           "init_cache", "init_params", "loss_fn", "params_from_numpy",
           "prefill", "segments_of", "split_to_fused"]
