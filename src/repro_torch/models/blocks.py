"""Block-level assembly: the Mamba2 block of ``repro.models.blocks``
(pre-norm residual wiring and its decode-step variant with a state cache).
The attention blocks come with the attention slice (ROADMAP B.4)."""

from __future__ import annotations

import torch

from . import layers as L

__all__ = ["mamba_block_apply", "mamba_block_decode", "mamba_block_init",
           "mamba_state_shape"]


def mamba_block_init(gen: torch.Generator, cfg, dtype):
    return {"ln": torch.ones(cfg.d_model, dtype=dtype, device=gen.device),
            "mixer": L.mamba_init(gen, cfg, dtype)}


def mamba_block_apply(p, x, cfg, *, plain: bool = False):
    return x + L.mamba_apply(p["mixer"], L.rms_norm(x, p["ln"], cfg.norm_eps),
                             cfg, plain=plain)


def mamba_block_decode(p, x, cfg, state):
    y, new_state = L.mamba_decode_step(
        p["mixer"], L.rms_norm(x, p["ln"], cfg.norm_eps), cfg, state)
    return x + y, new_state


def mamba_state_shape(cfg, batch: int, dtype, device=None):
    """Zero decode state of one Mamba2 block."""
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "h": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_headdim,
                          cfg.ssm_state), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
    }
