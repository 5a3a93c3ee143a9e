"""The optimizer (the port of ``repro.optim``): AdamW with clipping and a
warmup + cosine schedule, and int8 gradient compression with error
feedback."""

from .adamw import (AdamWConfig, OptState, adamw_update, global_norm,
                    init_opt_state, lr_at)

__all__ = ["AdamWConfig", "OptState", "adamw_update", "global_norm",
           "init_opt_state", "lr_at"]
