"""Full-model assembly for the ``ssm`` family (the port of
``repro.models.model``): parameters stacked on a leading layer dimension
(``params["seg0"]``, as the reference's scanned segments store them),
embeddings and the tied head, the decode cache, ``prefill`` and
``decode_step``.  Layers run in a Python loop where the reference scans.

Reference behaviour kept on purpose: ``prefill`` leaves the Mamba caches
untouched (the reference does not capture the SSM state from a prompt, so
decode starts from a zero state), and a prompt whose length is not a
multiple of ``cfg.ssm_chunk`` is refused by the SSD scan.

Other families raise ``NotImplementedError``: dense, MoE, VLM and audio
models need attention (ROADMAP B.4, A.10) and hybrids both.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from . import blocks as B
from . import layers as L

__all__ = ["decode_step", "embed_inputs", "init_cache", "init_params",
           "prefill", "segments_of"]

Params = Dict[str, Any]


def _require_ssm(cfg) -> None:
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"{cfg.name} is a {cfg.family!r} model; the port runs the 'ssm' "
            f"family so far (attention models: ROADMAP B.4 and A.10)")


def segments_of(cfg) -> Tuple[Tuple[str, int], ...]:
    _require_ssm(cfg)
    return (("mamba", cfg.num_layers),)


def _stack(trees):
    """Stack a list of equal-structure dicts of tensors on a new dim 0."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def init_params(cfg, gen: torch.Generator, dtype=torch.float32) -> Params:
    """Random parameters from ``gen`` (made on ``gen.device``), in the
    reference's tree layout; tied embeddings padded to ``vocab_padded``."""
    p: Params = {"embed": L.embed_init(gen, cfg.vocab_padded, cfg.d_model,
                                       dtype)}
    for i, (_, count) in enumerate(segments_of(cfg)):
        p[f"seg{i}"] = _stack([B.mamba_block_init(gen, cfg, dtype)
                               for _ in range(count)])
    p["final_norm"] = torch.ones(cfg.d_model, dtype=dtype, device=gen.device)
    if not cfg.tie_embeddings:
        p["head"] = L.dense_init(gen, cfg.d_model, (cfg.vocab_padded,), dtype)
    return p


def embed_inputs(cfg, params: Params, batch) -> torch.Tensor:
    """Token embedding (the ``ssm`` family has no frontend)."""
    _require_ssm(cfg)
    return params["embed"][batch["tokens"]]


def _mask_pad_logits(cfg, logits):
    """The dtype's lowest value on the padded vocab tail."""
    vp = logits.shape[-1]
    if vp == cfg.vocab_size:
        return logits
    col = torch.arange(vp, device=logits.device)
    neg = torch.tensor(torch.finfo(torch.float32).min, dtype=logits.dtype,
                       device=logits.device)
    return torch.where(col < cfg.vocab_size, logits, neg)


def _head(cfg, params, x):
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = x @ params["head"]
    return _mask_pad_logits(cfg, logits)


def init_cache(cfg, batch: int, s_max: int, dtype=torch.float32,
               device=None):
    """Per-segment stacked decode caches (``s_max`` sizes attention caches,
    which the ``ssm`` family has none of)."""
    cache: Dict[str, Any] = {}
    for i, (_, count) in enumerate(segments_of(cfg)):
        one = B.mamba_state_shape(cfg, batch, dtype, device)
        cache[f"seg{i}"] = {k: v.expand((count,) + v.shape).clone()
                            for k, v in one.items()}
    return cache


def prefill(cfg, params: Params, cache, batch, *, plain: bool = False):
    """Run a full prompt; returns (last-token logits (B, V), cache).

    The cache comes back untouched, as the reference's does for SSM
    segments.  ``plain=True`` runs the SSD scan's plain version on every
    device (the on-card reference for the kernel path).
    """
    x = embed_inputs(cfg, params, batch)
    for i, (_, count) in enumerate(segments_of(cfg)):
        stacked = params[f"seg{i}"]
        for li in range(count):
            x = B.mamba_block_apply(_layer(stacked, li), x, cfg, plain=plain)
    return _head(cfg, params, x[:, -1:])[:, 0], dict(cache)


def decode_step(cfg, params: Params, cache, tokens, pos):
    """One decode step.  tokens: (B, 1) integer; ``pos`` (the index of the
    token being generated) is unused by SSM layers, as in the reference.
    Returns (logits (B, V), new cache); the input cache is not modified."""
    x = params["embed"][tokens]
    new_cache = dict(cache)
    for i, (_, count) in enumerate(segments_of(cfg)):
        stacked, seg_cache = params[f"seg{i}"], cache[f"seg{i}"]
        states = []
        for li in range(count):
            x, st = B.mamba_block_decode(_layer(stacked, li), x, cfg,
                                         _layer(seg_cache, li))
            states.append(st)
        new_cache[f"seg{i}"] = _stack(states)
    return _head(cfg, params, x)[:, 0], new_cache
