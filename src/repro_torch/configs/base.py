"""Architecture config schema + registry (a copy of
``repro.configs.base``: the port imports nothing of the reference).

One ``ArchConfig`` per assigned architecture (exact published numbers) plus a
``reduced()`` view for CPU smoke tests (same structure, tiny dims).  The
sharding knobs (``q_head_pad_multiple``, ``ssm_split_proj``,
``weights_fsdp``) are kept so configs compare field for field with the
reference's; the port's models do not shard yet.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

__all__ = ["ArchConfig", "register", "get_config", "list_configs"]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int  # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # default d_model // num_heads

    # attention flavor
    attention: str = "full"  # full | swa | mla | none
    swa_window: int = 0
    qk_norm: bool = False
    qkv_bias: bool = False
    causal: bool = True
    supports_decode: bool = True

    # MLA (DeepSeek-V2)
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # MoE
    n_routed_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25

    # SSM (Mamba2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4

    # hybrid (Zamba2): apply a shared attention block every k-th backbone layer
    hybrid_attn_every: int = 0
    n_shared_attn_blocks: int = 2

    # modality frontend stub: none | audio_frames | vision_patches
    frontend: str = "none"
    frontend_seq: int = 0  # portion of seq provided as precomputed embeddings

    # runtime knob (set by launchers): pad Q-head count up to a multiple of
    # the TP axis so attention internals shard evenly (outputs of padded
    # heads are masked to zero -> math is exact).
    q_head_pad_multiple: int = 1
    # decode cache dtype: "bf16" (default) or "int8" (per-token-per-head
    # block quantization; halves the mandatory cache streaming, the dominant
    # decode roofline term).
    kv_cache_dtype: str = "bf16"
    # sharding policy: split the fused Mamba in_proj into separate z/x/B/C/dt
    # projections so the SSM inner dim shards over TP (requires ssm_heads %
    # tp == 0; identical math — depthwise conv and SSD are per-channel/head).
    ssm_split_proj: bool = False
    # sharding policy: FSDP-shard weights over the data axis (ZeRO-3 style).
    # For models whose per-TP-shard weights fit comfortably (<= ~4 GiB),
    # replicating weights over data removes ALL per-pass weight gathers
    # (moments/grad-accumulator stay dp-sharded = ZeRO-1).
    weights_fsdp: bool = True

    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ------------------------------------------------------------------ sizes
    @property
    def vocab_padded(self) -> int:
        """Embedding/logits tables are padded to a multiple of 256 so the
        vocab dim shards evenly over the TP axis (standard TPU practice).
        Logits above ``vocab_size`` are masked to -inf in loss/sampling."""
        return -(-self.vocab_size // 256) * 256

    @property
    def num_heads_padded(self) -> int:
        m = max(self.q_head_pad_multiple, 1)
        return -(-self.num_heads // m) * m if self.num_heads else 0

    @property
    def is_moe(self) -> bool:
        return self.n_routed_experts > 0

    @property
    def is_ssm_layer_model(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_headdim else 0

    def param_count(self) -> int:
        """Total parameters (embedding included once if tied)."""
        return _param_count(self)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: shared + top_k routed)."""
        return _param_count(self, active_only=True)

    # ------------------------------------------------------------- reductions
    def reduced(self) -> "ArchConfig":
        """Structure-preserving tiny config for CPU smoke tests."""
        changes: Dict = dict(
            num_layers=min(self.num_layers, 4),
            d_model=128,
            d_ff=0 if self.d_ff == 0 else 256,
            vocab_size=min(self.vocab_size, 512),
            head_dim=32,
            num_heads=0 if self.num_heads == 0 else 4,
            num_kv_heads=0 if self.num_kv_heads == 0 else min(self.num_kv_heads, 2),
        )
        if self.attention == "swa":
            changes["swa_window"] = 16
        if self.attention == "mla":
            changes.update(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
        if self.is_moe:
            changes.update(n_routed_experts=8, moe_top_k=2, moe_d_ff=64,
                           n_shared_experts=min(self.n_shared_experts, 1))
        if self.ssm_state:
            changes.update(ssm_state=16, ssm_headdim=16, ssm_chunk=8)
        if self.hybrid_attn_every:
            changes.update(hybrid_attn_every=2, num_layers=4)
        if self.num_kv_heads and self.num_kv_heads == self.num_heads:
            changes["num_kv_heads"] = changes["num_heads"]  # keep MHA structure
        if self.frontend_seq:
            changes["frontend_seq"] = 8
        return dataclasses.replace(self, **changes)


def _param_count(c: ArchConfig, active_only: bool = False) -> int:
    d = c.d_model
    total = c.vocab_size * d  # embedding (tied head)
    if not c.tie_embeddings:
        total += c.vocab_size * d
    total += d  # final norm

    def attn_params() -> int:
        if c.attention == "mla":
            q = d * c.num_heads * (c.qk_nope_dim + c.qk_rope_dim)
            kv_a = d * (c.kv_lora_rank + c.qk_rope_dim)
            kv_b = c.kv_lora_rank * c.num_heads * (c.qk_nope_dim + c.v_head_dim)
            o = c.num_heads * c.v_head_dim * d
            return q + kv_a + kv_b + o
        if c.attention == "none":
            return 0
        q = d * c.num_heads * c.head_dim
        kv = 2 * d * c.num_kv_heads * c.head_dim
        o = c.num_heads * c.head_dim * d
        b = (c.num_heads + 2 * c.num_kv_heads) * c.head_dim if c.qkv_bias else 0
        return q + kv + o + b

    def mlp_params(ff: int) -> int:
        return 3 * d * ff  # gated (gate, up, down)

    def moe_params() -> int:
        routed = c.n_routed_experts if not active_only else c.moe_top_k
        p = routed * mlp_params(c.moe_d_ff)
        p += c.n_shared_experts * mlp_params(c.moe_d_ff)
        p += d * c.n_routed_experts  # router
        return p

    def mamba_params() -> int:
        di, n, h = c.d_inner, c.ssm_state, c.ssm_heads
        in_proj = d * (2 * di + 2 * n + h)  # z, x, B, C, dt
        conv = c.ssm_conv * (di + 2 * n)
        out = di * d
        extra = 2 * h + di  # A, D, dt_bias-ish + norm
        return in_proj + conv + out + extra + d

    if c.family in ("ssm",):
        total += c.num_layers * (mamba_params() + d)
        return total
    if c.family == "hybrid":
        total += c.num_layers * (mamba_params() + d)
        # shared attention blocks (parameters shared across applications)
        shared = attn_params() + mlp_params(c.d_ff) + 2 * d
        total += c.n_shared_attn_blocks * shared
        return total

    per_layer = attn_params() + 2 * d  # two norms
    if c.is_moe:
        dense_layer = per_layer + mlp_params(c.d_ff)
        moe_layer = per_layer + moe_params()
        total += c.first_dense_layers * dense_layer
        total += (c.num_layers - c.first_dense_layers) * moe_layer
    else:
        total += c.num_layers * (per_layer + mlp_params(c.d_ff))
    return total


_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    from . import _load_all  # populate registry lazily

    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list:
    from . import _load_all

    _load_all()
    return sorted(_REGISTRY)
