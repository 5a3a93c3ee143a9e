"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention blocks.

81L d_model=3584 32H (kv=32 => MHA in the shared block) d_ff=14336
vocab=32000, ssm_state=64
[arXiv:2411.15242; unverified]

Structure: 81 Mamba2 blocks; every 6th block boundary applies one of 2 *shared*
transformer blocks (alternating), Zamba2-style.  The shared blocks' parameters
are reused across all applications; each application has its own KV cache.
"""

from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="zamba2-7b",
        family="hybrid",
        num_layers=81,
        d_model=3584,
        num_heads=32,
        num_kv_heads=32,
        head_dim=112,
        d_ff=14336,
        vocab_size=32000,
        ssm_state=64,
        ssm_expand=2,
        ssm_headdim=64,
        ssm_chunk=64,
        hybrid_attn_every=6,
        n_shared_attn_blocks=2,
        source="arXiv:2411.15242",
    )
)
