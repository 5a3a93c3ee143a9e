"""mamba2-130m [ssm]: attention-free SSD (state-space duality).

24L d_model=768 (attn-free) d_ff=0 vocab=50280, ssm_state=128
[arXiv:2405.21060; unverified]
"""

from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="mamba2-130m",
        family="ssm",
        num_layers=24,
        d_model=768,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        attention="none",
        ssm_state=128,
        ssm_expand=2,
        ssm_headdim=64,
        ssm_chunk=64,
        source="arXiv:2405.21060",
    )
)
