"""deepseek-moe-16b [moe]: fine-grained experts, 2 shared + 64 routed top-6.

28L d_model=2048 16H (kv=16 => MHA) d_ff(expert)=1408 vocab=102400
[arXiv:2401.06066; hf]
"""

from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="deepseek-moe-16b",
        family="moe",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=10944,  # dense first layer
        vocab_size=102400,
        n_routed_experts=64,
        n_shared_experts=2,
        moe_top_k=6,
        moe_d_ff=1408,
        first_dense_layers=1,
        source="arXiv:2401.06066 / hf:deepseek-ai/deepseek-moe-16b-base",
    )
)
