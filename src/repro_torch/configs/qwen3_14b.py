"""qwen3-14b [dense]: GQA + qk_norm.

40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936
[hf:Qwen/Qwen3-8B; hf]
"""

from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="qwen3-14b",
        family="dense",
        num_layers=40,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=17408,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
        tie_embeddings=False,
        source="hf:Qwen/Qwen3-14B",
    )
)
