"""qwen2.5-32b [dense]: GQA with QKV bias.

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064
[hf:Qwen/Qwen2.5-0.5B; hf]
"""

from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="qwen2.5-32b",
        family="dense",
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        d_ff=27648,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        tie_embeddings=False,
        source="hf:Qwen/Qwen2.5-32B",
    )
)
