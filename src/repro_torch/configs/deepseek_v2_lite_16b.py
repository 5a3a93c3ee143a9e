"""deepseek-v2-lite-16b [moe]: MLA (kv_lora=512) + fine-grained MoE.

27L d_model=2048 16H d_ff(expert)=1408 vocab=102400, 64 routed top-6 + 2 shared
[arXiv:2405.04434; hf]

Pool-line note (DESIGN.md §5): the line mentions both "64e top-6" and
"2 shared+160 routed"; 160 routed is DeepSeek-V2-*full*.  We follow the primary
spec and HF DeepSeek-V2-Lite: 64 routed / top-6 / 2 shared, first layer dense
(d_ff=10944), MLA with kv_lora_rank=512, rope_dim=64, nope_dim=128, v_dim=128.
"""

from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        num_layers=27,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,  # MLA: per-head latent, kv head count == q heads
        d_ff=10944,  # dense first layer
        vocab_size=102400,
        attention="mla",
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
        head_dim=128,
        n_routed_experts=64,
        n_shared_experts=2,
        moe_top_k=6,
        moe_d_ff=1408,
        first_dense_layers=1,
        source="arXiv:2405.04434 / hf:deepseek-ai/DeepSeek-V2-Lite",
    )
)
