"""zamba2-7b-instruct [hybrid]: Zamba2-7B-Instruct as published.

81 Mamba2 layers, d_model=3584, 112 SSD heads of 64 over 2 groups of B and
C, state 64; two weight-shared transformer blocks at the 13
``hybrid_layer_ids`` (use u runs block u % 2) on concat(h, embeddings)
(7168 wide): 32 MHA heads of 224, RoPE over all 224 dims, softmax scale
(224 / 2) ** -0.5, a GELU-gated MLP of 14336 with a rank-128 adapter on
gate and up for each use, and each use's own 3584 x 3584 ``linear`` whose
output is added to its Mamba layer's input.  Tied head, vocab 32000.
[https://huggingface.co/Zyphra/Zamba2-7B-Instruct/blob/main/config.json;
arXiv:2411.15242]

Departure: the SSD kernel takes chunks of at most 64, so ``ssm_chunk`` is
64 where the published ``chunk_size`` is 256 (the scan's result does not
depend on the chunk, apart from rounding).  Prefill hands each mixer's
SSM and conv state to decode (``prefill_ssm_state``).
"""

from .base import Zamba2Config, register

CONFIG = register(
    Zamba2Config(
        name="zamba2-7b-instruct",
        family="hybrid",
        num_layers=81,
        d_model=3584,
        num_heads=32,
        num_kv_heads=32,
        head_dim=224,
        d_ff=14336,
        vocab_size=32000,
        ssm_state=64,
        ssm_expand=2,
        ssm_headdim=64,
        ssm_chunk=64,
        ssm_conv=4,
        ssm_ngroups=2,
        prefill_ssm_state=True,
        n_shared_attn_blocks=2,
        hybrid_layer_ids=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
        hybrid_concat_embed=True,
        adapter_rank=128,
        mlp_act="gelu",
        attn_scale=(224 / 2) ** -0.5,
        norm_eps=1e-5,
        rope_theta=10000.0,
        tie_embeddings=True,
        source="https://huggingface.co/Zyphra/Zamba2-7B-Instruct",
    )
)
