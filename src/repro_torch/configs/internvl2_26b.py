"""internvl2-26b [vlm]: InternViT + InternLM2 — transformer BACKBONE only.

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553
[arXiv:2404.16821; hf]

The vision tower is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings occupying the first ``frontend_seq`` positions;
the remaining positions are text tokens.
"""

from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="internvl2-26b",
        family="vlm",
        num_layers=48,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=92553,
        frontend="vision_patches",
        frontend_seq=1024,  # patch positions per sequence
        tie_embeddings=False,
        source="arXiv:2404.16821",
    )
)
