"""hubert-xlarge [audio]: encoder-only transformer backbone (w2v2 arch).

48L d_model=1280 16H (kv=16 => MHA) d_ff=5120 vocab=504 (codebook labels)
[arXiv:2106.07447; unverified]

Encoder-only: bidirectional attention, no decode step (decode shapes skipped).
The CNN feature extractor is a STUB: ``input_specs()`` provides precomputed
frame embeddings (B, S, d_model).
"""

from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="hubert-xlarge",
        family="audio",
        num_layers=48,
        d_model=1280,
        num_heads=16,
        num_kv_heads=16,
        d_ff=5120,
        vocab_size=504,
        causal=False,
        supports_decode=False,
        frontend="audio_frames",
        frontend_seq=-1,  # the whole sequence is frame embeddings
        tie_embeddings=False,
        source="arXiv:2106.07447",
    )
)
