"""h2o-danube-3-4b [dense]: llama+mistral mix with sliding-window attention.

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000
[arXiv:2401.16818; unverified]
"""

from .base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="h2o-danube-3-4b",
        family="dense",
        num_layers=24,
        d_model=3840,
        num_heads=32,
        num_kv_heads=8,
        d_ff=10240,
        vocab_size=32000,
        attention="swa",
        swa_window=4096,
        rope_theta=10000.0,
        source="arXiv:2401.16818",
    )
)
