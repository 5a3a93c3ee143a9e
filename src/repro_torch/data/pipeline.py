"""Deterministic synthetic data pipeline (a copy of
``repro.data.pipeline``: the same numpy draws, so ``batch_at`` gives the
reference's arrays bit for bit for every seed, step, host and frontend).

Produces sharded token batches from a seeded PRNG stream — each (host, step)
pair maps to a unique, reproducible batch, so checkpoint-resume yields
byte-identical training data without any data-state checkpointing beyond the
step counter.  A configurable per-fetch stall emulates slow/fast input devices
(the paper's HDD vs SSD contrast, Fig. 13), and every fetch is a profiled
"record" for the vet pipeline.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator

import numpy as np

__all__ = ["SyntheticTokenPipeline"]


class SyntheticTokenPipeline:
    """Deterministic (seed, step, host) -> batch generator.

    batch layout matches the model's expectations: tokens/labels (B, S) int32
    (labels = next-token shifted stream), optional frontend embeddings.
    """

    def __init__(
        self,
        vocab_size: int,
        batch: int,
        seq_len: int,
        *,
        seed: int = 0,
        host_id: int = 0,
        num_hosts: int = 1,
        d_model: int = 0,
        frontend: str = "none",
        frontend_seq: int = 0,
        fetch_stall_s: float = 0.0,
    ):
        if batch % num_hosts != 0:
            raise ValueError("global batch must divide across hosts")
        self.vocab = vocab_size
        self.batch = batch // num_hosts
        self.seq = seq_len
        self.seed = seed
        self.host = host_id
        self.num_hosts = num_hosts
        self.d_model = d_model
        self.frontend = frontend
        self.frontend_seq = frontend_seq
        self.fetch_stall_s = fetch_stall_s

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The batch for a global step (deterministic, host-sharded)."""
        if self.fetch_stall_s:
            time.sleep(self.fetch_stall_s)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host])
        )
        out: Dict[str, np.ndarray] = {}
        if self.frontend == "audio_frames":
            out["embeddings"] = rng.standard_normal(
                (self.batch, self.seq, self.d_model), dtype=np.float32
            )
            out["labels"] = rng.integers(
                0, self.vocab, (self.batch, self.seq), dtype=np.int32
            )
            return out
        # Markov-ish token stream: correlated tokens so the loss is learnable.
        base = rng.integers(0, self.vocab, (self.batch, self.seq + 1), dtype=np.int32)
        drift = rng.integers(0, 17, (self.batch, 1), dtype=np.int32)
        stream = (base + drift) % self.vocab
        text_seq = self.seq
        if self.frontend == "vision_patches":
            fs = self.frontend_seq
            out["embeddings"] = rng.standard_normal(
                (self.batch, fs, self.d_model), dtype=np.float32
            )
            text_seq = self.seq - fs
        out["tokens"] = stream[:, :text_seq]
        out["labels"] = stream[:, 1 : text_seq + 1]
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

    @classmethod
    def for_config(cls, cfg, shape, **kw):
        return cls(
            cfg.vocab_size,
            shape.global_batch,
            shape.seq_len,
            d_model=cfg.d_model,
            frontend=cfg.frontend,
            frontend_seq=max(cfg.frontend_seq, 0),
            **kw,
        )
