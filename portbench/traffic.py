"""The one traffic generator: a mix file's parameters and the seed give
every request of a run.

A mix (``mixes/<name>.json``) states ``batch`` (prompts a request
carries), ``prompt_lengths`` (the lengths requests cycle through),
``gen_tokens`` (tokens generated for each prompt, the first from the
prefill) and ``dashboard`` (null, or the live vet
dashboard's ``window``, ``stride``, ``record_unit``, ``buckets`` and
``shards``).

Every mix has ``CLIENTS`` clients: a closed loop, the next request issued
when the last one's tokens are back (``launch.serve`` is a static-batch
server with no queue; its batch is its concurrency).

Every seed gives the same multiset of work: requests come in blocks of
``len(prompt_lengths)``, each block one of each length, in an order drawn
from the seed; prompt ids are drawn uniformly from the vocabulary.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["CLIENTS", "Request", "Traffic"]

CLIENTS = 1

_REQUEST, _ORDER, _WARM = 1, 2, 3  # streams of the seed's generators


class Request(NamedTuple):
    index: int
    prompt_len: int
    gen_tokens: int
    tokens: np.ndarray  # (batch, prompt_len) int64


class Traffic:
    """The requests of one mix under one seed."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.mix = mix
        self.batch = int(mix["batch"])
        self.lengths = [int(x) for x in mix["prompt_lengths"]]
        self.gen_tokens = int(mix["gen_tokens"])
        self.vocab = int(vocab)
        self.seed = int(seed) % 2 ** 64
        self._orders = {}

    def _rng(self, *stream: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, *stream])

    def prompt_len(self, i: int) -> int:
        """Request ``i``'s prompt length."""
        n = len(self.lengths)
        block = i // n
        if block not in self._orders:
            self._orders[block] = self._rng(_ORDER, block).permutation(n)
        return self.lengths[int(self._orders[block][i % n])]

    def _tokens(self, s: int, *stream: int) -> np.ndarray:
        return self._rng(*stream).integers(0, self.vocab, (self.batch, s),
                                           dtype=np.int64)

    def request(self, i: int) -> Request:
        s = self.prompt_len(i)
        return Request(i, s, self.gen_tokens, self._tokens(s, _REQUEST, i))

    def warmup(self):
        """One request of each prompt length, drawn apart from the timed
        ones."""
        return [Request(-1 - j, s, self.gen_tokens, self._tokens(s, _WARM, j))
                for j, s in enumerate(sorted(set(self.lengths)))]

    def sample(self, count: int, among: int):
        """Indices of the requests the check compares: the first of the
        longest prompts and ``count - 1`` more drawn from the first
        ``among`` requests."""
        longest = max(self.lengths)
        first = next(i for i in range(among) if self.prompt_len(i) == longest)
        rest = [i for i in range(among) if i != first]
        pick = self._rng(_ORDER, 2 ** 32).choice(len(rest), count - 1,
                                                 replace=False)
        return sorted([first] + [rest[int(j)] for j in pick])
