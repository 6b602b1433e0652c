"""Token data pipeline: deterministic synthetic streams and a file-backed
corpus; the port's own copy of `repro/data/tokens.py` (pure numpy).

Shard-aware: each data-parallel rank derives its slice from (seed, step,
rank), so a restarted or resized job reproduces the exact global batch
order without coordination, and `batch_at` gives the JAX package's
batches bit for bit.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class TokenStream:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    path: Optional[str] = None      # optional corpus file (uint16 tokens)

    def __post_init__(self):
        self._corpus = None
        if self.path and Path(self.path).exists():
            self._corpus = np.fromfile(self.path, dtype=np.uint16)

    def batch_at(self, step: int, rank: int = 0, world: int = 1
                 ) -> Dict[str, np.ndarray]:
        """Global batch `step`, the slice of `rank` of `world`: int32
        `tokens` and `labels` `[batch / world, seq_len]`."""
        if self.batch % world:
            raise ValueError(f"batch {self.batch} does not split over "
                             f"{world} ranks")
        b_loc = self.batch // world
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, rank]))
        if self._corpus is not None:
            starts = rng.integers(0, len(self._corpus) - self.seq_len - 1,
                                  size=b_loc)
            toks = np.stack([self._corpus[s:s + self.seq_len + 1]
                             for s in starts]).astype(np.int32)
        else:
            # markov-ish synthetic stream: next token depends on previous
            toks = np.zeros((b_loc, self.seq_len + 1), np.int32)
            toks[:, 0] = rng.integers(0, self.vocab, b_loc)
            noise = rng.integers(0, self.vocab, (b_loc, self.seq_len))
            mix = rng.random((b_loc, self.seq_len)) < 0.7
            for t in range(self.seq_len):
                follow = (toks[:, t] * 31 + 7) % self.vocab
                toks[:, t + 1] = np.where(mix[:, t], follow, noise[:, t])
        toks = np.clip(toks, 0, self.vocab - 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
