"""The one traffic generator: closed-loop clients over a mix of query
kinds, read from a mix file (`traffic/<mix>.json`).

`clients` callers each send their next query when the last one returns.
Queries come in blocks of `block`: each kind holds its share of a block
exactly (`round(share * block)`), and each kind that takes a search key
takes the configuration's keys in turn, from a cursor of its own that
runs on from block to block, so that every kind is sent from every key
and the kind and the key of a query are drawn apart.  The order within a
block is drawn from `--seed` (numpy's generator).  So every seed sends
the same blocks of queries, each in another order.
"""
from __future__ import annotations

import numpy as np

PURPOSE_ORDER, PURPOSE_SAMPLE = 1, 2


def rng(seed: int, purpose: int) -> np.random.Generator:
    """A stream of its own for each use of the seed."""
    return np.random.default_rng([int(seed) % (1 << 64), purpose])


class ClosedLoop:
    def __init__(self, mix: dict, keys: np.ndarray, seed: int,
                 takes_root: dict):
        if mix.get("loop") != "closed":
            raise ValueError(f"only closed loops are generated, got "
                             f"{mix.get('loop')!r}")
        self.clients = int(mix["clients"])
        block = int(mix["block"])
        self._counts = {k: round(float(s) * block)
                        for k, s in sorted(mix["kinds"].items())}
        if (sum(self._counts.values()) != block
                or min(self._counts.values()) < 1):
            raise ValueError(f"kind shares {mix['kinds']} do not fill a "
                             f"block of {block}")
        self._keys = [int(k) for k in keys]
        self._cursor = {k: 0 for k in self._counts if takes_root[k]}
        self._rng = rng(seed, PURPOSE_ORDER)
        self._pending: list = []

    def _block(self) -> list:
        pairs = []
        for kind, count in self._counts.items():
            for _ in range(count):
                root = None
                if kind in self._cursor:
                    j = self._cursor[kind]
                    root = self._keys[j % len(self._keys)]
                    self._cursor[kind] = j + 1
                pairs.append((kind, root))
        return pairs

    def next_query(self) -> tuple:
        """`(kind, search key or None)` of the next query sent."""
        if not self._pending:
            pairs = self._block()
            self._pending = [pairs[i]
                             for i in self._rng.permutation(len(pairs))]
        return self._pending.pop(0)
