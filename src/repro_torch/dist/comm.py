"""The shard-axis collectives of the distributed engine, on one device.

The JAX package runs one program per device under `shard_map` and moves
data between shards with `lax.all_to_all`, `psum`, `pmin` and `pmax` over
a mesh axis.  `StackedComm` is their counterpart when all k shards lie on
one device, stacked along a leading axis: every operand is
`[k_local, ...]` with `k_local = k`, and each collective is a reshaping or
a reduction of that axis.  The exchanges (`repro_torch.core.exchange`)
speak only these calls, so a communicator over `torch.distributed`, one
shard a rank (`k_local = 1`), can stand in without touching them.

Sums fold the shards in shard order (0, 1, ..., k-1), so a reduction is
reproducible run to run; min and max are exact in any order.  `values`
counts the entries that entered a collective (padding and activity flags
included), the traffic a run's exchanges put on the wire.
"""
from __future__ import annotations

import functools

import torch


class StackedComm:
    """k shards stacked along the leading axis of every operand."""

    def __init__(self, k: int):
        if k < 1:
            raise ValueError(f"need at least one shard, got k={k}")
        self.k = k
        self.values = 0

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """`x[i, j]` is what shard i sends to shard j; returns `y` with
        `y[j, i] = x[i, j]`, what shard j received from shard i
        (`[k_local, k, ...]` both)."""
        self.values += x.numel()
        return x.transpose(0, 1)

    def _fold(self, op, x: torch.Tensor) -> torch.Tensor:
        self.values += x.numel()
        total = functools.reduce(op, x.unbind(0))
        return total.unsqueeze(0).expand(x.shape)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Every shard's row becomes the sum of all rows (shard order)."""
        return self._fold(torch.add, x)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return self._fold(torch.minimum, x)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._fold(torch.maximum, x)

    def any(self, flag: torch.Tensor) -> bool:
        """The halt test: whether any shard's flag is set (one host read)."""
        return bool(flag.any())
