"""The shard-axis collectives of the distributed engine.

The JAX package runs one program per device under `shard_map` and moves
data between shards with `lax.all_to_all`, `psum`, `pmin` and `pmax` over
a mesh axis.  Two communicators stand for them here, with one surface:

  StackedComm       — all k shards in one process, stacked along a
                      leading axis on one device: every operand is
                      `[k_local, ...]` with `k_local = k`, and each
                      collective is a reshaping or a reduction of that
                      axis.
  ProcessGroupComm  — one shard a process (`k_local = 1`) over
                      `torch.distributed`: k is the world size and the
                      shard is the rank (`repro_torch.dist.world` starts
                      such a world).

Both carry `k`, `rank` (0 for the stacked one) and `shards`, the shard
rows the process holds (`range(k)`, or `range(rank, rank + 1)`), and the
exchanges (`repro_torch.core.exchange`) and engine read only these fields
and calls, never which class they have.

Sums fold the shards in shard order (0, 1, ..., k-1) on both, so a sum
over ranks is bitwise the stacked one and reproducible run to run; min
and max are exact in any order.  `values` counts the entries this process
put into an exchange collective (`all_to_all`, `psum`, `pmin`, `pmax`;
padding and activity flags included), the traffic a run's exchanges put
on the wire: the ranks' counts add up to the stacked count of the same
run.  The halt test (`any`) and the gather of results (`all_gather`) are
not exchange traffic and are not counted.
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist


class StackedComm:
    """k shards stacked along the leading axis of every operand."""

    def __init__(self, k: int):
        if k < 1:
            raise ValueError(f"need at least one shard, got k={k}")
        self.k = k
        self.rank = 0
        self.shards = range(k)
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

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every shard's row `[k, ...]`: here the rows held already."""
        return x


def _wire(x: torch.Tensor) -> torch.Tensor:
    """`x` as the collectives carry it: bool as uint8, contiguous."""
    return (x.view(torch.uint8) if x.dtype == torch.bool else x).contiguous()


def _unwire(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.view(torch.bool) if dtype == torch.bool else x


def _all_to_all_single(x: torch.Tensor) -> torch.Tensor:
    send = _wire(x)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send)
    return _unwire(recv, x.dtype)


class _AllToAll(torch.autograd.Function):
    """`[k, ...]` chunk j to rank j; its backward is the all-to-all of the
    gradient (the exchange is its own transpose)."""

    @staticmethod
    def forward(ctx, x):
        return _all_to_all_single(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all_single(grad)


class ProcessGroupComm:
    """One shard a process over the default `torch.distributed` group.

    Operands are `[1, ...]` (the held shard's row), as `StackedComm` takes
    `[k, ...]`.  `all_to_all` is `all_to_all_single` on the contiguous
    `[k, ...]` send buffer, an autograd Function whose backward is the
    all-to-all of the gradient; `psum` all-gathers the rows and folds them
    in rank order, so it equals `StackedComm.psum` bitwise (an all-reduce
    sum promises no order); `pmin`/`pmax` are all-reduces; `any` is an
    all-reduce max of one int on the device and one host read.  Bool
    operands travel as uint8.

    The calls take tensors on the rank's device.  Gloo (`backend="gloo"`)
    takes CUDA tensors for `all_to_all_single`, `all_reduce` and
    `all_gather` and stages them through host memory itself; NCCL needs
    one card a rank.  A failed collective raises; nothing is retried or
    moved to another device.
    """

    def __init__(self, device=None):
        if not dist.is_initialized():
            raise RuntimeError("ProcessGroupComm needs an initialised "
                               "process group (repro_torch.dist.world)")
        self.device = device      # the rank's device, for its callers
        self.k = dist.get_world_size()
        self.rank = dist.get_rank()
        self.shards = range(self.rank, self.rank + 1)
        self.values = 0

    def _check(self, x: torch.Tensor) -> None:
        if x.dim() == 0 or x.shape[0] != 1:
            raise ValueError(f"a rank's operand is [1, ...] (its shard's "
                             f"row), got {tuple(x.shape)}")

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """`x[0, j]` goes to rank j; returns `y` with `y[0, i]` what rank i
        sent here (`[1, k, ...]` both)."""
        self._check(x)
        if x.shape[1] != self.k:
            raise ValueError(f"all_to_all: {x.shape[1]} destinations, "
                             f"world of {self.k}")
        self.values += x.numel()
        return _AllToAll.apply(x[0]).unsqueeze(0)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """`[1, ...]` on every rank -> `[k, ...]`, rank i's row at i."""
        self._check(x)
        send = _wire(x[0])
        rows = [torch.empty_like(send) for _ in range(self.k)]
        dist.all_gather(rows, send)
        return _unwire(torch.stack(rows), x.dtype)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's row, folded in rank order."""
        self._check(x)
        self.values += x.numel()
        rows = self.all_gather(x).unbind(0)
        return functools.reduce(torch.add, rows).unsqueeze(0)

    def _all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        self._check(x)
        self.values += x.numel()
        out = _wire(x).clone()
        dist.all_reduce(out, op=op)
        return _unwire(out, x.dtype)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, dist.ReduceOp.MIN)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, dist.ReduceOp.MAX)

    def any(self, flag: torch.Tensor) -> bool:
        """The halt test over every rank: one all-reduce, one host read."""
        t = flag.any().reshape(1).to(torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())
