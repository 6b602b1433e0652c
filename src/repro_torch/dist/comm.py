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

A `ProcessGroupComm` may span a sub-group of the world (`group=`, e.g. a
device mesh's `mesh.get_group("model")`): its `k`, `rank` and shards are
then the group's.  Its `psum` carries a gradient, whose transpose is the
psum of the cotangents (each rank's share of a loss summed over the
group, as `StackedComm`'s fold carries it).

The mesh collectives below (`group_all_gather`, `group_reduce_scatter`,
`group_all_reduce`, `group_max`) are what the sharded LM step
(`repro_torch.models.transformer` under a `DistCtx`) runs over a mesh
axis's group: autograd Functions whose backward is the true transpose
(an all-gather's is a reduce-scatter, an all-reduce's an all-reduce), and
every sum folds the group's ranks in rank order, so a step is
reproducible run to run.  All of them go through `_collective`, the one
place that talks to the backend.
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


def _collective(op: str, x: torch.Tensor, group=None) -> torch.Tensor:
    """Run one collective of `group` (None: the default group) on `x`, a
    tensor on this rank's device: "all_gather" -> `[k, *x.shape]`, row i
    rank i's `x`; "all_to_all" -> `[k, ...]` row i what rank i sent in its
    row of ours (x is `[k, ...]`); "max" -> the elementwise maximum over
    the ranks.  Bool travels as uint8.  Gloo takes CUDA tensors for these
    three and stages them through host memory itself."""
    send = _wire(x)
    if op == "all_gather":
        k = dist.get_world_size(group)
        rows = [torch.empty_like(send) for _ in range(k)]
        dist.all_gather(rows, send, group=group)
        out = torch.stack(rows)
    elif op == "all_to_all":
        out = torch.empty_like(send)
        dist.all_to_all_single(out, send, group=group)
    elif op == "max":
        out = send.clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    else:
        raise ValueError(f"unknown collective {op!r}")
    return _unwire(out, x.dtype)


def _fold(rows: torch.Tensor) -> torch.Tensor:
    """`[k, ...]` summed over its rows in row (rank) order."""
    return functools.reduce(torch.add, rows.unbind(0))


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    return _fold(_collective("all_gather", x, group))


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Rank r's block of `x` along `dim` (k equal blocks), summed over the
    ranks in rank order: one all-to-all of the blocks and a fold."""
    k = dist.get_world_size(group)
    if x.shape[dim] % k:
        raise ValueError(f"reduce-scatter of {x.shape[dim]} rows over "
                         f"{k} ranks")
    blocks = torch.stack(x.chunk(k, dim))
    return _fold(_collective("all_to_all", blocks.contiguous(), group))


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return torch.cat(_collective("all_gather", x.contiguous(),
                                 group).unbind(0), dim)


class _AllToAll(torch.autograd.Function):
    """`[k, ...]` chunk j to rank j; its backward is the all-to-all of the
    gradient (the exchange is its own transpose)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _collective("all_to_all", x.contiguous(), group)

    @staticmethod
    def backward(ctx, grad):
        return _collective("all_to_all", grad.contiguous(), ctx.group), None


class _AllReduce(torch.autograd.Function):
    """The sum over the group's ranks in rank order; backward the same sum
    of the cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad.contiguous(), ctx.group), None


class _AllGather(torch.autograd.Function):
    """The ranks' blocks concatenated along `dim` in rank order; backward
    the reduce-scatter of the cotangent."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    """Rank r's block along `dim` of the sum over the ranks; backward the
    all-gather of the cotangent."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.dim, ctx.group), None, None


def group_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over `group`'s ranks of `x` (rank order), on every rank."""
    return _AllReduce.apply(x, group)


def group_all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' `x` concatenated along `dim`, rank order."""
    return _AllGather.apply(x, dim, group)


def group_reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block (of k) along `dim` of Σ over the ranks of `x`."""
    return _ReduceScatter.apply(x, dim, group)


def group_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum over `group`'s ranks (no gradient)."""
    return _collective("max", x.detach(), group)


class ProcessGroupComm:
    """One shard a process over a `torch.distributed` group (`group`; the
    default group when None).

    Operands are `[1, ...]` (the held shard's row), as `StackedComm` takes
    `[k, ...]`.  `all_to_all` is `all_to_all_single` on the contiguous
    `[k, ...]` send buffer, an autograd Function whose backward is the
    all-to-all of the gradient; `psum` all-gathers the rows and folds them
    in rank order, so it equals `StackedComm.psum` bitwise (an all-reduce
    sum promises no order), and its backward is the same sum of the
    cotangents; `pmin`/`pmax` are all-reduces; `any` is an
    all-reduce max of one int on the device and one host read.  Bool
    operands travel as uint8.

    The calls take tensors on the rank's device.  Gloo (`backend="gloo"`)
    takes CUDA tensors for `all_to_all_single`, `all_reduce` and
    `all_gather` and stages them through host memory itself; NCCL needs
    one card a rank.  A failed collective raises; nothing is retried or
    moved to another device.
    """

    def __init__(self, device=None, group=None):
        if not dist.is_initialized():
            raise RuntimeError("ProcessGroupComm needs an initialised "
                               "process group (repro_torch.dist.world)")
        self.device = device      # the rank's device, for its callers
        self.group = group
        self.k = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
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
        return _AllToAll.apply(x[0], self.group).unsqueeze(0)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """`[1, ...]` on every rank -> `[k, ...]`, rank i's row at i."""
        self._check(x)
        return _collective("all_gather", x[0], self.group)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's row, folded in rank order."""
        self._check(x)
        self.values += x.numel()
        return _AllReduce.apply(x[0], self.group).unsqueeze(0)

    def _all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        self._check(x)
        self.values += x.numel()
        out = _wire(x).clone()
        dist.all_reduce(out, op=op, group=self.group)
        return _unwire(out, x.dtype)

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, dist.ReduceOp.MIN)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x, dist.ReduceOp.MAX)

    def any(self, flag: torch.Tensor) -> bool:
        """The halt test over every rank: one all-reduce, one host read."""
        t = flag.any().reshape(1).to(torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(t.item())
