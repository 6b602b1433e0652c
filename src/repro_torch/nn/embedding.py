"""Embedding lookup and EmbeddingBag (the counterpart of
`repro/nn/embedding.py`).

The lookup is the port's `kernels.ops.gather_rows`, whose gradient goes
through the combine kernel over the ids-sorted order; the bag reduce is
`kernels.ops.embedding_bag`, a kernel of its own (a fused gather, weight
and bag sum forward, a sorted-run backward).  Neither gradient takes a
float atomic.  The row-sharded lookup (`sharded_embedding_lookup`)
follows the combiner-agent pattern: every shard gathers the rows it holds
(misses zeroed), then ONE `comm.psum` merges them, on either communicator.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.segment_combine import segment_row_pointer


def embedding_init(generator: torch.Generator, vocab: int, dim: int,
                   dtype=torch.float32) -> torch.Tensor:
    """N(0, 0.05²) rows drawn in float32 on the generator's device."""
    return (torch.randn((vocab, dim), generator=generator,
                        device=generator.device) * 0.05).to(dtype)


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """`table[ids]` for ids of any shape: `[*ids.shape, dim]`."""
    rows = ops.gather_rows(table, ids.reshape(-1))
    return rows.reshape(tuple(ids.shape) + tuple(table.shape[1:]))


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  bag_ids: torch.Tensor, num_bags: int, mode: str = "sum",
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-hot bag reduce: ids [N] (flattened bag members), bag_ids [N]
    (which bag each id belongs to, int32, sorted ascending), → [num_bags,
    D].  `mode` "mean" divides each bag by its member count (at least 1)."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    out = ops.embedding_bag(table, ids, bag_ids, num_bags, weights=weights)
    if mode == "mean":
        seg_ptr = segment_row_pointer(bag_ids, num_bags)
        cnt = (seg_ptr[1:] - seg_ptr[:-1]).to(table.dtype)
        out = out / torch.clamp(cnt, min=1.0)[:, None]
    return out


def sharded_embedding_lookup(table_shards: torch.Tensor, ids: torch.Tensor,
                             comm) -> torch.Tensor:
    """Row-sharded lookup over the shards `comm` holds (the counterpart of
    the JAX package's `shard_map` lookup).

    table_shards: `[k_local, rows_per_shard, D]`, shard i holding global
    rows `[i·rows_per_shard, (i+1)·rows_per_shard)` (all k stacked for a
    `StackedComm`, the rank's own for a `ProcessGroupComm`); ids `[...]`:
    GLOBAL row ids, the same on every process.  Each held shard gathers
    its hits (`gather_rows` over clipped local ids, misses zeroed), and
    one `comm.psum` (shard order) sums them: `[..., D]`, bitwise the
    whole-table lookup, since every id hits one shard and the others add
    zeros.  Differentiable in `table_shards` through the combine kernel.
    """
    kl, rows = table_shards.shape[0], table_shards.shape[1]
    first = comm.shards.start
    flat_ids = ids.reshape(-1).to(torch.int64)
    lo = (torch.arange(kl, device=ids.device, dtype=torch.int64)
          + first)[:, None] * rows
    local = flat_ids[None, :] - lo                          # [kl, n]
    hit = (local >= 0) & (local < rows)
    idx = (torch.clamp(local, 0, rows - 1)
           + torch.arange(kl, device=ids.device)[:, None] * rows)
    got = ops.gather_rows(table_shards.reshape(kl * rows, -1),
                          idx.reshape(-1))
    got = torch.where(hit.reshape(-1, 1), got, 0.0)
    summed = comm.psum(got.reshape(kl, flat_ids.shape[0], -1))[0]
    return summed.reshape(tuple(ids.shape) + (table_shards.shape[2],))
