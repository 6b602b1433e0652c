"""Device-dispatching entry points to the port's kernels, with their
gradients.

The route is chosen by where the tensors lie: a CUDA tensor always runs the
hand-written kernel (`segment_combine.segment_combine_cuda`,
`flash_attention.flash_attention_cuda`), a CPU tensor the plain PyTorch
version.  There is no switch and no fallback; the JAX package's
`use_pallas=True/False` has no counterpart here.  Combine payloads may be
`[E]` or `[E, *payload]`; they are flattened to the kernel's `[E, D]`.

The combine and the row gather are `torch.autograd.Function`s, and their
backward passes run the same routes, so a gradient never leaves the
kernels on the card and never takes a float atomic:

  ⊕ = sum      backward `grad_out[dst]`, a gather;
  ⊕ = max/min  the JAX rule (`_scatter_extremal_jvp`): a message's share
               of its segment's gradient is 1/ties when it equals the
               result (1/(ties + 1) where the result is the identity),
               else 0; the ties are counted by the ⊕ = sum of the
               equality mask on the same route;
  row gather   `table[idx]` (`gather_rows`) backward is the ⊕ = sum of the
               gradient rows into the table, over the idx-sorted order
               (`GatherRoute`): the dense route, never `index_add_`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import segment_combine as sc


def _flat(msgs: torch.Tensor) -> torch.Tensor:
    return msgs.reshape(msgs.shape[0], -1).to(torch.float32).contiguous()


def _unflat(out: torch.Tensor, msgs: torch.Tensor, num_segments: int):
    return out.reshape((num_segments,) + tuple(msgs.shape[1:])).to(msgs.dtype)


def _dense(msgs, dst, num_segments, op, seg_ptr):
    """The dense route on `msgs`' device, no autograd."""
    if not msgs.is_cuda:
        return sc.segment_combine_plain(msgs, dst, num_segments, op)
    if seg_ptr is None:
        raise ValueError("segment_combine: the dense route on a CUDA tensor "
                         "needs the ingress row pointer seg_ptr")
    out = sc.segment_combine_cuda(_flat(msgs), dst,
                                  seg_ptr[:num_segments + 1], num_segments,
                                  op, route="dense")
    return _unflat(out, msgs, num_segments)


def _tile(msgs, dst, num_segments, op, valid):
    """The tile route on `msgs`' device, no autograd."""
    if not msgs.is_cuda:
        return sc.tile_segment_combine_plain(msgs, dst, num_segments, op,
                                             valid)
    out = sc.tile_segment_combine_cuda(_flat(msgs), dst, num_segments, op,
                                       valid)
    return _unflat(out, msgs, num_segments)


def _rows_at(x: torch.Tensor, dst: torch.Tensor, num_segments: int,
             fill: float) -> torch.Tensor:
    """`x[dst]` over `x`'s segment rows, `fill` where dst >= num_segments
    (a lane the combine dropped)."""
    pad = torch.full((1,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    idx = dst.clamp(max=num_segments)
    return torch.cat([x, pad]).index_select(0, idx)


class _Combine(torch.autograd.Function):
    """⊕ over `dst` on one route, differentiable in `msgs`."""

    @staticmethod
    def forward(ctx, msgs, dst, num_segments, op, route, seg_ptr, valid):
        if route == "dense":
            out = _dense(msgs, dst, num_segments, op, seg_ptr)
        else:
            out = _tile(msgs, dst, num_segments, op, valid)
        ctx.args = (num_segments, op, route, seg_ptr, valid)
        if op == "sum":
            ctx.save_for_backward(dst)
        else:
            ctx.save_for_backward(dst, msgs, out)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        num_segments, op, route, seg_ptr, valid = ctx.args
        if op == "sum":
            (dst,) = ctx.saved_tensors
            return (_rows_at(grad, dst, num_segments, 0.0),
                    None, None, None, None, None, None)
        dst, msgs, out = ctx.saved_tensors
        # NaN never equals a message, so dropped lanes take no share
        ties = msgs == _rows_at(out, dst, num_segments, math.nan)
        count = (segment_combine(ties.to(grad.dtype), dst, num_segments,
                                 "sum", seg_ptr=seg_ptr) if route == "dense"
                 else tile_segment_combine(ties.to(grad.dtype), dst,
                                           num_segments, "sum", valid))
        count = count + (out == sc.IDENTITY[op]).to(grad.dtype)
        share = grad / count.clamp(min=1.0)
        return (_rows_at(share, dst, num_segments, 0.0) * ties,
                None, None, None, None, None, None)


def segment_combine(msgs: torch.Tensor, dst: torch.Tensor, num_segments: int,
                    op: str = "sum",
                    seg_ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """⊕ along dst-sorted edges (the dense route); differentiable in `msgs`.

    `seg_ptr` is the ingress row pointer over `dst`
    (`DevicePartition.seg_ptr`), required on a CUDA tensor and unused on a
    CPU one; any `seg_ptr[:num_segments + 1]` prefix serves a smaller
    segment space, since entries past it are dropped.
    """
    return _Combine.apply(msgs, dst, num_segments, op, "dense", seg_ptr,
                          None)


def tile_segment_combine(msgs: torch.Tensor, dst: torch.Tensor,
                         num_segments: int, op: str = "sum",
                         valid: Optional[int] = None) -> torch.Tensor:
    """⊕ over a gathered tile with unsorted `dst` (the tile route); lanes
    with `dst >= num_segments` are dropped.  `valid`, when the caller knows
    it, is the count of the other lanes: the route then sizes its compacted
    lanes with no host sync.  Differentiable in `msgs`."""
    return _Combine.apply(msgs, dst, num_segments, op, "tile", None, valid)


@dataclasses.dataclass
class GatherRoute:
    """The backward of a row gather `table[idx]`: the gathered rows' stable
    idx-sorted `order`, their sorted indices `seg` and its row pointer over
    the table's `num_rows`.  Built once where `idx` is fixed (a batch, a
    topology); `gather_rows` builds one in its backward otherwise."""

    order: torch.Tensor     # [n] int64 positions into idx
    seg: torch.Tensor       # [n] int32 idx[order], ascending
    seg_ptr: torch.Tensor   # [num_rows + 1] int32
    num_rows: int

    @staticmethod
    def build(idx: torch.Tensor, num_rows: int) -> "GatherRoute":
        seg, order = torch.sort(idx.to(torch.int32), stable=True)
        return GatherRoute(order, seg, sc.segment_row_pointer(seg, num_rows),
                           num_rows)

    def scatter_sum(self, rows: torch.Tensor) -> torch.Tensor:
        """`out[r] = Σ rows[i] over idx[i] == r`, in idx order: the
        dense-route ⊕ = sum of the rows taken in sorted order."""
        return segment_combine(rows.index_select(0, self.order), self.seg,
                               self.num_rows, "sum", seg_ptr=self.seg_ptr)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, route):
        ctx.route = route
        ctx.num_rows = table.shape[0]
        ctx.save_for_backward(idx if route is None else None)
        return table.index_select(0, idx)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        route = ctx.route
        if route is None:
            (idx,) = ctx.saved_tensors
            route = GatherRoute.build(idx, ctx.num_rows)
        return route.scatter_sum(grad), None, None


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                route: Optional[GatherRoute] = None) -> torch.Tensor:
    """`table[idx]` (`idx [n]`, int32 or int64) with a deterministic
    backward: the ⊕ = sum of the gradient rows over `route`
    (`GatherRoute.build(idx, table.shape[0])`, built in the backward when
    not given)."""
    return _GatherRows.apply(table, idx, route)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  bag_ids: torch.Tensor, num_bags: int,
                  weights: Optional[torch.Tensor] = None,
                  seg_ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """EmbeddingBag: gather `table[ids]`, scale each row by its optional
    per-id weight, then sum the rows of each bag into `[num_bags, d]`.

    The gather is `gather_rows` (a plain `index_select` forward, as the JAX
    package leaves it to XLA outside its kernel); the bag sum is the
    combine kernel's dense route, so `bag_ids` (int32) must be sorted
    (ascending, one bag's ids together).  `seg_ptr` is the bags' row
    pointer; without it the row pointer is built from `bag_ids`
    (`segment_row_pointer`).  Differentiable in `table` (the ⊕ = sum over
    the ids-sorted order) and `weights` (a row-wise dot product).
    """
    rows = gather_rows(table, ids)
    if weights is not None:
        rows = rows * weights[:, None]
    if seg_ptr is None:
        seg_ptr = sc.segment_row_pointer(bag_ids, num_bags)
    return segment_combine(rows, bag_ids, num_bags, "sum", seg_ptr=seg_ptr)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """GQA attention forward: q `[B, Sq, Kv, G, H]`, k/v `[B, Sk, Kv, H]`
    -> `[B, Sq, Kv, G, H]`.  Query head `(kv, g)` attends to kv head `kv`;
    the kernel reads it in place, with no broadcast copy of k/v."""
    if not q.is_cuda:
        return fa.flash_attention_plain(q, k, v, causal)
    return fa.flash_attention_cuda(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal)
