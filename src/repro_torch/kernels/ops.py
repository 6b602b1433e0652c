"""Device-dispatching entry points to the port's kernels, with their
gradients.

The route is chosen by where the tensors lie: a CUDA tensor always runs the
hand-written kernel (`segment_combine.segment_combine_cuda`,
`flash_attention.flash_attention_cuda`, the `embedding_bag` kernels), a
CPU tensor the plain PyTorch version.  There is no switch and no
fallback; the JAX package's `use_pallas=True/False` has no counterpart
here.  Combine payloads may be
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

`embedding_bag` is an autograd Function of its own over the
`kernels/embedding_bag.py` kernels: a fused gather-weight-bag-sum
forward and a sorted-run backward, not the combine.

`flash_attention` is an autograd Function over K3 when a gradient is
wanted: its forward asks the kernel for the row statistic `lse` and its
backward is the backward kernel (`flash_attention_bwd_cuda`), the
counterpart of `flash_attention_jax`'s `custom_vjp`.  Without a gradient
it is the forward kernel alone, with no statistic written.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import embedding_bag as eb
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
            return (sc.rows_at(grad, dst, num_segments, 0.0),
                    None, None, None, None, None, None)
        dst, msgs, out = ctx.saved_tensors
        # NaN never equals a message, so dropped lanes take no share
        ties = msgs == sc.rows_at(out, dst, num_segments, math.nan)
        count = (segment_combine(ties.to(grad.dtype), dst, num_segments,
                                 "sum", seg_ptr=seg_ptr) if route == "dense"
                 else tile_segment_combine(ties.to(grad.dtype), dst,
                                           num_segments, "sum", valid))
        count = count + (out == sc.IDENTITY[op]).to(grad.dtype)
        share = grad / count.clamp(min=1.0)
        return (sc.rows_at(share, dst, num_segments, 0.0) * ties,
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
    def build(idx: torch.Tensor, num_rows: int,
              mask: Optional[torch.Tensor] = None) -> "GatherRoute":
        """The route of `idx`; with `mask`, of the positions where it is
        set only (a route for `route_sum`, whose other rows take no part:
        a `gather_rows` backward needs every position)."""
        if mask is None:
            seg, order = torch.sort(idx.to(torch.int32), stable=True)
        else:
            pos = torch.nonzero(mask).squeeze(1)
            seg, o = torch.sort(idx.index_select(0, pos).to(torch.int32),
                                stable=True)
            order = pos.index_select(0, o)
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


class _RouteSum(torch.autograd.Function):
    """`out[r] = Σ rows[i] over idx[i] == r` on a route built once:
    forward the rows taken in sorted order into one dense-route combine,
    backward each row's gradient read at its segment and written back to
    its position (a gather and a copy to distinct rows, no atomic)."""

    @staticmethod
    def forward(ctx, rows, route):
        ctx.route = route
        ctx.shape = rows.shape
        return segment_combine(rows.index_select(0, route.order), route.seg,
                               route.num_rows, "sum", seg_ptr=route.seg_ptr)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        r = ctx.route
        out = grad.new_zeros(ctx.shape)
        return out.index_copy_(0, r.order, grad.index_select(0, r.seg)), None


def route_sum(rows: torch.Tensor, route: GatherRoute) -> torch.Tensor:
    """The ⊕ = sum of `rows [n, *payload]` into `[route.num_rows,
    *payload]` by an index in any order (`jax.ops.segment_sum`), over its
    `GatherRoute` built once (rows outside a masked route are dropped):
    one combine launch forward, differentiable in `rows`."""
    return _RouteSum.apply(rows, route)


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                route: Optional[GatherRoute] = None) -> torch.Tensor:
    """`table[idx]` (`idx [n]`, int32 or int64) with a deterministic
    backward: the ⊕ = sum of the gradient rows over `route`
    (`GatherRoute.build(idx, table.shape[0])`, built in the backward when
    not given)."""
    return _GatherRows.apply(table, idx, route)


class _EmbeddingBag(torch.autograd.Function):
    """The bag sum on `table`'s device, differentiable in `table` and
    `weights`: the kernels on a CUDA tensor, the plain versions on a CPU
    one.  The backward computes only the gradients asked for."""

    @staticmethod
    def forward(ctx, table, ids, bag_ids, num_bags, weights):
        fwd = (eb.embedding_bag_forward_cuda if table.is_cuda
               else eb.embedding_bag_forward_plain)
        ctx.num_bags = num_bags
        ctx.save_for_backward(table, ids, bag_ids, weights)
        return fwd(table, ids, bag_ids, num_bags, weights)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        table, ids, bag_ids, weights = ctx.saved_tensors
        need_table, _, _, _, need_w = ctx.needs_input_grad
        bwd = (eb.embedding_bag_backward_cuda if grad.is_cuda
               else eb.embedding_bag_backward_plain)
        g_table, g_w = bwd(grad.contiguous(), table, ids, bag_ids,
                           ctx.num_bags, weights, need_table, need_w)
        return g_table, None, None, None, g_w


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  bag_ids: torch.Tensor, num_bags: int,
                  weights: Optional[torch.Tensor] = None,
                  seg_ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """EmbeddingBag: `out[b] = Σ_{bag_ids[i] = b} weights[i] · table[ids[i]]`
    into `[num_bags, d]`, empty bags zero, `bag_ids >= num_bags` dropped.

    `bag_ids` must be sorted (ascending, one bag's ids together).  On a
    CUDA tensor the bag sum is its own kernel
    (`embedding_bag.embedding_bag_forward_cuda`), which reads each table
    row by id and finds the bag bounds from `bag_ids` itself, so `seg_ptr`
    (a caller's row pointer over the bags) is accepted and not needed.
    The table is float32 in the kernel: another dtype is cast, and the
    result keeps the table's.  Differentiable in `table` (a walk of the
    ids-sorted order, each table row's gradient written once) and
    `weights` (a row-wise dot product), never through a float atomic.
    """
    del seg_ptr                     # the kernels find the bags themselves
    dtype = table.dtype
    if table.is_cuda:               # the kernels' types and layouts
        table = table.to(torch.float32).contiguous()
        ids = ids.contiguous()
        bag_ids = bag_ids.to(torch.int32).contiguous()
        if weights is not None:
            weights = weights.to(torch.float32).contiguous()
    out = _EmbeddingBag.apply(table, ids, bag_ids, num_bags, weights)
    return out.to(dtype)


def _attention(q, k, v, causal, return_lse):
    """The forward on q's device: the kernel on a CUDA tensor, the plain
    version on a CPU one."""
    if not q.is_cuda:
        return fa.flash_attention_plain(q, k, v, causal, return_lse)
    return fa.flash_attention_cuda(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal, return_lse)


class _FlashAttention(torch.autograd.Function):
    """K3 forward with its row statistic, and the backward kernel (the
    plain versions on a CPU tensor)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.is_cuda:                   # the kernels' layout, saved once
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = _attention(q, k, v, causal, True)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        q, k, v, o, lse = ctx.saved_tensors
        if grad.is_cuda:
            dq, dk, dv = fa.flash_attention_bwd_cuda(
                q, k, v, o, lse, grad.contiguous(), ctx.causal)
        else:
            dq, dk, dv = fa.flash_attention_bwd_plain(q, k, v, o, lse, grad,
                                                      ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """GQA attention: q `[B, Sq, Kv, G, H]`, k/v `[B, Sk, Kv, H]` ->
    `[B, Sq, Kv, G, H]`.  Query head `(kv, g)` attends to kv head `kv`;
    the kernel reads it in place, with no broadcast copy of k/v.
    Differentiable in q, k and v: when autograd records and one of them
    needs a gradient, the forward keeps its row statistic for the
    backward kernel."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal)
    return _attention(q, k, v, causal, False)
