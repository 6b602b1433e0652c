"""Device-dispatching entry points to the port's kernels.

The route is chosen by where the tensors lie: a CUDA tensor always runs the
hand-written kernel (`segment_combine.segment_combine_cuda`,
`flash_attention.flash_attention_cuda`), a CPU tensor the plain PyTorch
version.  There is no switch and no fallback; the JAX package's
`use_pallas=True/False` has no counterpart here.  Combine payloads may be
`[E]` or `[E, *payload]`; they are flattened to the kernel's `[E, D]`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import segment_combine as sc


def _flat(msgs: torch.Tensor) -> torch.Tensor:
    return msgs.reshape(msgs.shape[0], -1).to(torch.float32).contiguous()


def _unflat(out: torch.Tensor, msgs: torch.Tensor, num_segments: int):
    return out.reshape((num_segments,) + tuple(msgs.shape[1:])).to(msgs.dtype)


def segment_combine(msgs: torch.Tensor, dst: torch.Tensor, num_segments: int,
                    op: str = "sum",
                    seg_ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """⊕ along dst-sorted edges (the dense route).

    `seg_ptr` is the ingress row pointer over `dst`
    (`DevicePartition.seg_ptr`), required on a CUDA tensor and unused on a
    CPU one; any `seg_ptr[:num_segments + 1]` prefix serves a smaller
    segment space, since entries past it are dropped.
    """
    if not msgs.is_cuda:
        return sc.segment_combine_plain(msgs, dst, num_segments, op)
    if seg_ptr is None:
        raise ValueError("segment_combine: the dense route on a CUDA tensor "
                         "needs the ingress row pointer seg_ptr")
    out = sc.segment_combine_cuda(_flat(msgs), dst,
                                  seg_ptr[:num_segments + 1], num_segments,
                                  op, route="dense")
    return _unflat(out, msgs, num_segments)


def tile_segment_combine(msgs: torch.Tensor, dst: torch.Tensor,
                         num_segments: int, op: str = "sum",
                         valid: Optional[int] = None) -> torch.Tensor:
    """⊕ over a gathered tile with unsorted `dst` (the tile route); lanes
    with `dst >= num_segments` are dropped.  `valid`, when the caller knows
    it, is the count of the other lanes: the route then sizes its compacted
    lanes with no host sync."""
    if not msgs.is_cuda:
        return sc.tile_segment_combine_plain(msgs, dst, num_segments, op,
                                             valid)
    out = sc.tile_segment_combine_cuda(_flat(msgs), dst, num_segments, op,
                                       valid)
    return _unflat(out, msgs, num_segments)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  bag_ids: torch.Tensor, num_bags: int,
                  weights: Optional[torch.Tensor] = None,
                  seg_ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """EmbeddingBag: gather `table[ids]`, scale each row by its optional
    per-id weight, then sum the rows of each bag into `[num_bags, d]`.

    The gather stays a plain `index_select` (the JAX package leaves it to
    XLA outside its kernel); the bag sum is the combine kernel's dense
    route, so `bag_ids` (int32) must be sorted (ascending, one bag's ids
    together).  `seg_ptr` is the bags' row pointer; without it the row
    pointer is built from `bag_ids` (`segment_row_pointer`).
    """
    rows = table.index_select(0, ids)
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
