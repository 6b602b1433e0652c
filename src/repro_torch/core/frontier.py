"""Frontier-compacted scatter-combine with degree-bucketed tiles.

The dense scatter path scans every edge each superstep and masks by
`active_scatter[src]`; on a scale-free graph a BFS superstep with a 1%
frontier wastes 99% of its gather bandwidth.  This module compacts instead:

  1. `torch.nonzero_static(active, size=cap)` extracts at most `cap` active
     slots (fill value `num_slots`);
  2. the CSR `indptr` built at ingress (`graph.structures.csr_layout`) gives
     each frontier slot's out-edge range, gathered into a padded edge tile
     through the position index `csr_eidx`, so destinations and edge props
     read the canonical dst-sorted columns;
  3. the tile's messages feed the tile route of the combine kernel
     (`kernels.ops.tile_segment_combine`: compaction of the valid lanes in
     lane order, a stable sort of only those by dst, row pointer, kernel).
     Invalid lanes carry identity messages and the `num_segments`
     destination sentinel, which the compaction drops.  The count of valid
     lanes, the live out-edges, comes with the frontier counts, so the
     route sizes its compacted lanes with no host sync of its own.

The default path is degree-BUCKETED (`bucketed_scatter_combine`): each
degree bucket gathers its own `[cap_b, max_deg_b]` tile, so a hub does not
pad every frontier slot to its degree.  One padded `[cap, max_deg]` tile
(`compact_scatter_combine`) is kept as the "flat" strategy.

Strategy selection is a host branch per superstep on the live counts and
their out-edge totals (`frontier_counts`), all read in one transfer: dense
above the total capacity (the density crossover), compacted below.  A
bucket whose live members exceed `cap_b` degrades to a dense scan
restricted to that bucket's sources; no vertex is ever dropped.
"""
from __future__ import annotations

import functools
from typing import TYPE_CHECKING, NamedTuple, Optional, Sequence

import torch

from repro_torch.core.vertex_program import segment_combine
from repro_torch.kernels import ops as kernel_ops

if TYPE_CHECKING:  # pragma: no cover - typing only, avoids a cycle
    from repro_torch.core.engine import DevicePartition, EngineState
    from repro_torch.core.plan import FrontierPlan
    from repro_torch.core.vertex_program import VertexProgram

# Host reads of the frontier (one `frontier_counts` transfer each); reset by
# callers that count a run.
HOST_READS = {"frontier_counts": 0}

# Density threshold for auto strategy selection: compact below ~6% active.
FRONTIER_DENSITY = 1.0 / 16.0

# Calibrated capacity head-room: cap = GROWTH x the largest frontier
# observed during the probe supersteps.
CAP_GROWTH = 4


def default_cap(num_slots: int,
                frontier_hist: Optional[Sequence[int]] = None) -> int:
    """Default frontier capacity, rounded up to a multiple of 8.

    With `frontier_hist` (live frontier sizes of the first supersteps,
    `GREEngine.calibrate_frontier_cap`) the capacity is `CAP_GROWTH x` the
    largest observed size; without it, the density threshold as a fixed
    fraction of `num_slots`.
    """
    if frontier_hist:
        cap = max(8, CAP_GROWTH * int(max(frontier_hist)))
    else:
        cap = max(8, int(num_slots * FRONTIER_DENSITY))
    return min(num_slots, -(-cap // 8) * 8)


def bucket_caps(sizes: Sequence[int], cap: int) -> tuple:
    """Split the global frontier capacity across buckets proportionally to
    membership; each nonempty bucket keeps a floor of 8, quotas are rounded
    up to a multiple of 8 and clamped to the bucket size."""
    total = sum(sizes)
    if total == 0:
        return tuple(0 for _ in sizes)
    caps = []
    for s in sizes:
        if s == 0:
            caps.append(0)
            continue
        quota = -(-cap * s // total)            # ceil, proportional share
        quota = -(-quota // 8) * 8
        caps.append(min(s, max(quota, 8)))
    return tuple(caps)


def gather_frontier_edge_tile(part: "DevicePartition", frontier: torch.Tensor,
                              cap: int, max_deg: Optional[int] = None):
    """Gather the frontier slots' out-edge ranges into a padded edge tile.

    `frontier [cap]` holds active slots with fill value `part.num_slots`,
    whose range `[indptr[num_slots], indptr[num_slots])` is empty.  Returns
    `(eid [cap, max_deg], valid)`: positions into the partition's canonical
    edge columns, and the mask of the ragged lanes.
    """
    slots = part.num_slots
    if max_deg is None:
        max_deg = part.csr_max_deg
    start = part.csr_indptr[frontier]
    end = part.csr_indptr[torch.clamp(frontier + 1, max=slots)]
    deg = end - start                                    # [cap], 0 on fills
    col = torch.arange(max_deg, dtype=torch.int32, device=frontier.device)
    valid = col[None, :] < deg[:, None]                  # [cap, max_deg]
    pos = torch.where(valid, start[:, None] + col[None, :], 0)
    return part.csr_eidx[pos], valid


def frontier_tile(program: "VertexProgram", part: "DevicePartition",
                  state: "EngineState", num_segments: int, cap: int,
                  max_deg: Optional[int] = None,
                  frontier_mask: Optional[torch.Tensor] = None):
    """The gathered tile of the ≤ `cap` live slots' out-edges: `(msgs
    [cap·max_deg, *payload], dst [cap·max_deg])`, unsorted, with identity
    messages and the `num_segments` sentinel on invalid lanes."""
    p = program
    slots = part.num_slots
    if max_deg is None:
        max_deg = part.csr_max_deg
    mask = state.active_scatter if frontier_mask is None else frontier_mask
    frontier = torch.nonzero_static(mask, size=cap,
                                    fill_value=slots).squeeze(1)
    eid, valid = gather_frontier_edge_tile(part, frontier, cap, max_deg)
    dst = torch.where(valid, part.dst[eid], num_segments)
    # fill entries (== num_slots) lie past scatter_data: clamp the gather
    # and give them the identity explicitly
    gathered = state.scatter_data[torch.clamp(frontier, max=slots - 1)]
    real = (frontier < slots).reshape((-1,) + (1,) * (gathered.dim() - 1))
    gathered = torch.where(real, gathered, p.monoid.identity)
    tile = gathered[:, None].expand((cap, max_deg) + tuple(gathered.shape[1:]))
    flat = tile.reshape((cap * max_deg,) + tuple(gathered.shape[1:]))
    eprop = (part.edge_props[p.needs_edge_prop][eid].reshape(-1)
             if p.needs_edge_prop else None)
    msgs = p.scatter_msg(flat, eprop)
    vmask = valid.reshape((-1,) + (1,) * (msgs.dim() - 1))
    msgs = torch.where(vmask, msgs.to(p.msg_dtype), p.monoid.identity)
    return msgs, dst.reshape(-1)


def compact_scatter_combine(program: "VertexProgram", part: "DevicePartition",
                            state: "EngineState", num_segments: int,
                            cap: int, live_edges: int,
                            max_deg: Optional[int] = None,
                            frontier_mask: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """⊕-combine emitted only from the ≤ `cap` live slots' out-edges.

    Equal to the dense masked scan whenever the live mask fits in `cap`
    (bitwise for min/max; sums up to float reorder).  Callers guard
    `|frontier| <= cap`.  `live_edges`, the live slots' out-edge total
    (`frontier_counts`), is then the tile's count of lanes routed to a
    segment, and is passed on to the tile route: every real edge's dst
    lies inside `num_segments`, in the slot space and in the pipelined
    split tiles' compact spaces alike (`agent_graph.split_edge_tiles`
    relabels a shard's real edges into `[0, c_pad)` or `[0, cap)` of its
    `c_pad + 1` or `cap + 1` block).  A count that disagrees raises on the
    CPU and traps on the card.
    """
    msgs, dst = frontier_tile(program, part, state, num_segments, cap,
                              max_deg, frontier_mask)
    return kernel_ops.tile_segment_combine(msgs, dst, num_segments,
                                           program.monoid.name, live_edges)


def dense_masked_combine(program: "VertexProgram", part: "DevicePartition",
                         state: "EngineState", num_segments: int,
                         src_mask: torch.Tensor) -> torch.Tensor:
    """Dense every-edge scan with an explicit source-activity mask (the
    per-bucket overflow path)."""
    p = program
    eprop = (part.edge_props[p.needs_edge_prop]
             if p.needs_edge_prop else None)
    gathered = state.scatter_data.index_select(0, part.src)
    msgs = p.scatter_msg(gathered, eprop)
    live = src_mask.index_select(0, part.src) & part.edge_mask
    live = live.reshape(live.shape + (1,) * (msgs.dim() - live.dim()))
    msgs = torch.where(live, msgs.to(p.msg_dtype), p.monoid.identity)
    return segment_combine(msgs, part.dst, num_segments, p.monoid,
                           indices_are_sorted=part.edges_sorted_by_dst,
                           seg_ptr=part.seg_ptr)


class FrontierCounts(NamedTuple):
    """The live frontier, read in one host transfer: `live` = |F|, `edges`
    = the out-edges of F, and per degree bucket b the live `members` |F ∩
    b| and their out-edges `bucket_edges`."""

    live: int
    edges: int
    members: tuple
    bucket_edges: tuple


def frontier_counts(part: "DevicePartition",
                    active: torch.Tensor) -> FrontierCounts:
    """Live slots and their out-edge totals, overall and per bucket (none
    when the partition has no buckets), in one host transfer."""
    nb = len(part.bucket_max_deg) if part.bucket_id is not None else 0
    act = active.to(torch.int64)
    deg = (part.csr_indptr[1:] - part.csr_indptr[:-1]).to(torch.int64)
    edges = act * deg
    cols = [act.sum().reshape(1), edges.sum().reshape(1)]
    if nb:
        # a histogram over nb + 1 bins, not an atomic scatter onto them (which
        # serialises every slot on a handful of addresses); the float64
        # weights are integers below 2**53, so the sums are exact
        key = part.bucket_id + 1
        for w in (act, edges):
            cols.append(torch.bincount(key, weights=w.to(torch.float64),
                                       minlength=nb + 1)[1:].to(torch.int64))
    vals = torch.cat(cols).tolist()
    HOST_READS["frontier_counts"] += 1
    return FrontierCounts(vals[0], vals[1], tuple(vals[2:2 + nb]),
                          tuple(vals[2 + nb:]))


def bucketed_scatter_combine(program: "VertexProgram",
                             part: "DevicePartition", state: "EngineState",
                             num_segments: int, caps: Sequence[int],
                             counts: Sequence[int], edges: Sequence[int]
                             ) -> torch.Tensor:
    """Degree-bucketed compacted ⊕ over the live frontier.

    `bucket_id` partitions the slots with out-edges, so the per-bucket
    partial combines touch every active out-edge exactly once.  Each bucket
    gathers its own tile when its live members fit `cap_b`, else runs a
    bucket-restricted dense scan.  `counts` are the live members per bucket
    (`frontier_counts(...).members`), `edges` their out-edge totals
    (`.bucket_edges`), which spare each tile route a host sync; a bucket
    with no live member contributes the identity and is skipped.
    """
    p = program
    partials = []
    for b, (cap_b, max_deg_b) in enumerate(zip(caps, part.bucket_max_deg)):
        if cap_b <= 0 or max_deg_b <= 0 or counts[b] == 0:
            continue
        mask_b = state.active_scatter & (part.bucket_id == b)
        if counts[b] <= cap_b:
            partials.append(compact_scatter_combine(
                program, part, state, num_segments, cap_b, edges[b],
                max_deg=max_deg_b, frontier_mask=mask_b))
        else:
            partials.append(dense_masked_combine(program, part, state,
                                                 num_segments, mask_b))
    if not partials:
        return torch.full((num_segments,) + tuple(p.payload_shape),
                          p.monoid.identity, dtype=p.msg_dtype,
                          device=part.device)
    return functools.reduce(p.monoid.op, partials)


def bucketed_tile_occupancy(part: "DevicePartition", active: torch.Tensor,
                            caps: Sequence[int],
                            num_segments: Optional[int] = None,
                            block_e: int = 256, block_v: int = 256) -> tuple:
    """Measured occupancy of the bucketed tiles for a live frontier.

    Replays the bucketed gather for `active` (each bucket's `[cap_b,
    max_deg_b]` tile) and returns ``(visited, total)`` summed over buckets:
    `visited` counts the valid lanes (those routed to a segment below
    `num_segments`), `total` the tile's lanes.  The JAX package counts
    (dst block, edge block) pairs of its per-superstep block table here;
    the port has no block table (its tile route compacts the valid lanes,
    `repro_torch.kernels.segment_combine`), so the analogue is valid lanes
    over tile lanes.  `block_e` and `block_v` are the JAX signature's and
    unused.  Diagnostic only.
    """
    nseg = num_segments or part.num_slots
    visited = total = 0
    for b, (cap_b, max_deg_b) in enumerate(zip(caps, part.bucket_max_deg)):
        if cap_b <= 0 or max_deg_b <= 0:
            continue
        mask_b = active & (part.bucket_id == b)
        frontier = torch.nonzero_static(mask_b, size=cap_b,
                                        fill_value=part.num_slots).squeeze(1)
        eid, valid = gather_frontier_edge_tile(part, frontier, cap_b,
                                               max_deg_b)
        visited += int((valid & (part.dst[eid] < nseg)).sum())
        total += valid.numel()
    return visited, total


def frontier_scatter_combine(program: "VertexProgram",
                             part: "DevicePartition", state: "EngineState",
                             num_segments: int, plan: "FrontierPlan",
                             dense_fn) -> torch.Tensor:
    """Per-superstep strategy selection with capacity/overflow guards.

    `plan` is the partition's resolution (kind "flat" or "bucketed");
    `dense_fn()` produces the dense masked combine, taken whenever the live
    frontier exceeds the total compacted capacity.
    """
    kind, caps = plan
    counts = frontier_counts(part, state.active_scatter)
    if kind == "flat":
        if counts.live <= caps:
            return compact_scatter_combine(program, part, state,
                                           num_segments, caps, counts.edges)
        return dense_fn()
    if counts.live <= sum(caps):
        return bucketed_scatter_combine(program, part, state, num_segments,
                                        caps, counts.members,
                                        counts.bucket_edges)
    return dense_fn()
