"""Streaming Agent-Graph partitioning (paper §5.2, Eq. 7-8).

The port's copy of `repro.core.partition`: numpy on the host, with
placements, owners and quality figures byte-identical to the JAX
package's for the same inputs.

Host-side (numpy) graph ingress, as in the paper where partitioning happens
in the loader.  Implements:

  * `greedy_partition` — the paper's greedy heuristic Eq. 8: place edge
    (u, v) on the partition maximizing src/dst affinity + load balance.
    `batch_size=1` is the exact serial stream (GRE-S); larger batches give
    the parallel-loader approximation (GRE-P / PowerGraph-oblivious, where
    loaders don't exchange heuristic state mid-stream).  Loader state is
    PACKED — the `[k, V]` has_src/has_dst presence booleans live as
    `[k, ceil(V/64)]` uint64 bitsets (8× smaller; placements bitwise
    identical, since Eq. 8 only ever reads presence as 0/1).  The
    degree-aware HDRF alternative with O(V·k/8) state lives in
    `repro_torch.core.partition_stream`.
  * `hash_partition` — the random-hash baseline (Pregel/GraphLab default).
  * `assign_owners` — master placement (most-incident-edges heuristic) and
    contiguous relabeling so each partition's masters form a dense block
    (paper §6.1.1 local renumbering, adapted to uniform XLA shapes).
  * `partition_quality` — agents/vertex, equivalent edge-cut, cut-factor,
    and the PowerGraph vertex-cut replica metrics for comparison (§7.2).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.graph.structures import Graph

DELTA = 1.0  # paper: Δ = 1.0 in Eq. 8


def _presence(bits: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Read packed presence bits: `bits` is `[k, ceil(V/64)]` uint64,
    `cols` a batch of vertex ids; returns `[k, b]` float64 0/1 — the f/g
    terms of Eq. 8, exactly what `.astype(float)` of the old bool rows
    produced."""
    return ((bits[:, cols >> 6] >> (cols & 63).astype(np.uint64))
            & np.uint64(1)).astype(np.float64)


def _set_presence(bits: np.ndarray, rows: np.ndarray,
                  cols: np.ndarray) -> None:
    """Set presence bit `cols[t]` on partition row `rows[t]` in place
    (duplicates within the batch OR harmlessly)."""
    np.bitwise_or.at(bits, (rows, cols >> 6),
                     np.uint64(1) << (cols & 63).astype(np.uint64))


def hash_partition(graph: Graph, k: int, seed: int = 0) -> np.ndarray:
    """Random vertex sharding: each vertex and its out-edges to one random
    partition (paper §1 'hash-mapping')."""
    rng = np.random.default_rng(seed)
    vertex_part = rng.integers(0, k, size=graph.num_vertices)
    return vertex_part[graph.src].astype(np.int32)


def hash_edge_cut(graph: Graph, k: int, seed: int = 0) -> float:
    """The paper's Fig. 11b red line: TRADITIONAL edge-cut rate of random
    vertex sharding — fraction of edges whose endpoints land on different
    partitions (≈ 1 − 1/k on any graph).  Agent-graph's equivalent edge-cut
    is compared against this."""
    rng = np.random.default_rng(seed)
    vp = rng.integers(0, k, size=graph.num_vertices)
    return float(np.mean(vp[graph.src] != vp[graph.dst]))


def greedy_partition(graph: Graph, k: int, batch_size: int = 256,
                     seed: int = 0, num_loaders: int = 1,
                     sync_every: int = 0) -> np.ndarray:
    """Greedy streaming edge placement, Eq. 8:

      idx = argmax_i { f(u,i) + g(v,i) + (Max - Ne(i)) / (Δ + Max - Min) }

    f(u,i)=1 iff partition i already has an edge with source u; g(v,i)
    likewise for target v; the last term balances edge load.

    Modes (paper §5.2):
      num_loaders=1, batch_size=1      — exact serial stream (GRE-S);
      num_loaders=1, batch_size>1      — batched approximation;
      num_loaders>1, sync_every=0      — OBLIVIOUS: loaders never exchange
                                         heuristic state (PowerGraph-P);
      num_loaders>1, sync_every=N      — COORDINATED: loaders merge their
                                         has_src/has_dst/load state every N
                                         local batches (PowerGraph-S-like).
    """
    V, E = graph.num_vertices, graph.num_edges
    part = np.zeros(E, dtype=np.int32)
    # split the edge stream across loaders (contiguous ranges, as when each
    # machine reads its own file chunk)
    bounds = np.linspace(0, E, num_loaders + 1).astype(np.int64)
    words = (V + 63) >> 6      # packed presence: 1 bit per (partition, vertex)
    states = [dict(has_src=np.zeros((k, words), dtype=np.uint64),
                   has_dst=np.zeros((k, words), dtype=np.uint64),
                   ne=np.zeros(k, dtype=np.int64)) for _ in range(num_loaders)]
    rngs = [np.random.default_rng(seed + i) for i in range(num_loaders)]
    cursors = [int(bounds[i]) for i in range(num_loaders)]
    # coordinated mode: the load state already replicated into every loader
    # at the last sync — subtracted at the next merge so replicas are not
    # double-counted (each loader's ne = last merged global + its own new
    # placements; summing L copies holds the merged baseline L times).
    merged_ne = np.zeros(k, dtype=np.int64)
    n_batch = 0
    active = True
    while active:
        active = False
        for li in range(num_loaders):
            lo, hi_bound = cursors[li], int(bounds[li + 1])
            if lo >= hi_bound:
                continue
            active = True
            hi = min(lo + batch_size, hi_bound)
            st = states[li]
            u = graph.src[lo:hi]
            v = graph.dst[lo:hi]
            f = _presence(st["has_src"], u)                # [k, b]
            g = _presence(st["has_dst"], v)                # [k, b]
            ne = st["ne"]
            mx, mn = ne.max(), ne.min()
            balance = (mx - ne) / (DELTA + mx - mn)        # [k]
            score = f + g + balance[:, None]
            score += rngs[li].random(score.shape) * 1e-9   # tiebreak
            idx = np.argmax(score, axis=0).astype(np.int32)
            part[lo:hi] = idx
            _set_presence(st["has_src"], idx, u)
            _set_presence(st["has_dst"], idx, v)
            np.add.at(st["ne"], idx, 1)
            cursors[li] = hi
        n_batch += 1
        if sync_every and num_loaders > 1 and n_batch % sync_every == 0:
            merged_ne = merge_loader_states(states, merged_ne, num_loaders)
    return part


def merge_loader_states(states, merged_ne: np.ndarray,
                        num_loaders: int) -> np.ndarray:
    """Coordinated-mode sync point: merge the loaders' greedy heuristic
    state in place and return the new merged load baseline.

    The OR-merge of has_src/has_dst (bitwise on the packed uint64 rows;
    identical semantics on legacy bool arrays) is idempotent, but the load
    term must
    recover the TRUE global per-partition edge count: each loader's `ne`
    is the baseline replicated at the previous sync plus its own new
    placements, so summing the copies holds the baseline `num_loaders`
    times — subtract the surplus.  (The old `sum // num_loaders` shortcut
    instead shrank the counts L-fold, compressing the balance term's
    (Max - Ne) spread and mis-weighting it against edge affinity.)
    """
    hs = np.bitwise_or.reduce([s["has_src"] for s in states])
    hd = np.bitwise_or.reduce([s["has_dst"] for s in states])
    ne = (np.sum([s["ne"] for s in states], axis=0)
          - (num_loaders - 1) * merged_ne)
    for s in states:
        s["has_src"], s["has_dst"] = hs.copy(), hd.copy()
        s["ne"] = ne.copy()
    return ne


def accumulate_owner_counts(counts: np.ndarray, src: np.ndarray,
                            dst: np.ndarray, edge_part: np.ndarray) -> None:
    """Fold one edge batch into the `[k, V]` incidence counts that master
    placement argmaxes over — the chunked ingress calls this once per
    chunk, so streaming and monolithic owners agree exactly."""
    np.add.at(counts, (edge_part, src), 1)
    np.add.at(counts, (edge_part, dst), 1)


def owners_from_counts(counts: np.ndarray) -> np.ndarray:
    """Master placement from accumulated incidence counts: each vertex is
    owned by the partition holding most of its incident edges (ties →
    lowest id); isolated vertices hash (`v % k`)."""
    k, V = counts.shape
    owner = np.argmax(counts, axis=0).astype(np.int32)
    isolated = counts.sum(axis=0) == 0
    owner[isolated] = (np.arange(V)[isolated] % k).astype(np.int32)
    return owner


def assign_owners(graph: Graph, edge_part: np.ndarray, k: int) -> np.ndarray:
    """Master placement: each vertex is owned by the partition holding most
    of its incident edges (ties → lowest id); isolated vertices hash."""
    counts = np.zeros((k, graph.num_vertices), dtype=np.int64)
    accumulate_owner_counts(counts, graph.src, graph.dst, edge_part)
    return owners_from_counts(counts)


def rebalance_owners(owner: np.ndarray, k: int, cap: int) -> np.ndarray:
    """Cap masters per partition at `cap` by moving overflow vertices to the
    least-loaded partitions (keeps XLA shapes uniform).

    Infeasible inputs (more vertices than `k * cap` total capacity) raise a
    clear ValueError up front instead of crashing mid-move on an exhausted
    receiver list; with feasible inputs an over-cap partition always implies
    some partition below cap, so the move loop cannot strand.  Ties among
    equally-loaded receivers break to the lowest partition id.
    """
    owner = owner.copy()
    counts = np.bincount(owner, minlength=k)
    if int(counts.sum()) > k * cap:
        raise ValueError(
            f"cannot rebalance {int(counts.sum())} vertices into {k} "
            f"partitions of cap {cap} ({k * cap} total slots)")
    over = [i for i in range(k) if counts[i] > cap]
    # ascending order → `min` ties break to the lowest partition id
    under = [i for i in range(k) if counts[i] < cap]
    for i in over:
        vs = np.flatnonzero(owner == i)[cap:]
        for v in vs:
            j = min(under, key=lambda x: counts[x])
            owner[v] = j
            counts[j] += 1
            if counts[j] >= cap:
                under.remove(j)
        counts[i] = cap
    return owner


@dataclasses.dataclass
class PartitionQuality:
    k: int
    num_vertices: int
    num_edges: int
    num_scatters: int
    num_combiners: int
    edge_balance: float            # max partition edges / mean (1+ε of Eq. 7)
    agents_per_vertex: float       # cut-factor for Agent-Graph (Fig. 12b/13b)
    equivalent_edge_cut: float     # agents / E (Fig. 11b)
    scatter_rate: float            # scatters / (scatters + combiners) skew
    remote_dst_edge_fraction: float  # edges terminating at a combiner agent:
    # the ⊕ partials the pipelined exchange overlaps with local compute
    # (exchange="pipelined"; see agent_graph.split_edge_tiles)
    vertexcut_replicas: int        # PowerGraph replicas R for same placement
    vertexcut_cut_factor: float    # 2 * (R - V) / V (paper §7.2)
    replication_factor: float      # R / V — the streaming-partitioner
    # objective (HDRF et al. report RF; lower RF = fewer combiner/scatter
    # agents = less exchange traffic)
    vertexcut_comm: int            # 2 * (R - V) messages per superstep
    agent_comm: int                # |Vs| + |Vc| messages per superstep (§5.1)
    local_max_out_degree: int      # max LOCAL out-degree over partitions —
    # the value that poisons a flat [cap, max_deg] frontier tile
    degree_skew: float             # local max / mean local out-degree
    # Worst-case compacted-gather work as a fraction of the partition's
    # edge scan, at the default frontier capacity: >= 1.0 means that
    # compaction strategy can never beat the dense path on this placement
    # (the flat factor >= 1 is the old static dense fallback; the bucketed
    # factor staying < 1 on skewed placements is what degree buckets buy —
    # see repro_torch.core.frontier).
    flat_tile_scan_factor: float
    bucket_tile_scan_factor: float
    # Visited fraction of the ingress-time Pallas block table over the
    # worst partition's dst-sorted, locally-DENSIFIED dst ids
    # (kernels.segment_combine.build_block_table over unique-rank
    # relabeled dsts — the ingress approximation of the per-device
    # relabeled slot space the engine's real table is built from): the
    # share of (dst block, edge block) pairs the dense-path kernel
    # computes; 1.0 would be the degenerate full table.  The
    # per-superstep DYNAMIC table's occupancy at a live frontier is
    # measured by benchmarks/bench_frontier.py.
    block_table_occupancy: float
    # Peak loader-heuristic state of the partitioner that PRODUCED this
    # placement, in bytes (0 when unknown — e.g. hash keeps none).  Passed
    # in by the caller: quality is computed from the placement alone, but
    # the bound (O(V·k/8) packed bitsets vs the old O(k·V) bools) is part
    # of the ingress-memory story bench_memory tracks.
    partitioner_state_bytes: int = 0

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def partition_quality(graph: Graph, edge_part: np.ndarray,
                      owner: Optional[np.ndarray] = None,
                      k: Optional[int] = None,
                      partitioner_state_bytes: int = 0) -> PartitionQuality:
    k = k or int(edge_part.max()) + 1
    if owner is None:
        owner = assign_owners(graph, edge_part, k)
    V, E = graph.num_vertices, graph.num_edges

    # scatter agents: (u, i) pairs where partition i has edges with source u
    # but does not own u; combiners likewise for targets (paper §5.1 defs).
    src_key = edge_part.astype(np.int64) * V + graph.src
    dst_key = edge_part.astype(np.int64) * V + graph.dst
    src_pairs, local_deg = np.unique(src_key, return_counts=True)
    dst_pairs = np.unique(dst_key)
    s_part, s_v = src_pairs // V, src_pairs % V
    c_part, c_v = dst_pairs // V, dst_pairs % V
    n_scatter = int(np.sum(owner[s_v] != s_part))
    n_combiner = int(np.sum(owner[c_v] != c_part))

    # PowerGraph vertex-cut replicas for the SAME edge placement: a replica
    # of v exists on every partition touching v (master included in R).
    all_pairs = np.unique(np.concatenate([src_pairs, dst_pairs]))
    replicas = int(all_pairs.shape[0])
    # partitions with no edge of a vertex but owning it still host the master
    touched = np.zeros(V, dtype=bool)
    touched_part_of_owner = np.zeros(V, dtype=bool)
    av_part, av_v = all_pairs // V, all_pairs % V
    touched[av_v] = True
    touched_part_of_owner[av_v[av_part == owner[av_v]]] = True
    replicas += int(np.sum(touched & ~touched_part_of_owner))
    mirrors = replicas - int(np.sum(touched))

    ne = np.bincount(edge_part, minlength=k).astype(np.float64)
    agents = n_scatter + n_combiner

    # Frontier-compaction viability of this placement: local out-degrees
    # per (partition, source) pair — `local_deg` counts each src_pairs
    # entry, so `s_part` is already its partition — binned like the
    # engine's ingress.
    from repro_torch.core.frontier import bucket_caps, default_cap
    from repro_torch.graph.structures import DEFAULT_BUCKET_BOUNDS
    deg_part = s_part
    local_max_deg = int(local_deg.max()) if local_deg.size else 0
    skew = (local_max_deg / local_deg.mean()) if local_deg.size else 0.0
    cap = default_cap(int(-(-V // k)))
    flat_factor = bucket_factor = occupancy = 0.0
    bounds = np.asarray(DEFAULT_BUCKET_BOUNDS, dtype=np.int64)
    for i in range(k):
        degs = local_deg[deg_part == i]
        if degs.size == 0 or ne[i] == 0:
            continue
        flat_factor = max(flat_factor, cap * int(degs.max()) / ne[i])
        b = np.searchsorted(bounds, degs, side="left")
        sizes = tuple(int(np.sum(b == j)) for j in range(bounds.size + 1))
        maxd = tuple(int(degs[b == j].max()) if np.any(b == j) else 0
                     for j in range(bounds.size + 1))
        caps = bucket_caps(sizes, cap)
        bucket_factor = max(
            bucket_factor,
            sum(c * d for c, d in zip(caps, maxd)) / ne[i])
        # ingress-table sparsity skipping on this partition's dst-sorted
        # edges.  The engine builds its table over RELABELED local slot
        # ids (dense per device), not global ids — a locality-aware
        # placement packs a partition's global dsts into a narrow band of
        # [0, V) and would fake near-zero occupancy — so densify the
        # partition's dst ids (unique-rank relabel) as the ingress
        # approximation of its local slot space.
        _, inv = np.unique(graph.dst[edge_part == i], return_inverse=True)
        dst_sorted = np.sort(inv).astype(np.int32)
        table = _build_block_table(dst_sorted, int(inv.max()) + 1,
                                  block_e=256, block_v=256)
        n_e = -(-dst_sorted.shape[0] // 256)
        occupancy = max(occupancy, _block_table_occupancy(table, n_e))

    return PartitionQuality(
        k=k, num_vertices=V, num_edges=E,
        num_scatters=n_scatter, num_combiners=n_combiner,
        edge_balance=float(ne.max() / max(ne.mean(), 1.0)),
        agents_per_vertex=agents / V,
        equivalent_edge_cut=agents / max(E, 1),
        scatter_rate=n_scatter / max(agents, 1),
        remote_dst_edge_fraction=float(
            np.mean(owner[graph.dst] != edge_part)) if E else 0.0,
        vertexcut_replicas=replicas,
        vertexcut_cut_factor=2.0 * mirrors / V,
        replication_factor=replicas / max(V, 1),
        vertexcut_comm=2 * mirrors,
        agent_comm=agents,
        local_max_out_degree=local_max_deg,
        degree_skew=float(skew),
        flat_tile_scan_factor=float(flat_factor),
        bucket_tile_scan_factor=float(bucket_factor),
        block_table_occupancy=float(occupancy),
        partitioner_state_bytes=int(partitioner_state_bytes),
    )


# The block table of the JAX package's TPU combine kernel, kept here only as
# the `block_table_occupancy` diagnostic of `partition_quality`; the port's
# kernels use a row pointer instead (`repro_torch.kernels.segment_combine`).
_DST_SENTINEL = np.int32(2**31 - 1)


def _build_block_table(dst_sorted: np.ndarray, num_segments: int,
                       block_e: int, block_v: int) -> np.ndarray:
    """For each dst block, the edge blocks whose (sorted) dst range
    intersects it, padded with n_edge_blocks."""
    e = dst_sorted.shape[0]
    n_e = -(-e // block_e)
    n_v = -(-num_segments // block_v)
    pad = n_e * block_e - e
    d = np.concatenate([dst_sorted, np.full(pad, _DST_SENTINEL,
                                            dst_sorted.dtype)])
    first = d.reshape(n_e, block_e).min(axis=1)
    last = d.reshape(n_e, block_e).max(axis=1)
    # padded tail edges carry sentinel dst; clip to real values present
    last = np.minimum(last, num_segments * 2)
    rows = []
    for i in range(n_v):
        lo, hi = i * block_v, (i + 1) * block_v
        hits = np.flatnonzero((last >= lo) & (first < hi))
        rows.append(hits)
    width = max(1, max(len(r) for r in rows))
    table = np.full((n_v, width), n_e, np.int32)
    for i, r in enumerate(rows):
        table[i, :len(r)] = r
    return table


def _block_table_occupancy(table, n_edge_blocks: int) -> float:
    """Visited share of the `n_v * n_edge_blocks` (dst block, edge block)
    pairs: entries below the `n_edge_blocks` skip sentinel."""
    table = np.asarray(table)
    visited = int(np.sum(table < n_edge_blocks))
    return visited / (table.shape[0] * max(n_edge_blocks, 1))
