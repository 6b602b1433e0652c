"""Graph topology containers and host-side ingress layouts (numpy).

The port's copy of `repro.graph.structures`: a `Graph` is COO edge arrays
(src, dst) plus optional per-edge/per-vertex property columns.  Ingress is
a host-side pass (paper §6.1.1); `repro_torch.core.engine.DevicePartition`
moves its output to the device.  Every function here gives byte-identical
results to its counterpart in the JAX package, so both engines see the
same padded columns, CSR index and degree buckets.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class Graph:
    """Directed property graph in COO form (host-side)."""

    num_vertices: int
    src: np.ndarray  # [E] source vertex ids
    dst: np.ndarray  # [E] destination vertex ids
    edge_props: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    vertex_props: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.src = np.asarray(self.src, dtype=np.int64)
        self.dst = np.asarray(self.dst, dtype=np.int64)
        assert self.src.shape == self.dst.shape
        for k, v in self.edge_props.items():
            assert len(v) == self.num_edges, f"edge prop {k} length mismatch"

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    def out_degree(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.num_vertices).astype(np.int64)

    def in_degree(self) -> np.ndarray:
        return np.bincount(self.dst, minlength=self.num_vertices).astype(np.int64)

    def reversed(self) -> "Graph":
        """Transposed graph (paper §4.2: backward traversal)."""
        return Graph(self.num_vertices, self.dst.copy(), self.src.copy(),
                     {k: v.copy() for k, v in self.edge_props.items()},
                     {k: v.copy() for k, v in self.vertex_props.items()})

    def as_undirected(self) -> "Graph":
        """Each undirected edge becomes two directed edges (paper §2.1)."""
        src = np.concatenate([self.src, self.dst])
        dst = np.concatenate([self.dst, self.src])
        props = {k: np.concatenate([v, v]) for k, v in self.edge_props.items()}
        return Graph(self.num_vertices, src, dst, props, dict(self.vertex_props))

    def apply_edge_delta(self, delta: "EdgeDelta") -> "Graph":
        """The COO-level mutation (host-side reference semantics): retire
        every live instance of each removed pair, then append the added
        edges.  The partition-level deltas
        (`repro_torch.core.engine.DevicePartition.apply_edge_delta`,
        `repro_torch.core.agent_graph.apply_edge_delta`) agree with
        rebuilding from this graph."""
        keep = ~validate_edge_delta(
            delta, self.num_vertices,
            live_keys=(self.src.astype(np.int64) *
                       np.int64(self.num_vertices) +
                       self.dst.astype(np.int64)))
        for k in self.edge_props:
            if k not in delta.add_props and delta.num_adds:
                raise KeyError(f"delta adds missing edge prop {k!r}")
        src = np.concatenate([self.src[keep], delta.add_src])
        dst = np.concatenate([self.dst[keep], delta.add_dst])
        props = {k: np.concatenate([v[keep],
                                    np.asarray(delta.add_props[k], v.dtype)
                                    if delta.num_adds else v[:0]])
                 for k, v in self.edge_props.items()}
        return Graph(self.num_vertices, src, dst, props,
                     dict(self.vertex_props))

    def iter_edge_chunks(self, chunk_size: int):
        """Yield the edge stream as `EdgeChunk` slices of at most
        `chunk_size` rows, in stream order (the chunk-source protocol's
        reference producer, see `EdgeChunkSource`)."""
        for lo in range(0, self.num_edges, chunk_size):
            hi = min(lo + chunk_size, self.num_edges)
            yield EdgeChunk(
                src=self.src[lo:hi], dst=self.dst[lo:hi],
                props={k: v[lo:hi] for k, v in self.edge_props.items()},
                offset=lo)

    def chunk_source(self, chunk_size: int) -> "EdgeChunkSource":
        """Wrap this in-memory graph as an `EdgeChunkSource` (views, no
        copies), so the chunked ingress reads it through the same protocol
        an out-of-core producer implements."""
        return EdgeChunkSource(
            num_vertices=self.num_vertices, num_edges=self.num_edges,
            prop_dtypes={k: v.dtype for k, v in self.edge_props.items()},
            chunks=lambda: self.iter_edge_chunks(chunk_size))

    def dedup(self) -> "Graph":
        """Drop duplicate (src, dst) pairs and self loops."""
        keep = self.src != self.dst
        key = self.src[keep] * np.int64(self.num_vertices) + self.dst[keep]
        _, idx = np.unique(key, return_index=True)
        sel = np.flatnonzero(keep)[idx]
        props = {k: v[sel] for k, v in self.edge_props.items()}
        return Graph(self.num_vertices, self.src[sel], self.dst[sel], props,
                     dict(self.vertex_props))


@dataclasses.dataclass
class EdgeChunk:
    """One contiguous slice of an edge stream, in stream order: the unit
    the streaming partitioners (`repro_torch.core.partition_stream`) and
    the chunked `build_agent_graph` consume, so the host never holds a
    second full copy of the edge list."""

    src: np.ndarray                 # [b] source vertex ids
    dst: np.ndarray                 # [b] destination vertex ids
    props: Dict[str, np.ndarray]    # per-edge property slices, each [b]
    offset: int                     # stream position of row 0

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])


@dataclasses.dataclass
class EdgeChunkSource:
    """The chunk-source protocol: restartable edge-stream metadata.

    `chunks()` returns a fresh iterator over the stream (multi-pass ingress:
    `build_agent_graph` streams once to size the per-shard tiles and once
    to fill them); `num_vertices`, `num_edges` and `prop_dtypes` are the
    only whole-graph facts a consumer may rely on.  `Graph.chunk_source` is
    the in-memory implementation.
    """

    num_vertices: int
    num_edges: int
    prop_dtypes: Dict[str, np.dtype]
    chunks: "object"                # callable -> iterator of EdgeChunk


def as_chunk_source(graph_or_source, chunk_size: int = 1 << 18):
    """Accept either a `Graph` or an `EdgeChunkSource`-shaped object."""
    if hasattr(graph_or_source, "chunks"):
        return graph_or_source
    return graph_or_source.chunk_source(chunk_size)


@dataclasses.dataclass
class EdgeDelta:
    """A batch of edge mutations in ORIGINAL vertex ids.

    `removes` retire every live instance of each (src, dst) pair; a pair
    matching no live edge is rejected up front (`validate_edge_delta`), as
    are out-of-range ids and within-batch duplicate add rows.  `adds`
    append otherwise unconditionally (multi-edges across batches stay
    legal, as in `Graph`'s COO semantics).  `add_props` must supply a
    column for every edge property the target graph carries: zero-filling
    a weight would silently create zero-cost edges.
    """

    add_src: np.ndarray = None
    add_dst: np.ndarray = None
    add_props: Dict[str, np.ndarray] = None
    rem_src: np.ndarray = None
    rem_dst: np.ndarray = None

    def __post_init__(self):
        def ids(a):
            return (np.zeros(0, np.int64) if a is None
                    else np.asarray(a, dtype=np.int64).reshape(-1))
        self.add_src, self.add_dst = ids(self.add_src), ids(self.add_dst)
        self.rem_src, self.rem_dst = ids(self.rem_src), ids(self.rem_dst)
        assert self.add_src.shape == self.add_dst.shape
        assert self.rem_src.shape == self.rem_dst.shape
        self.add_props = {k: np.asarray(v)
                          for k, v in (self.add_props or {}).items()}
        for k, v in self.add_props.items():
            assert v.shape[0] == self.num_adds, f"add prop {k} length"

    @property
    def num_adds(self) -> int:
        return int(self.add_src.shape[0])

    @property
    def num_removes(self) -> int:
        return int(self.rem_src.shape[0])


@dataclasses.dataclass
class DeltaReport:
    """What an `apply_edge_delta` did, in ORIGINAL vertex ids.

    The warm-start seeding rules (`repro_torch.core.incremental`) read it:
    `added_src` endpoints are re-activated so new edges deliver, and
    `removed_dst` endpoints seed the min-monoid invalidation pass.
    `removed_*` list every retired live edge instance (a pair matching two
    parallel edges appears twice); `compacted` flags that the spare
    capacity ran out and the edge/agent shapes were rebuilt.
    """

    added_src: np.ndarray
    added_dst: np.ndarray
    removed_src: np.ndarray
    removed_dst: np.ndarray
    compacted: bool = False

    @property
    def num_adds(self) -> int:
        return int(self.added_src.shape[0])

    @property
    def num_removed(self) -> int:
        return int(self.removed_src.shape[0])


def _offending(rows: np.ndarray, limit: int = 8) -> str:
    shown = ", ".join(str(int(r)) for r in rows[:limit])
    more = f", ... ({rows.shape[0]} total)" if rows.shape[0] > limit else ""
    return shown + more


def validate_edge_delta(delta: "EdgeDelta", num_vertices: int,
                        live_keys: Optional[np.ndarray] = None
                        ) -> Optional[np.ndarray]:
    """Up-front `EdgeDelta` validation shared by every delta-ingress path
    (`Graph.apply_edge_delta`, `DevicePartition.apply_edge_delta`,
    `agent_graph.apply_edge_delta`), so a malformed batch fails with the
    offending ROW INDICES: out-of-range ids, a duplicated add row, or a
    removal matching no live edge.  Every path raises the same error, with
    the same message, for the same delta.

    `live_keys` is the caller's pre-delta live edge set as `src * V + dst`
    int64 keys in ORIGINAL vertex ids; without it the liveness check is
    skipped.  Returns the rows of `live_keys` that the removals retire
    (`match_removals`), or None without `live_keys`.
    """
    V = np.int64(num_vertices)
    for label, ids in (("add_src", delta.add_src),
                       ("add_dst", delta.add_dst),
                       ("rem_src", delta.rem_src),
                       ("rem_dst", delta.rem_dst)):
        bad = np.flatnonzero((ids < 0) | (ids >= V))
        if bad.size:
            raise ValueError(
                f"EdgeDelta.{label} has out-of-range vertex ids at rows "
                f"[{_offending(bad)}]: values "
                f"[{_offending(ids[bad])}] outside [0, {num_vertices})")
    if delta.num_adds:
        keys = delta.add_src * V + delta.add_dst
        _, first, counts = np.unique(keys, return_index=True,
                                     return_counts=True)
        if np.any(counts > 1):
            dup_mask = np.ones(keys.shape[0], dtype=bool)
            dup_mask[first] = False
            dup = np.flatnonzero(dup_mask)
            raise ValueError(
                f"EdgeDelta add batch repeats (src, dst) pairs at rows "
                f"[{_offending(dup)}] — duplicate rows in one batch are "
                f"almost always a construction bug; submit parallel edges "
                f"in separate deltas")
    if live_keys is None:
        return None
    sel, dead = match_removals(live_keys, delta.rem_src * V + delta.rem_dst)
    if dead.size:
        pairs = [f"({int(delta.rem_src[r])}, {int(delta.rem_dst[r])})"
                 for r in dead[:8]]
        raise ValueError(
            f"EdgeDelta removal rows [{_offending(dead)}] match no "
            f"live edge (already tombstoned or never present): "
            f"{', '.join(pairs)}")
    return sel


def removal_selector(src: np.ndarray, dst: np.ndarray, rem_src: np.ndarray,
                     rem_dst: np.ndarray, id_space: int) -> np.ndarray:
    """Boolean selector over (src, dst) rows matching any removed pair.

    `id_space` must exceed every id in play (keys are `src * id_space +
    dst`); callers pass original |V| or the local slot count.
    """
    n = np.int64(id_space)
    return match_removals(
        src.astype(np.int64) * n + dst.astype(np.int64),
        rem_src.astype(np.int64) * n + rem_dst.astype(np.int64))[0]


def stable_argsort(keys: np.ndarray, device=None) -> np.ndarray:
    """`np.argsort(keys, kind="stable")`: the unique stable permutation,
    computed by `torch.sort(stable=True)` on `device` when one is given
    (the ingress of a partition sorts on the partition's device)."""
    keys = np.asarray(keys)
    if device is None or keys.size == 0:
        return np.argsort(keys, kind="stable")
    import torch
    t = torch.from_numpy(np.ascontiguousarray(keys)).to(device)
    return torch.sort(t, stable=True).indices.cpu().numpy()


def merge_order(sorted_keys: np.ndarray, extra: np.ndarray) -> np.ndarray:
    """`np.argsort(np.concatenate([sorted_keys, extra]), kind="stable")`
    for keys whose first part is already sorted: a stable merge of the
    sorted run with the stably sorted `extra`, O(n) beside the small
    sort."""
    n, a = sorted_keys.shape[0], extra.shape[0]
    ob = np.argsort(extra, kind="stable")
    pos = np.searchsorted(sorted_keys, extra[ob], side="right") + np.arange(a)
    order = np.empty(n + a, dtype=np.int64)
    at_extra = np.zeros(n + a, dtype=bool)
    at_extra[pos] = True
    order[pos] = n + ob
    order[~at_extra] = np.arange(n)
    return order


def match_removals(keys: np.ndarray, rem_keys: np.ndarray):
    """`(np.isin(keys, rem_keys), np.flatnonzero(~np.isin(rem_keys,
    keys)))`: the rows of `keys` that a removal retires, and the removal
    rows that match none, for int64 keys such as `src * n + dst`.  Only
    keys whose 24-bit hash occurs among the removals' can match, so both
    membership tests run on those candidates, a small share of `keys`."""
    keys = np.asarray(keys, np.int64)
    rem_keys = np.asarray(rem_keys, np.int64)
    if rem_keys.size == 0 or keys.size == 0:
        return (np.zeros(keys.shape[0], dtype=bool),
                np.arange(rem_keys.shape[0]) if keys.size == 0
                else np.zeros(0, np.int64))

    def hash24(k):   # Fibonacci hashing: every bit of the key mixes in
        return ((k.view(np.uint64) * np.uint64(0x9E3779B97F4A7C15))
                >> np.uint64(40)).astype(np.int64)

    seen = np.zeros(1 << 24, dtype=bool)
    seen[hash24(rem_keys)] = True
    cand = np.flatnonzero(seen[hash24(keys)])
    ck = keys[cand]
    sel = np.zeros(keys.shape[0], dtype=bool)
    sel[cand[np.isin(ck, rem_keys)]] = True
    dead = np.flatnonzero(~np.isin(rem_keys, ck))
    return sel, dead


@dataclasses.dataclass
class CSR:
    """Compressed sparse row adjacency: dst-sorted or src-sorted edge list."""

    num_vertices: int
    indptr: np.ndarray   # [V+1]
    indices: np.ndarray  # [E] neighbor ids
    edge_ids: np.ndarray  # [E] position of each CSR slot in the original COO

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]


def coo_to_csr(src: np.ndarray, dst: np.ndarray, num_vertices: int,
               by: str = "src") -> CSR:
    """Build CSR sorted by `src` (out-adjacency) or `dst` (in-adjacency)."""
    key, other = (src, dst) if by == "src" else (dst, src)
    order = np.argsort(key, kind="stable")
    counts = np.bincount(key, minlength=num_vertices)
    indptr = np.zeros(num_vertices + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return CSR(num_vertices, indptr, other[order].astype(np.int64),
               order.astype(np.int64))


def pad_edges(src: np.ndarray, dst: np.ndarray, target: int,
              pad_vertex: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad COO edge arrays to a static length.

    Padded slots point `pad_vertex -> pad_vertex` and are masked out via the
    returned validity mask.  `pad_vertex` is the dedicated sink slot
    (== num_local_slots - 1) so combines on padding never touch real state.
    """
    e = src.shape[0]
    assert target >= e, (target, e)
    mask = np.zeros(target, dtype=bool)
    mask[:e] = True
    ps = np.full(target, pad_vertex, dtype=np.int32)
    pd = np.full(target, pad_vertex, dtype=np.int32)
    ps[:e] = src
    pd[:e] = dst
    return ps, pd, mask


def csr_layout(src: np.ndarray, edge_mask: np.ndarray, num_slots: int,
               device=None) -> tuple[np.ndarray, np.ndarray, int]:
    """Src-sorted secondary index over padded (typically dst-sorted) edges.

    Returns `(indptr [num_slots+1], eidx [E_pad], max_deg)`: `eidx[p]` is
    where the p-th src-sorted real edge lives in the padded columns, so the
    frontier gather (`repro_torch.core.frontier`) reads `dst[eidx]` and
    `props[eidx]` from the canonical dst-sorted columns.  Padded edges
    (mask False) are excluded, so `max_deg` is the true maximum out-degree.
    `device` is where the src sort runs (`stable_argsort`).
    """
    real = np.flatnonzero(edge_mask)
    order = real[stable_argsort(src[real], device)]
    counts = np.bincount(src[real], minlength=num_slots).astype(np.int64)
    indptr = np.zeros(num_slots + 1, dtype=np.int32)
    indptr[1:] = np.cumsum(counts)
    eidx = np.zeros(src.shape[0], dtype=np.int32)
    eidx[:order.shape[0]] = order
    return indptr, eidx, int(counts.max()) if counts.size else 0


# Degree-bucket upper bounds (inclusive): bucket b holds slots whose local
# out-degree d satisfies bounds[b-1] < d <= bounds[b]; one extra unbounded
# bucket catches the hubs.
DEFAULT_BUCKET_BOUNDS = (8, 32, 128, 512)


def degree_buckets(indptr: np.ndarray, num_slots: int,
                   bounds: tuple = DEFAULT_BUCKET_BOUNDS
                   ) -> tuple[np.ndarray, tuple, tuple]:
    """Bin slots by local out-degree into `len(bounds) + 1` buckets.

    Returns `(bucket_id [num_slots] int32, sizes, max_degs)`.  `bucket_id`
    is -1 for slots with no out-edges (they never emit a message, so no
    bucket spends capacity on them); `sizes[b]` and `max_degs[b]` are the
    member count and true max degree per bucket (0 for empty buckets).
    """
    deg = np.diff(indptr[:num_slots + 1]).astype(np.int64)
    nb = len(bounds) + 1
    bucket = np.searchsorted(np.asarray(bounds, dtype=np.int64), deg,
                             side="left").astype(np.int32)
    bucket_id = np.where(deg > 0, bucket, -1).astype(np.int32)
    sizes, max_degs = [], []
    for b in range(nb):
        members = deg[bucket_id == b]
        sizes.append(int(members.shape[0]))
        max_degs.append(int(members.max()) if members.size else 0)
    return bucket_id, tuple(sizes), tuple(max_degs)
