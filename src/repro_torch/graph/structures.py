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

    def dedup(self) -> "Graph":
        """Drop duplicate (src, dst) pairs and self loops."""
        keep = self.src != self.dst
        key = self.src[keep] * np.int64(self.num_vertices) + self.dst[keep]
        _, idx = np.unique(key, return_index=True)
        sel = np.flatnonzero(keep)[idx]
        props = {k: v[sel] for k, v in self.edge_props.items()}
        return Graph(self.num_vertices, self.src[sel], self.dst[sel], props,
                     dict(self.vertex_props))


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


def csr_layout(src: np.ndarray, edge_mask: np.ndarray, num_slots: int
               ) -> tuple[np.ndarray, np.ndarray, int]:
    """Src-sorted secondary index over padded (typically dst-sorted) edges.

    Returns `(indptr [num_slots+1], eidx [E_pad], max_deg)`: `eidx[p]` is
    where the p-th src-sorted real edge lives in the padded columns, so the
    frontier gather (`repro_torch.core.frontier`) reads `dst[eidx]` and
    `props[eidx]` from the canonical dst-sorted columns.  Padded edges
    (mask False) are excluded, so `max_deg` is the true maximum out-degree.
    """
    real = np.flatnonzero(edge_mask)
    order = real[np.argsort(src[real], kind="stable")]
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


def sort_edges_by_dst(src: np.ndarray, dst: np.ndarray,
                      edge_props: Optional[Dict[str, np.ndarray]] = None):
    """Sort COO edges by destination (the combine key).

    Dst-sorted order makes the ⊕ a contiguous segmented reduction: the
    combine kernel walks each destination's edge range through a row
    pointer (`repro_torch.kernels.segment_combine.segment_row_pointer`).
    """
    order = np.argsort(dst, kind="stable")
    props = {k: v[order] for k, v in (edge_props or {}).items()}
    return src[order], dst[order], props, order
