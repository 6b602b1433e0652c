"""Benchmark vertex programs (paper Fig. 3): PageRank, SSSP, CC (+ BFS).

Each is a direct transcription of the paper's Scatter-Combine code into the
`VertexProgram` API, on the tensors of `aux`'s device.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.vertex_program import MONOIDS, VertexProgram

DAMPING = 0.85


def _device(aux) -> torch.device:
    return aux["out_degree"].device


def _full(shape, value, aux, dtype=torch.float32):
    return torch.full(shape, value, dtype=dtype, device=_device(aux))


def pagerank_program() -> VertexProgram:
    """Paper Fig. 3a / Eq. 6.

    scatter: msg = pr[src] / outdeg[src]   (scatter_data holds pr/outdeg)
    combine: pr_combine[dst] += msg        (⊕ = sum)
    apply:   pr = 0.15 + 0.85 * pr_combine; reset accumulator.
    Iterative: every vertex stays active; run a fixed number of supersteps.
    """

    def scatter_msg(src_scatter, _eprop):
        return src_scatter  # scatter_data already holds pr/outdeg

    def apply_fn(vertex_data, combined, aux):
        pr = (1.0 - DAMPING) + DAMPING * combined
        outdeg = torch.clamp(aux["out_degree"], min=1.0)
        return pr, pr / outdeg, torch.ones_like(pr, dtype=torch.bool)

    return VertexProgram(
        name="pagerank", monoid=MONOIDS["sum"],
        scatter_msg=scatter_msg, apply_fn=apply_fn,
        init_vertex_data=lambda n, aux: _full((n,), 1.0, aux),
        # First superstep scatters pr0/outdeg = 1/outdeg (paper Eq. 6a).
        init_scatter_data=lambda n, aux: 1.0 / torch.clamp(
            aux["out_degree"], min=1.0),
        init_active=lambda n, aux: _full((n,), True, aux, torch.bool),
        halts=False,
    )


def _traversal_shape(n: int, d: Optional[int]) -> tuple:
    return (n,) if d is None else (n, d)


def sssp_program(num_sources: Optional[int] = None) -> VertexProgram:
    """Paper Fig. 3b: Bellman-Ford label correcting.

    scatter: msg = oldDistance[src] + weight(e)
    combine: distance[dst] = min(distance[dst], msg); activate if improved
    apply:   oldDistance = distance; activate_scatter

    `num_sources=D` batches D roots into the payload: states become
    `[slots, D]`, ⊕ is elementwise min, and a vertex stays active while any
    lane improves (seed with `init_state(part, source=[s_0..s_D])`).
    """
    D = num_sources

    def scatter_msg(src_scatter, weight):
        return src_scatter + (weight if D is None else weight[:, None])

    def combine_activates(old_vd, combined):
        improved = combined < old_vd  # strictly improving messages only
        return improved if D is None else improved.any(dim=-1)

    def apply_fn(vertex_data, combined, _aux):
        dist = torch.minimum(vertex_data, combined)
        return dist, dist, torch.ones(dist.shape[0], dtype=torch.bool,
                                      device=dist.device)

    return VertexProgram(
        name="sssp" if D is None else f"sssp_x{D}", monoid=MONOIDS["min"],
        scatter_msg=scatter_msg, apply_fn=apply_fn,
        init_vertex_data=lambda n, aux: _full(_traversal_shape(n, D),
                                              math.inf, aux),
        init_scatter_data=lambda n, aux: _full(_traversal_shape(n, D),
                                               math.inf, aux),
        init_active=lambda n, aux: _full((n,), False, aux, torch.bool),
        combine_activates=combine_activates,
        halts=True, needs_edge_prop="weight", invalidation="path",
        payload_shape=() if D is None else (D,),
        lane_activates=None if D is None else (lambda vd, c: c < vd),
    )


def cc_program() -> VertexProgram:
    """Paper Fig. 3c: label propagation on undirected graphs.

    Every vertex starts labeled with its own (global) id and active; labels
    propagate by min-combine until no label changes.
    """

    def scatter_msg(src_scatter, _eprop):
        return src_scatter

    def combine_activates(old_vd, combined):
        return combined < old_vd

    def apply_fn(vertex_data, combined, _aux):
        label = torch.minimum(vertex_data, combined)
        return label, label, torch.ones_like(label, dtype=torch.bool)

    def init_labels(n, aux):
        if "global_id" in aux:
            gid = aux["global_id"]
            return torch.where(gid >= 0, gid, math.inf).to(torch.float32)
        return torch.arange(n, dtype=torch.float32, device=_device(aux))

    return VertexProgram(
        name="cc", monoid=MONOIDS["min"],
        scatter_msg=scatter_msg, apply_fn=apply_fn,
        init_vertex_data=init_labels,
        init_scatter_data=init_labels,
        init_active=lambda n, aux: _full((n,), True, aux, torch.bool),
        combine_activates=combine_activates, halts=True,
        invalidation="component",
    )


def bfs_program(num_sources: Optional[int] = None) -> VertexProgram:
    """BFS depth = SSSP with unit weights (paper §4.2 traversal family).

    `num_sources=D` is the multi-source batched variant: payload `(D,)`,
    ⊕ = elementwise min, one pass for D roots.
    """
    D = num_sources

    def scatter_msg(src_scatter, _eprop):
        return src_scatter + 1.0

    def combine_activates(old_vd, combined):
        improved = combined < old_vd
        return improved if D is None else improved.any(dim=-1)

    def apply_fn(vertex_data, combined, _aux):
        depth = torch.minimum(vertex_data, combined)
        return depth, depth, torch.ones(depth.shape[0], dtype=torch.bool,
                                        device=depth.device)

    return VertexProgram(
        name="bfs" if D is None else f"bfs_x{D}", monoid=MONOIDS["min"],
        scatter_msg=scatter_msg, apply_fn=apply_fn,
        init_vertex_data=lambda n, aux: _full(_traversal_shape(n, D),
                                              math.inf, aux),
        init_scatter_data=lambda n, aux: _full(_traversal_shape(n, D),
                                               math.inf, aux),
        init_active=lambda n, aux: _full((n,), False, aux, torch.bool),
        combine_activates=combine_activates, halts=True,
        invalidation="path",
        payload_shape=() if D is None else (D,),
        lane_activates=None if D is None else (lambda vd, c: c < vd),
    )


def degree_program() -> VertexProgram:
    """In-degree via one superstep of sum-combine (sanity workload)."""

    def scatter_msg(src_scatter, _eprop):
        return torch.ones_like(src_scatter)

    def apply_fn(vertex_data, combined, _aux):
        return combined, combined, torch.zeros_like(combined, dtype=torch.bool)

    return VertexProgram(
        name="degree", monoid=MONOIDS["sum"],
        scatter_msg=scatter_msg, apply_fn=apply_fn,
        init_vertex_data=lambda n, aux: _full((n,), 0.0, aux),
        init_scatter_data=lambda n, aux: _full((n,), 0.0, aux),
        init_active=lambda n, aux: _full((n,), True, aux, torch.bool),
        halts=True,
    )
