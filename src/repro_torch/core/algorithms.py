"""Benchmark vertex programs (paper Fig. 3): PageRank, SSSP, CC (+ BFS).

Each is a direct transcription of the paper's Scatter-Combine code into the
`VertexProgram` API, on the tensors of `aux`'s device.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from repro_torch.core.vertex_program import MONOIDS, VertexProgram
from repro_torch.kernels import gather_messages

DAMPING = 0.85


def _device(aux) -> torch.device:
    return aux["out_degree"].device


def _full(shape, value, aux, dtype=torch.float32):
    return torch.full(shape, value, dtype=dtype, device=_device(aux))


def _declared(form: str) -> dict:
    """A program's `message` form and the `scatter_msg` it defines
    (`kernels.gather_messages.form_messages`, `[E]` or `[E, D]`): one
    declaration, so the dense scan's kernel and every other route form the
    same message."""
    return {"message": form, "scatter_msg": functools.partial(
        gather_messages.form_messages, form)}


def pagerank_program() -> VertexProgram:
    """Paper Fig. 3a / Eq. 6.

    scatter: msg = pr[src] / outdeg[src]   (scatter_data holds pr/outdeg)
    combine: pr_combine[dst] += msg        (⊕ = sum)
    apply:   pr = 0.15 + 0.85 * pr_combine; reset accumulator.
    Iterative: every vertex stays active; run a fixed number of supersteps.
    The message is a copy: scatter_data already holds pr/outdeg.
    """

    def apply_fn(vertex_data, combined, aux):
        pr = (1.0 - DAMPING) + DAMPING * combined
        outdeg = torch.clamp(aux["out_degree"], min=1.0)
        return pr, pr / outdeg, torch.ones_like(pr, dtype=torch.bool)

    return VertexProgram(
        name="pagerank", monoid=MONOIDS["sum"], **_declared("copy"),
        apply_fn=apply_fn,
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

    def combine_activates(old_vd, combined):
        improved = combined < old_vd  # strictly improving messages only
        return improved if D is None else improved.any(dim=-1)

    def apply_fn(vertex_data, combined, _aux):
        dist = torch.minimum(vertex_data, combined)
        return dist, dist, torch.ones(dist.shape[0], dtype=torch.bool,
                                      device=dist.device)

    return VertexProgram(
        name="sssp" if D is None else f"sssp_x{D}", monoid=MONOIDS["min"],
        **_declared("add_prop"), apply_fn=apply_fn,
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
        name="cc", monoid=MONOIDS["min"], **_declared("copy"),
        apply_fn=apply_fn,
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

    def combine_activates(old_vd, combined):
        improved = combined < old_vd
        return improved if D is None else improved.any(dim=-1)

    def apply_fn(vertex_data, combined, _aux):
        depth = torch.minimum(vertex_data, combined)
        return depth, depth, torch.ones(depth.shape[0], dtype=torch.bool,
                                        device=depth.device)

    return VertexProgram(
        name="bfs" if D is None else f"bfs_x{D}", monoid=MONOIDS["min"],
        **_declared("add_one"), apply_fn=apply_fn,
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


def ppr_push_program(num_sources: int, alpha: float = 0.15,
                     eps: float = 1e-4) -> VertexProgram:
    """Personalized PageRank by monotone forward push (Andersen-Chung-Lang),
    batched over D payload lanes: the third traversal family the serving
    layer (`repro_torch.serving.graph_scheduler`) answers.

    Per (vertex, lane) the state is an (estimate p, held residual r) pair:
    `vertex_data` is `[n, D, 2]`.  A vertex whose total residual in lane d
    exceeds `eps` PUSHES: p += α·r, and (1-α)·r/outdeg is scattered along
    its out-edges (⊕ = sum accumulates incoming residual mass); sub-`eps`
    residual is held until new mass arrives.  Active messages are the
    pushes, so the frontier is exactly the above-threshold vertices and a
    lane with no push anywhere has converged (`lane_activates`).

    Seeding (`seed_sources`) performs the source's own first push at
    admission: p[s] = α, scatter share (1-α)/outdeg(s) staged, so the next
    superstep delivers it.  It writes the given tensors in place and
    returns them.  Lanes evolve independently (pushes are decided per
    lane), which is what makes lane recycling bitwise-safe for this
    program despite the sum monoid, as long as the scan visits the edges
    in a fixed order (the serving layer pins the dense frontier).
    """
    D = num_sources

    def combine_activates(_old_vd, combined):
        return (combined > 0.0).any(dim=-1)  # received any mass

    def apply_fn(vertex_data, combined, aux):
        p_est, r_hold = vertex_data[..., 0], vertex_data[..., 1]
        r_total = r_hold + combined
        push = r_total > eps
        new_p = p_est + torch.where(push, alpha * r_total, 0.0)
        deg = torch.clamp(aux["out_degree"], min=1.0)[:, None]
        new_sd = torch.where(push, (1.0 - alpha) * r_total / deg, 0.0)
        new_r = torch.where(push, 0.0, r_total)
        new_vd = torch.stack([new_p, new_r], dim=-1)
        return new_vd, new_sd, push.any(dim=-1)

    def lane_activates(vertex_data, combined):
        return (vertex_data[..., 1] + combined) > eps  # a push will happen

    def seed_sources(vd, sd, src, lanes, aux):
        deg = torch.clamp(aux["out_degree"], min=1.0)
        src = src.to(torch.int64)
        lanes = lanes.to(torch.int64)
        vd[src, lanes, 0] = alpha
        vd[src, lanes, 1] = 0.0
        sd[src, lanes] = (1.0 - alpha) / deg[src]
        return vd, sd

    return VertexProgram(
        name=f"ppr_x{D}", monoid=MONOIDS["sum"],
        # a copy: scatter_data already holds (1-α)·r/outdeg
        **_declared("copy"),
        apply_fn=apply_fn,
        init_vertex_data=lambda n, aux: _full((n, D, 2), 0.0, aux),
        init_scatter_data=lambda n, aux: _full((n, D), 0.0, aux),
        init_active=lambda n, aux: _full((n,), False, aux, torch.bool),
        combine_activates=combine_activates, halts=True,
        payload_shape=(D,),
        lane_activates=lane_activates, seed_sources=seed_sources,
        lane_view=lambda vd, lane: vd[:, lane, 0],
    )


def gnn_aggregate_program(d_feat: int,
                          edge_weighted: bool = False) -> VertexProgram:
    """One-superstep neighborhood aggregation with feature-vector payloads.

    The GNN layer propagation h' = A·h IS the Scatter-Combine primitive with
    payload_shape = (D,): scatter the [slots, D] feature rows, ⊕ = sum at
    the destinations (optionally edge-weighted, e.g. GCN's symmetric
    normalization via the "edge_norm" edge property).  Running it through
    the engine gives full-batch GNN aggregation the engine's combine kernel.
    """

    def weighted_msg(src_scatter, edge_norm):
        return src_scatter * edge_norm[:, None]

    def apply_fn(vertex_data, combined, _aux):
        return combined, combined, torch.zeros(
            combined.shape[0], dtype=torch.bool, device=combined.device)

    return VertexProgram(
        name="gnn_aggregate", monoid=MONOIDS["sum"],
        **({"scatter_msg": weighted_msg} if edge_weighted
           else _declared("copy")),
        apply_fn=apply_fn,
        init_vertex_data=lambda n, aux: _full((n, d_feat), 0.0, aux),
        init_scatter_data=lambda n, aux: _full((n, d_feat), 0.0, aux),
        init_active=lambda n, aux: _full((n,), True, aux, torch.bool),
        halts=True, payload_shape=(d_feat,),
        needs_edge_prop="edge_norm" if edge_weighted else None,
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
