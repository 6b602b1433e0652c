"""Multi-stage algorithms (paper §4.2): "with simple extension of backward
traversal on transposed graphs, GRE implements multi-staged algorithms like
Betweenness Centrality".

Brandes' algorithm as TWO staged VertexPrograms through the canonical
engine superstep:

  stage 1+2  forward σ   — FORWARD partition, vector payload (D, 3):
             per source lane d, msg = [frontier flag, depth+1, σ]; ⊕ = sum.
             BFS depth and shortest-path counts compute in one pass: an
             unvisited lane receiving flag > 0 folds
             depth = Σ(depth+1)/Σflag (all frontier parents share one
             depth, level-synchronous BSP) and σ = Σ σ_parent, then joins
             that lane's frontier.  Apply zeroes every lane that did not
             JUST join, so re-activated vertices contribute nothing on
             already-settled lanes.
  stage 3    backward δ  — TRANSPOSED partition, payload (D,): levels run
             DESCENDING, scheduled off the superstep counter the engine
             injects as aux["step"]: lanes at level dmax-i scatter (1+δ)/σ
             at superstep i (other lanes hold the sum identity 0);
             receivers one level up fold δ += σ·⊕.  Level-synchrony makes
             every folded edge a shortest-path-DAG edge.

Source batching is in the payload: one engine pass serves the D sources of
a batch.  Both stages run the combine kernel's sum (`repro_torch.kernels`):
the forward stage at D = 3·batch, the backward at D = batch, each on the
dense or the tile route as the frontier plan picks.  The JAX package's
`repro.core.multistage`, run eagerly here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.engine import (DevicePartition, EngineState, GREEngine,
                                     resolve_device)
from repro_torch.core.vertex_program import MONOIDS, VertexProgram
from repro_torch.graph.structures import Graph


def _dev(aux) -> torch.device:
    return aux["out_degree"].device


def bc_forward_program(num_sources: int) -> VertexProgram:
    """Stage 1+2: BFS depth + σ for D sources in one forward pass.

    vertex_data is [n, D, 2] = (depth, σ); scatter_data IS the message
    triple [n, D, 3] = (frontier flag, depth+1, σ), zeroed on lanes off the
    current frontier so ⊕ = sum ignores them.
    """
    D = num_sources

    def scatter_msg(src_scatter, _eprop):
        return src_scatter  # apply pre-builds the gated (flag, depth+1, σ)

    def combine_activates(old_vd, combined):
        newly = torch.isinf(old_vd[..., 0]) & (combined[..., 0] > 0)
        return newly.any(dim=-1)

    def apply_fn(vertex_data, combined, _aux):
        newly = torch.isinf(vertex_data[..., 0]) & (combined[..., 0] > 0)
        depth = combined[..., 1] / torch.clamp(combined[..., 0], min=1.0)
        sigma = combined[..., 2]
        new_vd = torch.where(newly[..., None],
                             torch.stack([depth, sigma], dim=-1), vertex_data)
        sd = torch.where(newly[..., None],
                         torch.stack([torch.ones_like(depth), depth + 1.0,
                                      sigma], dim=-1), 0.0)
        return new_vd, sd, newly.any(dim=-1)

    def init_unvisited(n, aux):
        return torch.stack(
            [torch.full((n, D), math.inf, device=_dev(aux)),
             torch.zeros((n, D), device=_dev(aux))], dim=-1)

    return VertexProgram(
        name="bc_forward", monoid=MONOIDS["sum"],
        scatter_msg=scatter_msg, apply_fn=apply_fn,
        init_vertex_data=init_unvisited,
        init_scatter_data=lambda n, aux: torch.zeros((n, D, 3),
                                                     device=_dev(aux)),
        init_active=lambda n, aux: torch.zeros(n, dtype=torch.bool,
                                               device=_dev(aux)),
        combine_activates=combine_activates, halts=True,
        payload_shape=(D, 3))


def bc_backward_program(num_sources: int) -> VertexProgram:
    """Stage 3: δ accumulation, level-synchronous by DESCENDING depth.

    Needs aux columns "depth", "sigma" ([n, D] stage-1/2 outputs) and the
    scalar "dmax" (the largest finite depth over lanes); the engine injects
    "step".  Runs on the TRANSPOSED partition.  A lane scatters only at its
    level's superstep; off-level lanes hold the sum identity 0.
    """
    D = num_sources

    def scatter_msg(src_scatter, _eprop):
        return src_scatter  # (1 + δ_v) / σ_v on the level's lanes, else 0

    def apply_fn(delta, combined, aux):
        tgt = aux["dmax"] - float(aux["step"]) - 1.0
        fold = aux["depth"] == tgt                       # [n, D]
        new_delta = torch.where(fold, delta + aux["sigma"] * combined, delta)
        sd = torch.where(fold, (1.0 + new_delta)
                         / torch.clamp(aux["sigma"], min=1.0), 0.0)
        return new_delta, sd, fold.any(dim=-1)

    def init_scatter(n, aux):
        top = aux["depth"] == aux["dmax"]
        return torch.where(top, 1.0 / torch.clamp(aux["sigma"], min=1.0),
                           0.0)

    return VertexProgram(
        name="bc_backward", monoid=MONOIDS["sum"],
        scatter_msg=scatter_msg, apply_fn=apply_fn,
        init_vertex_data=lambda n, aux: torch.zeros((n, D),
                                                    device=_dev(aux)),
        init_scatter_data=init_scatter,
        init_active=lambda n, aux: (aux["depth"] == aux["dmax"]).any(dim=-1),
        halts=False, payload_shape=(D,))


class _BCBatch:
    """The payload-batched two-stage pipeline: `[D]` source ids -> `[V, D]`
    δ lanes (a source's own lane zeroed at its own vertex), on the
    partitions' device.  After each call `depth` and `sigma` hold the
    forward stage's `[V, D]` outputs and `supersteps` the (forward,
    backward) superstep counts."""

    def __init__(self, graph: Graph, max_depth: int, batch: int, device):
        dev = resolve_device(device)
        self.max_depth = max_depth
        self.batch = batch
        self.fwd_part = DevicePartition.from_graph(graph, device=dev)
        self.bwd_part = DevicePartition.from_graph(graph, transpose=True,
                                                   device=dev)
        self.fwd = GREEngine(bc_forward_program(batch))
        # backward is iterative (halts=False) but its frontier is one depth
        # level at a time: keep per-edge activity masks on
        self.bwd = GREEngine(bc_backward_program(batch), dense_frontier=False)
        self.depth = self.sigma = None
        self.supersteps = (0, 0)

    def __call__(self, sources) -> torch.Tensor:
        part = self.fwd_part
        dev = part.device
        src = torch.as_tensor(np.asarray(sources, dtype=np.int64),
                              device=dev)
        lanes = torch.arange(self.batch, device=dev)
        st = self.fwd.init_state(part)
        vd, sd = st.vertex_data, st.scatter_data
        vd[src, lanes] = torch.tensor([0.0, 1.0], device=dev)  # depth 0, σ 1
        sd[src, lanes] = torch.tensor([1.0, 1.0, 1.0], device=dev)
        active = torch.zeros(part.num_slots, dtype=torch.bool, device=dev)
        active[src] = True
        out = self.fwd.run(part, EngineState(vd, sd, active, st.step),
                           self.max_depth)
        depth, sigma = out.vertex_data[..., 0], out.vertex_data[..., 1]
        dmax = torch.where(torch.isinf(depth), -1.0, depth).max()
        part_b = dataclasses.replace(
            self.bwd_part, aux={**self.bwd_part.aux, "depth": depth,
                                "sigma": sigma, "dmax": dmax})
        back = self.bwd.run(part_b, self.bwd.init_state(part_b),
                            self.max_depth + 1)
        self.depth, self.sigma = depth, sigma
        self.supersteps = (out.step, back.step)
        own = (torch.arange(part.num_masters, device=dev)[:, None]
               == src[None, :])
        return torch.where(own, 0.0, back.vertex_data)


def _make_bc_batch(graph: Graph, max_depth: int, batch: int,
                   device="cuda") -> _BCBatch:
    """The eager payload-batched pipeline: `[D]` source ids -> `[V, D]` δ
    lanes, with the forward and transposed partitions built once."""
    return _BCBatch(graph, max_depth, batch, device)


def accumulate_bc(run_batch: Callable[[np.ndarray], torch.Tensor],
                  sources: np.ndarray, batch: int,
                  num_vertices: int) -> np.ndarray:
    """Σ over `sources` of the δ lanes of `run_batch`, `batch` sources a
    call.  The ragged tail is padded to `batch` lanes by repeating its last
    source (one lane count for every call), and the padded lanes are
    weighted out of the sum."""
    bc = None
    for lo in range(0, sources.shape[0], batch):
        chunk = sources[lo:lo + batch]
        n = chunk.shape[0]
        delta = run_batch(np.pad(chunk, (0, batch - n), mode="edge"))
        w = (torch.arange(batch, device=delta.device) < n).to(delta.dtype)
        part = (delta * w[None, :]).sum(dim=1)
        bc = part if bc is None else bc + part
    if bc is None:
        return np.zeros(num_vertices, np.float32)
    return bc.cpu().numpy()


def betweenness_centrality(graph: Graph,
                           sources: Optional[Sequence[int]] = None,
                           max_depth: Optional[int] = None,
                           batch: int = 64, device="cuda") -> np.ndarray:
    """Exact when `sources` covers all vertices; sampled-approximate
    otherwise (the standard Brandes estimator).  Sources run `batch` at a
    time as payload lanes of one two-stage pipeline, so the graph is
    traversed once per batch.  `max_depth` caps the forward stage's
    supersteps (default `min(V, 64)`): depths beyond it stay unreached.
    Runs on `device` (CUDA unless `device="cpu"`); returns float32 on the
    host."""
    V = graph.num_vertices
    sources = np.arange(V) if sources is None else np.asarray(list(sources))
    max_depth = max_depth or min(V, 64)
    batch = min(batch, max(1, sources.shape[0]))
    return accumulate_bc(_make_bc_batch(graph, max_depth, batch, device),
                         sources, batch, V)
