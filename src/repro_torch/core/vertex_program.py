"""Scatter-Combine abstraction (paper §4, Alg. 1) on PyTorch tensors.

A `VertexProgram` instantiates the four primitives:

  scatter(u, v, e)   — generates an active message `msg = s(u.scatter_data,
                       e.state)` (here `scatter_msg`);
  combine(msg)       — folds the message into the destination's combine_data
                       with a commutative+associative generalized sum ⊕
                       (here a `Monoid`), optionally activating apply;
  apply(v)           — recomputes vertex_data from the accumulated sum and
                       optionally re-activates scatter;
  assert_to_halt(v)  — deactivates scatter (traversal algorithms) or keeps
                       the vertex active (iterative algorithms).

The whole scatter-combine phase is one gather → message → segment-reduce
pass with no atomics, so it is race-free and deterministic.

A worked example — in-degree counting as a one-superstep program:

    >>> import numpy as np, torch
    >>> from repro_torch.core.vertex_program import MONOIDS, VertexProgram
    >>> indegree = VertexProgram(
    ...     name="indegree", monoid=MONOIDS["sum"],
    ...     scatter_msg=lambda src_scatter, eprop: torch.ones_like(src_scatter),
    ...     apply_fn=lambda vd, combined, aux: (
    ...         combined, combined, torch.zeros_like(combined, dtype=torch.bool)),
    ...     init_vertex_data=lambda n, aux: torch.zeros(n),
    ...     init_scatter_data=lambda n, aux: torch.zeros(n),
    ...     init_active=lambda n, aux: torch.ones(n, dtype=torch.bool))
    >>> from repro_torch.core.engine import DevicePartition, GREEngine
    >>> from repro_torch.graph.structures import Graph
    >>> g = Graph(3, np.array([0, 0, 1]), np.array([1, 2, 2]))
    >>> part = DevicePartition.from_graph(g, device="cpu")
    >>> eng = GREEngine(indegree)
    >>> out = eng.run(part, eng.init_state(part), max_steps=5)
    >>> out.vertex_data.tolist()          # in-degrees of vertices 0,1,2
    [0.0, 1.0, 2.0]
    >>> out.step                          # halted after one superstep
    1

Init functions receive `(n, aux)`; the port's programs place their tensors
on `aux`'s device, so a state follows its partition.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.segment_combine import segment_combine_plain


@dataclasses.dataclass(frozen=True)
class Monoid:
    """Commutative+associative generalized sum ⊕ with identity (paper §2.2)."""

    name: str
    identity: float
    op: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

    def segment_reduce(self, msgs: torch.Tensor, dst: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
        """The plain ⊕ (any device, any dst order)."""
        return segment_combine_plain(msgs, dst, num_segments, self.name)


MONOIDS: Dict[str, Monoid] = {
    "sum": Monoid("sum", 0.0, torch.add),
    "min": Monoid("min", math.inf, torch.minimum),
    "max": Monoid("max", -math.inf, torch.maximum),
}


def segment_combine(msgs: torch.Tensor, dst: torch.Tensor, num_segments: int,
                    monoid: Monoid, indices_are_sorted: bool = False,
                    seg_ptr: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-sided combine of active messages at their destinations.

    This is the Scatter-Combine hot path.  On a CUDA tensor it runs the
    hand-written kernel: the dense route over dst-sorted edges (with the
    ingress row pointer `seg_ptr`), or the tile route, which sorts first,
    when the indices are not sorted.  On a CPU tensor it runs the plain
    version.
    """
    if indices_are_sorted:
        return kernel_ops.segment_combine(msgs, dst, num_segments,
                                          monoid.name, seg_ptr=seg_ptr)
    return kernel_ops.tile_segment_combine(msgs, dst, num_segments,
                                           monoid.name)


def _all_active(old: torch.Tensor, combined: torch.Tensor) -> torch.Tensor:
    return torch.ones(old.shape[0], dtype=torch.bool, device=old.device)


@dataclasses.dataclass(frozen=True)
class VertexProgram:
    """User-defined vertex computation in the Scatter-Combine model.

    State layout follows paper §6.1.3 (flat columns indexed by local slot):
    `vertex_data` (result, owned by masters, updated by `apply`),
    `scatter_data` (the datum a vertex scatters) and the ⊕ accumulator.
    Payloads are `[slots, *payload_shape]`; the paper's scalar programs are
    the `payload_shape = ()` case.

    `scatter_msg(src_scatter_data, edge_prop)` builds the messages of a
    batch of edges; `apply_fn(vertex_data, combined, aux)` returns
    `(new_vertex_data, new_scatter_data, activate_scatter)`, with the
    superstep counter in `aux["step"]`.
    """

    name: str
    monoid: Monoid
    scatter_msg: Callable[[torch.Tensor, Optional[torch.Tensor]], torch.Tensor]
    apply_fn: Callable[[torch.Tensor, torch.Tensor, Any], tuple]
    init_vertex_data: Callable[[int, Dict[str, torch.Tensor]], torch.Tensor]
    init_scatter_data: Callable[[int, Dict[str, torch.Tensor]], torch.Tensor]
    init_active: Callable[[int, Dict[str, torch.Tensor]], torch.Tensor]
    # `combine_activates(old_vertex_data, combined) -> bool[V]`: whether the
    # accumulated message changes the vertex (paper's `activate_apply`).
    combine_activates: Callable[[torch.Tensor, torch.Tensor],
                                torch.Tensor] = _all_active
    # Iterative programs (PageRank) keep scattering; traversal programs halt.
    halts: bool = True
    needs_edge_prop: Optional[str] = None
    payload_shape: Tuple[int, ...] = ()
    msg_dtype: Any = torch.float32
    # ------------------------------------------------------------ lane hooks
    # Multi-source programs treat the D payload lanes as independent queries.
    # `lane_activates(old_vertex_data, combined) -> bool[n, D]`: which
    # (vertex, lane) pairs improved this superstep (reduced into
    # `EngineState.lane_active`).
    lane_activates: Optional[Callable[[torch.Tensor, torch.Tensor],
                                      torch.Tensor]] = None
    # `seed_sources(vertex_data, scatter_data, src, lanes, aux)` seeds root
    # `src[i]` into lane `lanes[i]` (only seeded lanes are passed) and
    # returns `(vertex_data, scatter_data)`; None = value 0.0 at
    # `[src, lane]`.
    seed_sources: Optional[Callable] = None
    # `lane_view(vertex_data, lane) -> [n]`: one lane's per-vertex result.
    lane_view: Optional[Callable[[torch.Tensor, int], torch.Tensor]] = None
    # Removal-invalidation policy for warm-started re-convergence
    # ("path", "component" or None).
    invalidation: Optional[str] = None
    # What `scatter_msg` computes, where it is one of the gather-message
    # kernel's forms (`repro_torch.kernels.gather_messages`): "copy" (the
    # source's scatter data), "add_prop" (plus the edge property
    # `needs_edge_prop`) or "add_one".  None: another message.  The dense
    # scan of a scalar program that declares one runs the kernel; the
    # shipped programs take `scatter_msg` from the same declaration
    # (`gather_messages.form_messages`).
    message: Optional[str] = None

    @property
    def monotone(self) -> bool:
        """Whether delayed or re-ordered delivery cannot change the fixed
        point: halting programs under an idempotent select ⊕ (min/max)."""
        return self.halts and self.monoid.name in ("min", "max")
