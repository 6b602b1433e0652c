"""Superstep execution plans and THE BSP loop.

A `SuperstepPlan` composes the frontier stage (`dense` every-edge scan,
`flat` single-tile compaction, or degree-`bucketed` tiles, with the static
capacity split — `resolve_frontier`) with the exchange phase shape.  This
package runs the `sync` shape only: the whole ⊕-reduce is one phase and the
merge is the identity.  The combine kernel is not a plan stage here: the
route follows the tensors' device (`repro_torch.kernels.ops`).

`execute_plan` is the BSP loop, an eager Python loop with the shape of the
JAX package's `lax.while_loop`: the first phase runs before the loop under
the continuation predicate, and each iteration is merge → apply → predicate
→ phase.  So `step` counts applies exactly as there, including the
`max_steps` cut and the empty-frontier case where no superstep runs.  The
predicate is one host read per superstep.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, NamedTuple, Optional

import torch

if TYPE_CHECKING:  # pragma: no cover - typing only, avoids a cycle
    from repro_torch.core.engine import DevicePartition, EngineState, GREEngine

PHASES = ("sync",)


class FrontierPlan(NamedTuple):
    """Static per-partition frontier resolution.

    `kind` is "dense" (caps None), "flat" (caps = the single tile capacity)
    or "bucketed" (caps = one capacity per degree bucket).
    """

    kind: str
    caps: object = None


def resolve_frontier(strategy: str, frontier_cap: Optional[int],
                     dense_frontier: bool,
                     part: "DevicePartition") -> FrontierPlan:
    """Frontier-strategy resolution for one partition.

    Returns kind "dense", "flat" for the single-tile compaction, or
    "bucketed" with one capacity per degree bucket.  `auto` resolves to
    dense when the worst-case tiles (`sum_b cap_b * max_deg_b`, or
    `cap * max_deg` for flat) would scan at least as many lanes as the
    dense path has edges.
    """
    if strategy == "dense" or dense_frontier:
        return FrontierPlan("dense")  # iterative: frontier is everything
    if part.csr_indptr is None or part.csr_max_deg <= 0:
        return FrontierPlan("dense")
    from repro_torch.core.frontier import bucket_caps, default_cap
    cap = min(frontier_cap or default_cap(part.num_slots), part.num_slots)
    bucketed = (strategy != "flat" and part.bucket_id is not None
                and len(part.bucket_max_deg) > 0
                and any(part.bucket_sizes))
    if not bucketed:
        if (strategy == "auto"
                and cap * part.csr_max_deg >= part.src.shape[0]):
            return FrontierPlan("dense")  # padded tile ≥ dense scan
        return FrontierPlan("flat", cap)
    caps = bucket_caps(part.bucket_sizes, cap)
    worst = sum(c * d for c, d in zip(caps, part.bucket_max_deg))
    if strategy == "auto" and worst >= part.src.shape[0]:
        return FrontierPlan("dense")  # full bucket tiles out-scan dense
    return FrontierPlan("bucketed", caps)


@dataclasses.dataclass(frozen=True)
class SuperstepPlan:
    """One engine mode: frontier strategy request and phase shape."""

    strategy: str = "auto"
    frontier_cap: Optional[int] = None
    dense_frontier: bool = False
    phases: str = "sync"

    def __post_init__(self):
        if self.phases not in PHASES:
            raise ValueError(f"phases={self.phases!r}: this package runs "
                             f"{PHASES} only")

    def frontier(self, part: "DevicePartition") -> FrontierPlan:
        return resolve_frontier(self.strategy, self.frontier_cap,
                                self.dense_frontier, part)

    def scatter_combine(self, engine: "GREEngine", part: "DevicePartition",
                        state: "EngineState",
                        num_segments: Optional[int] = None) -> torch.Tensor:
        """Resolve the partition's frontier plan and dispatch dense scan vs
        compacted gather."""
        nseg = num_segments or part.num_slots
        fp = self.frontier(part)
        if fp.kind == "dense":
            return engine.dense_scatter_combine(part, state, nseg)
        from repro_torch.core.frontier import frontier_scatter_combine
        return frontier_scatter_combine(
            engine.program, part, state, nseg, fp,
            dense_fn=lambda: engine.dense_scatter_combine(part, state, nseg))


def execute_superstep(engine: "GREEngine", part: "DevicePartition",
                      state: "EngineState", exchange) -> "EngineState":
    """ONE superstep through the phase protocol: refresh → local_phase →
    merge → apply."""
    state = exchange.refresh(state)
    carry = exchange.local_phase(engine, part, state)
    return engine.apply(part, state, exchange.merge(carry))


def execute_plan(engine: "GREEngine", part: "DevicePartition",
                 state: "EngineState", exchange,
                 max_steps: int = 100) -> "EngineState":
    """THE BSP loop: run `engine.program` to quiescence (no vertex
    scatter-active and no pending carry) or `max_steps` applies."""
    pending = getattr(exchange, "carry_pending", lambda carry: False)

    def keep_going(s, carry) -> bool:
        return s.step < max_steps and (bool(s.active_scatter.any())
                                       or bool(pending(carry)))

    def phase(s, carry):
        s = exchange.refresh(s)
        return s, exchange.local_phase(engine, part, s, carry)

    carry = exchange.carry_init(engine, part)
    go = keep_going(state, carry)
    if go:
        state, carry = phase(state, carry)
    while go:
        state = engine.apply(part, state, exchange.merge(carry))
        go = keep_going(state, carry)
        if go:
            state, carry = phase(state, carry)
    return state
