"""Superstep execution plans and THE BSP loop.

A `SuperstepPlan` composes the frontier stage (`dense` every-edge scan,
`flat` single-tile compaction, or degree-`bucketed` tiles, with the static
capacity split — `resolve_frontier`) with the exchange phase shape: `sync`
(the whole ⊕-reduce is one phase and the merge is the identity),
`pipelined` (a two-slot `Mailbox` carry whose flush merges at the top of
the next superstep) or `async` (a `staleness`-deep ring flushed once per
window; `repro_torch.core.exchange`).  The combine kernel is not a plan
stage here: the route follows the tensors' device
(`repro_torch.kernels.ops`).  A plan still carries the JAX package's
`KernelPlan`, and `to_json`/`from_json` write and read the same JSON, so
plans round-trip through a plan cache (`repro_torch.tuning`) written by
either package; on the port the kernel stage selects nothing.

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

PHASES = ("sync", "pipelined", "async")


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """The JAX package's combine-kernel stage (XLA segment ops, or the
    Pallas tile combine with or without its on-device block table), kept
    so that plans written by either package compare and serialise alike.
    The port has one route per device (`repro_torch.kernels.ops`), so these
    fields select nothing here."""

    use_pallas: bool = False
    dynamic_table: bool = True


XLA_KERNEL = KernelPlan(use_pallas=False)


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
    """One engine mode: frontier strategy request and phase shape.

    `staleness` is the async ring depth k (collectives once per k
    supersteps), 0 for the synchronous shapes.  `kernel` is carried for
    the JAX package's plans and selects nothing (`KernelPlan`).

    `bucket_bounds` is ingress metadata, not a run-time knob: the degree
    binning is fixed when a partition is built, so a plan with bounds says
    "tuned against a partition binned with these bounds"; callers rebuild
    a matching partition with `DevicePartition.from_graph(...,
    bucket_bounds=...)`.  None means the default ladder.
    """

    strategy: str = "auto"
    frontier_cap: Optional[int] = None
    dense_frontier: bool = False
    phases: str = "sync"
    kernel: KernelPlan = XLA_KERNEL
    bucket_bounds: Optional[tuple] = None
    staleness: int = 0

    def __post_init__(self):
        if self.phases not in PHASES:
            raise ValueError(f"phases={self.phases!r}: choose from {PHASES}")
        if self.phases == "async" and self.staleness < 1:
            raise ValueError("phases='async' needs staleness >= 1 "
                             f"(got {self.staleness})")
        if self.phases != "async" and self.staleness != 0:
            raise ValueError(f"staleness={self.staleness} is only "
                             "meaningful with phases='async'")
        if self.bucket_bounds is not None:
            # a hashable int tuple (JSON round-trips lists)
            object.__setattr__(self, "bucket_bounds",
                               tuple(int(b) for b in self.bucket_bounds))

    def to_json(self) -> dict:
        """Plain-JSON form for the plan cache (`repro_torch.tuning.cache`),
        field for field the JAX package's."""
        return {
            "strategy": self.strategy,
            "frontier_cap": self.frontier_cap,
            "dense_frontier": self.dense_frontier,
            "phases": self.phases,
            "kernel": {"use_pallas": self.kernel.use_pallas,
                       "dynamic_table": self.kernel.dynamic_table},
            "bucket_bounds": (None if self.bucket_bounds is None
                              else list(self.bucket_bounds)),
            "staleness": self.staleness,
        }

    @classmethod
    def from_json(cls, data: dict) -> "SuperstepPlan":
        """Inverse of `to_json`.  Unknown fields, of the plan or of its
        kernel, are rejected: an entry written by a later schema must fail
        loudly rather than run with some of its knobs dropped."""
        known = {"strategy", "frontier_cap", "dense_frontier", "phases",
                 "kernel", "bucket_bounds", "staleness"}
        unknown = set(data) - known
        if unknown:
            raise ValueError(f"SuperstepPlan.from_json: unknown field(s) "
                             f"{sorted(unknown)}")
        kdata = dict(data.get("kernel") or {})
        kunknown = set(kdata) - {"use_pallas", "dynamic_table"}
        if kunknown:
            raise ValueError(f"SuperstepPlan.from_json: unknown kernel "
                             f"field(s) {sorted(kunknown)}")
        kernel = KernelPlan(use_pallas=bool(kdata.get("use_pallas", False)),
                            dynamic_table=bool(kdata.get("dynamic_table",
                                                         True)))
        cap = data.get("frontier_cap")
        bounds = data.get("bucket_bounds")
        return cls(strategy=data.get("strategy", "auto"),
                   frontier_cap=None if cap is None else int(cap),
                   dense_frontier=bool(data.get("dense_frontier", False)),
                   phases=data.get("phases", "sync"),
                   kernel=kernel,
                   bucket_bounds=None if bounds is None else tuple(bounds),
                   staleness=int(data.get("staleness", 0)))

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
                 max_steps: int = 100, any_active=None) -> "EngineState":
    """THE BSP loop: run `engine.program` to quiescence (no vertex
    scatter-active and no pending carry) or `max_steps` applies.

    `any_active` globalises the halt test: it receives the local "still
    work here" flag (a bool tensor: frontier non-empty or the carry still
    holding in-flight contributions, `exchange.carry_pending`) and returns
    the verdict over every shard as a Python bool; the distributed engine
    passes its communicator's `any`.  The default reads the flag, one host
    read a superstep either way.  Counting the carry matters for the async
    shape only: its ring holds remote partials flushed once per window and
    its `dirty` bit improvements the next refresh has yet to push.
    """
    globalize = any_active or bool
    pending = getattr(exchange, "carry_pending", lambda carry: False)

    def keep_going(s, carry) -> bool:
        if s.step >= max_steps:
            return False
        local = s.active_scatter.any()
        held = pending(carry)
        if held is not False:
            local = local | held
        return globalize(local)

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
