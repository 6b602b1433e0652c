"""`PlanSearchSpace`: the enumerable, validity-pruned candidate set.

The optimizer half of the optimizer/evaluator split (the deephyper-style
architecture the ROADMAP names): the space knows which `SuperstepPlan`
combinations are WELL-FORMED for a given scenario, the evaluator
(repro_torch.tuning.evaluator) knows how fast each one actually is.  The axes
are exactly the plan's fields:

  frontier strategy x capacity multiplier x degree-bucket bounds
  x exchange phase shape (sync | pipelined | async x staleness) x kernel
  stage (XLA | Pallas +- dynamic table)

Validity pruning keeps the enumeration honest instead of large:

  * `dense` ignores caps and bucket bounds — ONE candidate per
    (phase, kernel), not |caps| x |bounds| duplicates that would waste
    probe budget re-measuring the same compiled program;
  * `flat` ignores bucket bounds (a single tile has no buckets);
  * capacities are clamped to `num_slots` (a cap can't exceed the slot
    space — the bucketed caps derived from it then respect `num_slots`
    per bucket via `frontier.bucket_caps`) and deduplicated after
    clamping;
  * `pipelined`/`async` phases require split edge tiles (the distributed
    backends' static ingress split) — pruned entirely for single-shard
    scenarios; `async` additionally requires a MONOTONE program
    (`VertexProgram.monotone` — ⊕=min/max halting traversals), so sync
    stays the only measured phase for sum-monoid programs and a tuned
    plan can never hand them bounded staleness;
  * `KernelPlan(use_pallas=False, dynamic_table=False)` is pruned: the
    dynamic-table bit only exists on the Pallas route.

A copy of the JAX package's `repro.tuning.space`: with the default
`kernels`, `candidates` gives the JAX package's list element by element.
The port's kernel route follows the tensors' device, so the kernel axis
keeps its single default candidate here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from repro_torch.core.plan import KernelPlan, SuperstepPlan

# Candidate degree-bucket ladders: the default 2-octave ladder plus one
# finer and one coarser alternative (None = whatever the partition was
# built with, i.e. graph.structures.DEFAULT_BUCKET_BOUNDS).
DEFAULT_BOUND_CHOICES = (None, (4, 16, 64, 256), (16, 64, 256, 1024))


def _round8(x: float) -> int:
    return max(8, -(-int(x) // 8) * 8)


@dataclasses.dataclass(frozen=True)
class PlanSearchSpace:
    """Declarative axes; `candidates()` does the pruned enumeration."""

    strategies: Tuple[str, ...] = ("dense", "flat", "compact")
    cap_multipliers: Tuple[float, ...] = (0.5, 1.0, 2.0, 4.0)
    bucket_bounds: Tuple[Optional[tuple], ...] = DEFAULT_BOUND_CHOICES
    phases: Tuple[str, ...] = ("sync",)
    # Async ring depths measured when the "async" phase shape survives
    # pruning (split tiles present AND the program is monotone).
    staleness_choices: Tuple[int, ...] = (2, 4)
    kernels: Tuple[KernelPlan, ...] = (KernelPlan(use_pallas=False),)

    def candidates(self, num_slots: int, base_cap: int,
                   dense_frontier: bool = False,
                   has_split_tiles: bool = False,
                   monotone: bool = False
                   ) -> Tuple[SuperstepPlan, ...]:
        """Enumerate valid `SuperstepPlan`s for one scenario.

        `base_cap` anchors the capacity axis (typically
        `frontier.default_cap` over the probe histogram); `num_slots`
        clamps it.  `dense_frontier` marks iterative programs — their
        engines never compact, so only the dense strategy survives.
        `has_split_tiles` gates the pipelined/async phase shapes (both
        require the distributed ingress edge split); `monotone`
        additionally gates async (bounded staleness preserves only
        min/max fixed points — see `VertexProgram.monotone`)."""
        caps = []
        for m in self.cap_multipliers:
            c = min(num_slots, _round8(m * base_cap))
            if c not in caps:
                caps.append(c)
        kernels = [k for k in self.kernels
                   if k.use_pallas or k.dynamic_table]  # prune no-op combo
        phases = []           # (phase, staleness) pairs after pruning
        for p in self.phases:
            if p == "sync":
                phases.append((p, 0))
            elif p == "pipelined" and has_split_tiles:
                phases.append((p, 0))
            elif p == "async" and has_split_tiles and monotone:
                phases.extend((p, st) for st in self.staleness_choices)
        strategies = (("dense",) if dense_frontier else self.strategies)
        out, seen = [], set()
        for phase, staleness in phases:
            for kernel in kernels:
                for strategy in strategies:
                    if strategy == "dense":
                        combos = [(None, None)]
                        # the dynamic-table bit is a tile-combine knob;
                        # the dense scan's Pallas route ignores it
                        if kernel.use_pallas and not kernel.dynamic_table:
                            continue
                    elif strategy == "flat":
                        combos = [(c, None) for c in caps]
                    else:  # bucketed compaction ("compact" / "auto")
                        combos = [(c, b) for c in caps
                                  for b in self.bucket_bounds]
                    for cap, bounds in combos:
                        plan = SuperstepPlan(
                            strategy=strategy, frontier_cap=cap,
                            dense_frontier=dense_frontier, phases=phase,
                            staleness=staleness,
                            kernel=kernel, bucket_bounds=bounds)
                        if plan not in seen:
                            seen.add(plan)
                            out.append(plan)
        return tuple(out)


# Tiny space for CI smoke runs and tests: 1 cap anchor x 2 multipliers,
# default bounds only, XLA kernel, sync phase.
SMOKE_SPACE = PlanSearchSpace(
    strategies=("dense", "flat", "compact"),
    cap_multipliers=(1.0, 2.0),
    bucket_bounds=(None,),
)


def describe(space: PlanSearchSpace, candidates: Sequence[SuperstepPlan]
             ) -> str:
    return (f"{len(candidates)} candidates from "
            f"{len(space.strategies)} strategies x "
            f"{len(space.cap_multipliers)} caps x "
            f"{len(space.bucket_bounds)} bucket ladders x "
            f"{len(space.phases)} phases x {len(space.kernels)} kernels")
