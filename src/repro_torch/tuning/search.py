"""Plan search: successive halving over the candidate space, cache-first.

`tune()` is the offline autotuner's front door.  The protocol:

  1. Fingerprint the scenario (graph facets + probe frontier histogram +
     program facets + mesh size — repro_torch.tuning.fingerprint) and consult
     the persistent `PlanCache`.  A HIT returns the stored winner with
     ZERO probe supersteps executed (`Evaluator.num_probes` stays 0 —
     the determinism tests pin this).
  2. On a miss, enumerate the validity-pruned candidate plans
     (`PlanSearchSpace.candidates`, capacity axis anchored on the
     measured histogram via `frontier.default_cap`) and run
     SUCCESSIVE HALVING: every candidate gets a cheap rung (2 probe
     supersteps, 1 timed iter — enough to kill the order-of-magnitude
     losers like a dense scan of a sparse frontier), the top third
     graduates to the full rung (run toward quiescence, median of 3).
     The engine's hand-picked DEFAULT plan is always seeded into the
     final rung, so the stored winner is never slower than the default
     AT PROBE TIME on this machine.
  3. Persist the winner keyed by the fingerprint, with the probe
     measurements as provenance (`probe_us`, `default_us`,
     `space_size`).

A copy of the JAX package's `repro.tuning.search`; its `TuneResult`,
cache entries and tie-breaks are the same.

Determinism: probe times are noisy, but ties and near-ties resolve by
`(us, candidate_index)` — for a FIXED evaluator (the tests drive a fake
deterministic one) the winner is a pure function of the space order.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

from repro_torch.core.engine import GREEngine
from repro_torch.core.frontier import default_cap
from repro_torch.core.plan import SuperstepPlan

from .cache import PlanCache
from .evaluator import Evaluator, ProbeEvaluator
from .fingerprint import plan_cache_key
from .space import PlanSearchSpace

# (probe_steps, timed iters) per rung: cheap cull, then full measurement.
DEFAULT_RUNGS = ((2, 1), (16, 3))


def successive_halving(candidates: Sequence[SuperstepPlan],
                       evaluator: Evaluator,
                       rungs: Tuple[Tuple[int, int], ...] = DEFAULT_RUNGS,
                       survive: float = 1 / 3,
                       min_finalists: int = 2,
                       must_keep: Sequence[int] = (),
                       ) -> Tuple[int, Dict[int, float]]:
    """Rung-by-rung cull; returns (winner index, final-rung times in us).

    `must_keep` indices (the default plan) are re-seeded into the FINAL
    rung even if an early cheap rung culled them, so the winner's final
    measurement is always comparable against the default's.  Ties break
    on candidate index — first enumerated wins.
    """
    assert candidates, "empty candidate space"
    alive = list(range(len(candidates)))
    scores: Dict[int, float] = {}
    for r, (steps, iters) in enumerate(rungs):
        final = r == len(rungs) - 1
        if final:
            for i in must_keep:
                if i not in alive:
                    alive.append(i)
            alive.sort()
        ranked = sorted((evaluator.evaluate(candidates[i], steps, iters), i)
                        for i in alive)
        scores = {i: us for us, i in ranked}
        if final:
            break
        keep = max(min_finalists, math.ceil(len(alive) * survive))
        alive = sorted(i for _, i in ranked[:keep])
    best_us, best_i = min((us, i) for i, us in scores.items())
    return best_i, scores


class TuneResult(NamedTuple):
    plan: SuperstepPlan
    probe_us: float        # winner's final-rung median
    default_us: float      # default plan's final-rung median
    key: str               # plan-cache key the winner is stored under
    from_cache: bool       # True = hit, no probes executed
    num_probes: int        # measured probe evaluations this call


def tune(program, graph, *, source=0, cache=None,
         space: Optional[PlanSearchSpace] = None, force: bool = False,
         rungs: Tuple[Tuple[int, int], ...] = DEFAULT_RUNGS,
         evaluator: Optional[Evaluator] = None,
         warmup: int = 1, device="cuda") -> TuneResult:
    """Tune one (program, graph) scenario; cache-first, halving on miss.

    `cache` is a `PlanCache`, a path, or None (default location);
    `force=True` re-searches and overwrites a hit.  Passing `evaluator`
    substitutes the measurement half (tests inject deterministic
    fakes); it must expose `partition()/frontier_hist()/evaluate()`.
    Without one, the probes run on `device` (CUDA unless `device="cpu"`).
    """
    space = space or PlanSearchSpace()
    if not isinstance(cache, PlanCache):
        cache = PlanCache(cache)
    ev = evaluator or ProbeEvaluator(program, graph, source=source,
                                     warmup=warmup, device=device)
    part = ev.partition()
    hist = ev.frontier_hist()
    key = plan_cache_key(part=part, program=program, mesh_size=1,
                         frontier_hist=hist)
    if not force:
        hit = cache.lookup(key)
        if hit is not None:
            meta = cache.entry(key)
            return TuneResult(hit, meta.get("probe_us", 0.0),
                              meta.get("default_us", 0.0), key,
                              from_cache=True, num_probes=0)

    default_plan = GREEngine(program).make_plan()
    dense = default_plan.dense_frontier
    cands = list(space.candidates(part.num_slots,
                                  default_cap(part.num_slots, hist),
                                  dense_frontier=dense,
                                  monotone=program.monotone))
    if default_plan in cands:
        default_i = cands.index(default_plan)
    else:
        cands.append(default_plan)
        default_i = len(cands) - 1

    best_i, scores = successive_halving(cands, ev, rungs=rungs,
                                        must_keep=(default_i,))
    winner = cands[best_i]
    probe_us = scores[best_i]
    default_us = scores[default_i]
    cache.store(key, winner, probe_us=round(probe_us, 1),
                default_us=round(default_us, 1), space_size=len(cands))
    return TuneResult(winner, probe_us, default_us, key,
                      from_cache=False, num_probes=ev.num_probes)
