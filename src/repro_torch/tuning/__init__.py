"""Offline plan autotuner: measured search over the `SuperstepPlan`
space with a persistent plan cache (the JAX package's `repro.tuning`,
whose docs are docs/tuning.md).

Optimizer/evaluator split: `PlanSearchSpace` enumerates the valid plan
candidates, `ProbeEvaluator` times short probe supersteps against a real
partition, `successive_halving`/`tune` drive the search cheap-rung-first,
and `PlanCache` persists winners keyed by `plan_cache_key` (graph +
program + mesh fingerprints) so engines built with `plan="auto-tuned"`
adopt a measured plan without re-searching.
"""
from .cache import CACHE_VERSION, PlanCache, default_cache_path
from .evaluator import Evaluator, Measurement, ProbeEvaluator, measure
from .fingerprint import (agent_graph_fingerprint, graph_fingerprint,
                          partition_fingerprint, plan_cache_key,
                          program_fingerprint)
from .search import (DEFAULT_RUNGS, TuneResult, successive_halving, tune)
from .space import DEFAULT_BOUND_CHOICES, SMOKE_SPACE, PlanSearchSpace

__all__ = [
    "CACHE_VERSION", "PlanCache", "default_cache_path",
    "Evaluator", "Measurement", "ProbeEvaluator", "measure",
    "agent_graph_fingerprint", "graph_fingerprint",
    "partition_fingerprint", "plan_cache_key", "program_fingerprint",
    "DEFAULT_RUNGS", "TuneResult", "successive_halving", "tune",
    "DEFAULT_BOUND_CHOICES", "SMOKE_SPACE", "PlanSearchSpace",
]
