"""Evaluators: measured probe supersteps for plan candidates.

The measurement half of the optimizer/evaluator split.  `measure` is the
JAX package's warmup/median harness with the same clock discipline: warmup
calls absorb first-use costs (allocator growth, lazy kernel loads, the
kernels' build), the lower median of the timed calls defeats one-off
scheduler spikes, and the dispersion (max over median) is recorded beside
it.

Each timed call is the host wall around the call, with
`torch.cuda.synchronize()` before the clock stops: the counterpart of
`jax.block_until_ready`.  The wall, not CUDA-event device time, is what is
compared, because a plan's cost includes its host loop: the compacted
strategies read the frontier counts every superstep, and on the card that
host time is what separates them from the dense scan.

`ProbeEvaluator` gives each candidate plan a real engine over a real
partition (rebuilt per candidate bucket ladder, since `bucket_bounds` is
ingress metadata; partitions are memoized per ladder, so a search builds
each ladder once), runs `probe_steps` supersteps of the actual program
from the actual source, and reports the median wall.  `num_probes` counts
`evaluate` calls: a cache hit leaves it at zero.

A candidate the card cannot run measures `inf`, so it ranks last and is
never stored: one whose widest frontier tile holds more lanes than the
combine kernels index (`kernels.segment_combine.MAX_LANES`, checked before
the probe on every device, so CPU and card rank alike), or whose probe
runs out of device memory.  The JAX package's space holds such plans for
power-law graphs of millions of vertices: at R-MAT scale 22 a `flat` tile
is `[cap, 97,522]` lanes (~4e10 at the hub's capacity), and a `compact`
plan at 4x the capacity gives the hub bucket ~4e9.
"""
from __future__ import annotations

import math
import time
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.engine import DevicePartition, GREEngine
from repro_torch.core.plan import SuperstepPlan
from repro_torch.kernels.segment_combine import MAX_LANES


class Measurement(NamedTuple):
    us: float      # median wall time per call, microseconds
    noise: float   # max/median dispersion over the timed calls (>= 1.0)


def _call(fn: Callable, args) -> None:
    fn(*args)
    if torch.cuda.is_initialized():   # wait for the card's queued work
        torch.cuda.synchronize()


def widest_tile(plan: SuperstepPlan, part: DevicePartition) -> int:
    """Lanes of the widest frontier tile `plan` gathers on `part` (0 for
    the dense scan)."""
    fp = plan.frontier(part)
    if fp.kind == "flat":
        return fp.caps * part.csr_max_deg
    if fp.kind == "bucketed":
        return max(c * d for c, d in zip(fp.caps, part.bucket_max_deg))
    return 0


def measure(fn: Callable, *args, warmup: int = 2,
            iters: int = 5) -> Measurement:
    """Median wall time per call plus dispersion, each call waited for.

    `noise` is the max/median ratio across the timed iterations: ~1.0 on
    a quiet machine.  The median is the lower one: for an even count it
    reports the faster middle sample, so a 2-iteration run does not report
    its max as the median and a constant 1.0 dispersion.
    """
    for _ in range(warmup):
        _call(fn, args)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _call(fn, args)
        times.append(time.perf_counter() - t0)
    times.sort()
    med = times[(len(times) - 1) // 2]
    return Measurement(med * 1e6, times[-1] / max(med, 1e-12))


class Evaluator:
    """Protocol: `evaluate(plan, probe_steps, iters) -> median us`.
    Subclasses own the scenario; `num_probes` counts measured probes so
    tests can assert cache hits never measure."""

    def __init__(self):
        self.num_probes = 0

    def evaluate(self, plan: SuperstepPlan, probe_steps: int = 2,
                 iters: int = 1) -> float:
        raise NotImplementedError


class ProbeEvaluator(Evaluator):
    """Measured probe supersteps against a real single-shard partition on
    `device` (CUDA unless `device="cpu"`).

    `probe_steps` bounds the BSP loop (`GREEngine.run`'s `max_steps`), so
    a cheap rung times 2 supersteps and a graduation rung the run toward
    quiescence; the successive-halving search (`repro_torch.tuning.search`)
    picks the rungs.  The engine runs eagerly, as every port run does.
    """

    def __init__(self, program, graph, source=0, warmup: int = 1,
                 default_bounds: Optional[tuple] = None, device="cuda"):
        super().__init__()
        self.program = program
        self.graph = graph
        self.source = source
        self.warmup = warmup
        self.default_bounds = default_bounds
        self.device = device
        self._parts = {}

    def partition(self, bounds: Optional[tuple] = None) -> DevicePartition:
        """The probe partition for one bucket ladder (memoized)."""
        key = tuple(bounds) if bounds else None
        if key not in self._parts:
            self._parts[key] = DevicePartition.from_graph(
                self.graph, bucket_bounds=bounds or self.default_bounds,
                device=self.device)
        return self._parts[key]

    def frontier_hist(self, probe_steps: int = 2) -> list:
        """The probe harness's frontier histogram on the default-ladder
        partition (the fingerprint's density facet; also what
        `calibrate_frontier_cap` measures)."""
        part = self.partition()
        eng = GREEngine(self.program)
        state = eng.init_state(part, source=self.source)
        return eng.probe_frontier_hist(part, state, probe_steps)

    def evaluate(self, plan: SuperstepPlan, probe_steps: int = 2,
                 iters: int = 1) -> float:
        self.num_probes += 1
        part = self.partition(plan.bucket_bounds)
        if widest_tile(plan, part) > MAX_LANES:
            return math.inf   # the kernels cannot index its tile
        eng = GREEngine(self.program, plan=plan)
        state = eng.init_state(part, source=self.source)
        try:
            m = measure(lambda s: eng.run(part, s, probe_steps), state,
                        warmup=self.warmup, iters=iters)
        except torch.OutOfMemoryError:
            return math.inf   # its tiles do not fit in device memory
        return m.us
