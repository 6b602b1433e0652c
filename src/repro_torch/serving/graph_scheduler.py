"""Multi-tenant traversal serving: continuous query batching over payload
lanes.

The engine's multi-source programs answer D roots in one pass by batching
them into the `[slots, D]` payload lanes, but a STATIC batch runs until its
slowest query converges.  `GraphQueryBatcher` turns the lanes into a
continuously batched serving pool instead:

  admit   — queued queries are seeded into free lanes by one host-side
            call that updates the state's tensors IN PLACE (lane reset,
            stale-row normalisation, seeding), so the lane buffers are
            never reallocated across admissions;
  tick    — `steps_per_tick` supersteps advance ALL resident lanes through
            the one canonical superstep (`plan.execute_superstep`, any
            exchange backend, single shard or k stacked shards);
  retire  — between ticks the host reads `EngineState.lane_active` (the
            per-lane halt, reduced by `apply` from
            `VertexProgram.lane_activates`) once, fetches converged lanes'
            results and recycles their lanes for the next queued queries.
            Budget-exceeded queries are EVICTED: the lane is reset without
            reseeding and the query marked failed.

Recycling is bitwise-safe: a reset lane holds monoid-identity scatter
state, so vertices still active on behalf of OTHER lanes deliver identity
values into it (`min(x, inf) = x`; `x + 0.0 = x`), and a recycled lane's
answer is bit-identical to a fresh single-query batch.

The port's copy of `repro.serving.graph_scheduler`.  Where the JAX package
admits through one jitted static-shape call whose index operands carry
out-of-range sentinels (dropped by `mode="drop"`), the port selects the
seeded lanes first and never indexes with a sentinel: in PyTorch an
out-of-range index raises on the CPU and traps on the card.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.dist_engine import DistGREEngine

__all__ = ["GraphQueryBatcher", "Query", "ServingFrontend", "poisson_ticks"]


@dataclasses.dataclass
class Query:
    """One traversal request riding a payload lane.

    Lifecycle: queued → running → done | evicted.  Timing fields are wall
    clock (`time.perf_counter`); `supersteps_used` counts supersteps from
    admission, the scheduler-level latency that does not depend on the
    machine's speed.
    """

    uid: int
    source: int
    kind: str = "bfs"
    max_supersteps: Optional[int] = None   # budget; None = run to convergence
    status: str = "queued"
    result: Optional[np.ndarray] = None
    lane: Optional[int] = None
    submitted_at: float = 0.0
    admitted_at: float = 0.0
    finished_at: float = 0.0
    supersteps_used: int = 0

    @property
    def latency_s(self) -> float:
        return self.finished_at - self.submitted_at

    @property
    def wait_s(self) -> float:
        return self.admitted_at - self.submitted_at


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Linear-interpolation percentile over an ALREADY-SORTED sequence
    (numpy's default ``method="linear"``)."""
    if not sorted_vals:
        return float("nan")
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return float(sorted_vals[lo]) * (1.0 - frac) + float(sorted_vals[hi]) * frac


def poisson_ticks(num_queries: int, rate_per_tick: float,
                  rng: np.random.Generator) -> np.ndarray:
    """Arrival tick for each of `num_queries` queries under a Poisson
    process with `rate_per_tick` expected arrivals per serving tick
    (exponential inter-arrival gaps, cumulated and floored)."""
    gaps = rng.exponential(scale=1.0 / rate_per_tick, size=num_queries)
    return np.floor(np.cumsum(gaps)).astype(np.int64)


class GraphQueryBatcher:
    """Continuous batching of traversal queries over one engine's lanes.

    `engine` is a `GREEngine` (with a `DevicePartition` target) or a
    `DistGREEngine` (with an `AgentGraph` target); the program must be a
    multi-source variant exposing `lane_activates` (`bfs_program(D)`,
    `sssp_program(D)`, `ppr_push_program(D)`).  Over a `ProcessGroupComm`
    each rank runs its own batcher on the shard it holds: every rank must
    submit the same queries in the same order (and land the same deltas),
    so that all ranks retire, evict and admit the same lanes and issue the
    same collectives (a finished lane's fetch all-gathers it).

    Public protocol: `submit()` enqueues; `pump()` retires, evicts and
    admits (on the host, between ticks); `tick()` advances every resident
    lane by `steps_per_tick` supersteps; `run()` loops pump/tick until
    drained.  `host_reads` counts the batcher's own reads from the device:
    one `lane_active` read a pump and one read a finished query's lane.
    """

    def __init__(self, engine, target, *, steps_per_tick: int = 1,
                 default_budget: Optional[int] = None,
                 clock=time.perf_counter):
        p = engine.program
        if not p.payload_shape or p.lane_activates is None:
            raise ValueError(
                "serving needs a multi-source program with lane_activates "
                f"(got {p.name!r} with payload_shape={p.payload_shape})")
        self.engine = engine
        self.program = p
        self.num_lanes = p.payload_shape[0]
        self.steps_per_tick = steps_per_tick
        self.default_budget = default_budget
        self.clock = clock
        self._dist = isinstance(engine, DistGREEngine)
        self._set_target(target)
        # after `_set_target`: a plan="auto-tuned" cache hit there may have
        # adopted a compacted plan
        self._clamp_sum_monoid_plan()
        self.queue: deque = deque()
        self.finished: List[Query] = []
        self._lane_query: List[Optional[Query]] = [None] * self.num_lanes
        self._pending_deltas: List = []   # "finish"-policy deltas awaiting swap
        self._uid = 0
        self.ticks = 0
        self.supersteps = 0
        self.host_reads = 0
        self._busy_lane_ticks = 0
        self._first_submit: Optional[float] = None

    def _clamp_sum_monoid_plan(self) -> None:
        """Pin sum-monoid programs (PPR) to the dense frontier.

        Recycled-lane bitwise equality for float sums needs an ORDER-FIXED
        schedule: the dense every-edge scan folds each destination's edges
        in one fixed order every superstep, so a recycled lane accumulates
        the exact float sequence a fresh batch would.  A compacted
        frontier orders delivery by frontier occupancy, which depends on
        the OTHER queries sharing the batch.  Only the frontier strategy
        is clamped; `dense_frontier` is reset to the program's own
        default (forcing it on a halting program breaks lane retirement).
        """
        if self.program.monoid.name != "sum":
            return
        local = self.engine.local if self._dist else self.engine
        local.frontier = "dense"
        local.frontier_cap = None
        local.dense_frontier = not self.program.halts

    def _set_target(self, target) -> None:
        """Take `target` as the topology served and start a fresh lane
        state on it (every lane free)."""
        if self._dist:
            self._ag = target
            self._topo = self.engine.device_topology(target)
            self._tick_fn = self.engine.make_superstep(
                target, steps_per_tick=self.steps_per_tick)
            self._aux = {n: torch.from_numpy(a).to(self.engine.device)
                         for n, a in self.engine._aux(target).items()}
            # (held shards, slots a shard, masters a shard): a rank's state
            # holds only its own shards' rows
            self._blocks = (self.engine.k_local, target.num_slots,
                            target.cap)
        else:
            self._part = target
            self._aux = target.aux
            self._blocks = (1, target.num_slots, target.num_masters)
        self.state = self.engine.init_state(
            target, source=[None] * self.num_lanes, lane_tracking=True)

    # ------------------------------------------------------------ admission
    def _admit(self, ops: Dict[int, Optional[int]]) -> None:
        """Apply `lane -> src` transitions to the state IN PLACE (src None
        = reset the lane without seeding, i.e. eviction).  `src` is a
        master slot on the single shard, `(shard, local slot)` on stacked
        shards; only the seeded lanes are indexed, never a sentinel.  A
        process resets the lanes in the rows it holds and seeds only the
        sources whose master it holds (`DistGREEngine.init_state`'s rule);
        every process marks the same lanes active."""
        p, st = self.program, self.state
        dev = st.vertex_data.device
        k, ns, m = self._blocks
        order = sorted(ops)
        lanes = torch.tensor(order, dtype=torch.int64, device=dev)
        seeded = [(d, ops[d]) for d in order if ops[d] is not None]
        if self._dist:
            first = self.engine.rows.start
            seeded = [(d, (i - first, s)) for d, (i, s) in seeded
                      if 0 <= i - first < k]
            rows = [(i * m + s, i * ns + s) for _, (i, s) in seeded]
        else:
            rows = [(s, s) for _, s in seeded]
        # reset the lanes: initial vertex data, identity scatter rows
        init_vd = p.init_vertex_data(k * m, self._aux)
        st.vertex_data[:, lanes] = init_vd[:, lanes]
        payload = tuple(st.scatter_data.shape[1:])
        sd = st.scatter_data.view((k, ns) + payload)
        sd0 = p.init_scatter_data(k * m, self._aux).to(p.msg_dtype)
        sd[:, m:, lanes] = p.monoid.identity
        sd[:, :m, lanes] = sd0.view((k, m) + payload)[:, :, lanes]
        if seeded:
            slot = torch.tensor([r[1] for r in rows], dtype=torch.int64,
                                device=dev)
            # Activating a seed vertex makes it scatter EVERY lane of its
            # row next superstep.  An inactive vertex's row is stale (its
            # values were already delivered; a sum would count them twice),
            # so it goes to the identity; an ACTIVE vertex's row was
            # rewritten by the last apply and is still undelivered.
            stale = ~st.active_scatter[slot]
            st.scatter_data[slot[stale]] = p.monoid.identity
            self._seed(rows, [d for d, _ in seeded])
            st.active_scatter[slot] = True
        flags = torch.tensor([ops[d] is not None for d in order],
                             device=dev)
        if st.lane_active.dim() == 2:
            st.lane_active[:, lanes] = flags
        else:
            st.lane_active[lanes] = flags

    def _seed(self, rows, seed_lanes) -> None:
        """Seed root `rows[i]` (master row, slot) into lane
        `seed_lanes[i]`: the program's `seed_sources`, else 0.0, written
        into the state's tensors."""
        p, st = self.program, self.state
        dev = st.vertex_data.device
        if p.seed_sources is None:
            m = torch.tensor([r[0] for r in rows], device=dev)
            s = torch.tensor([r[1] for r in rows], device=dev)
            ln = torch.tensor(seed_lanes, device=dev)
            st.vertex_data[m, ln] = 0.0
            st.scatter_data[s, ln] = 0.0
            return
        _, ns, cap = self._blocks
        # each root is a local slot of the one shard mastering it
        for (g, _), d in zip(rows, seed_lanes):
            i, s = divmod(g, cap)
            mrows = slice(i * cap, (i + 1) * cap)
            srows = slice(i * ns, (i + 1) * ns)
            vd_i, sd_i = p.seed_sources(
                st.vertex_data[mrows], st.scatter_data[srows],
                torch.tensor([s], device=dev), torch.tensor([d], device=dev),
                {n: a[mrows] for n, a in self._aux.items()})
            st.vertex_data[mrows] = vd_i
            st.scatter_data[srows] = sd_i

    # --------------------------------------------------------------- serving
    def submit(self, source: int, *, kind: Optional[str] = None,
               max_supersteps: Optional[int] = None) -> Query:
        q = Query(uid=self._uid, source=int(source),
                  kind=kind or self.program.name,
                  max_supersteps=(max_supersteps if max_supersteps is not None
                                  else self.default_budget),
                  submitted_at=self.clock())
        self._uid += 1
        if self._first_submit is None:
            self._first_submit = q.submitted_at
        self.queue.append(q)
        return q

    @property
    def busy(self) -> bool:
        return any(q is not None for q in self._lane_query)

    @property
    def idle(self) -> bool:
        return not self.busy and not self.queue

    def _lane_active_host(self) -> np.ndarray:
        self.host_reads += 1
        la = self.state.lane_active.to("cpu", copy=True).numpy()
        return la[0] if la.ndim == 2 else la

    def _lane_result(self, lane: int) -> np.ndarray:
        """One lane's result in original vertex order (one device read).
        Over ranks it is a collective (`original_order` all-gathers the
        masters), so every rank fetches the same lanes in the same order:
        `pump` decides from the global lane halt and superstep counts
        only, never from a clock."""
        self.host_reads += 1
        vd = self.state.vertex_data
        col = (self.program.lane_view(vd, lane)
               if self.program.lane_view is not None else vd[:, lane])
        if self._dist:
            return self.engine.original_order(self._ag, col)
        # a copy: the lane's buffer is reset in place when it is recycled
        return col.to("cpu", copy=True).numpy()

    def pump(self) -> List[Query]:
        """Retire converged lanes, evict over-budget ones, land any pending
        graph delta once the lanes drain, admit from the queue: on the
        host, between ticks, ending with at most one in-place admission
        covering every lane transition."""
        D = self.num_lanes
        finished: List[Query] = []
        la = self._lane_active_host()
        ops: Dict[int, Optional[int]] = {}   # lane -> src (None = reset)
        now = self.clock()
        for d in range(D):
            q = self._lane_query[d]
            if q is None:
                continue
            if not la[d]:            # converged: fetch result, free the lane
                q.result = self._lane_result(d)
                q.status, q.finished_at = "done", now
                finished.append(q)
                self._lane_query[d] = None
            elif (q.max_supersteps is not None
                  and q.supersteps_used >= q.max_supersteps):
                q.status, q.finished_at = "evicted", now   # budget exceeded
                finished.append(q)
                self._lane_query[d] = None
                ops[d] = None                # reset the lane, seed nothing
        # "finish"-policy deltas land here: every resident lane has drained
        # (their results above came from the pre-delta state), so the swap
        # is between ticks by construction, never torn.  A pending delta
        # holds admissions so it lands in bounded time.
        if self._pending_deltas and not self.busy:
            self._swap_target()
            ops = {}   # stale resets target the replaced state; drop them
        for d in range(D):
            if self._pending_deltas:
                break                # hold admissions until the delta lands
            if self._lane_query[d] is None and self.queue:
                q = self.queue.popleft()
                q.status, q.lane, q.admitted_at = "running", d, now
                q.supersteps_used = 0
                self._lane_query[d] = q
                ops[d] = self._local_src(q.source)   # admit overrides evict
        if ops:
            self._admit(ops)
        self.finished.extend(finished)
        return finished

    # ------------------------------------------------------- graph mutation
    def apply_delta(self, delta, *, policy: str = "finish") -> None:
        """Land an `EdgeDelta` on a live batcher.

        A delta never lands mid-tick, so a torn read (a query observing
        half the mutation) cannot happen.  The policy decides what happens
        to the queries resident in lanes:

          "finish" — residents run to completion on the pre-delta
              topology; the swap happens at the first `pump()` after the
              last resident drains.  Admissions are HELD while a delta is
              pending, bounding the wait by the slowest resident.
          "reseed" — the swap happens now; residents are re-seeded from
              superstep 0 on the mutated graph in their lanes (fresh init
              values, so no invalidation pass is needed).  Their
              `supersteps_used` keeps counting toward the budget.

        Either way, queries admitted after this call run on the mutated
        graph, and recycled-lane results stay bitwise-equal to fresh runs.
        """
        if policy not in ("finish", "reseed"):
            raise ValueError(f"policy must be 'finish' or 'reseed', got "
                             f"{policy!r}")
        self._pending_deltas.append(delta)
        if policy == "finish":
            if not self.busy:
                self._swap_target()
            return
        residents = [(d, q) for d, q in enumerate(self._lane_query)
                     if q is not None]
        self._swap_target()
        if residents:
            self._admit({d: self._local_src(q.source) for d, q in residents})

    def _swap_target(self) -> None:
        """Apply every pending delta to the topology and start a fresh lane
        state on it.  Callers guarantee no lane holds a query whose state
        must survive (drained, or about to be re-seeded)."""
        deltas, self._pending_deltas = self._pending_deltas, []
        if self._dist:
            from repro_torch.core.agent_graph import apply_edge_delta
            target = self._ag
            for delta in deltas:
                target, _ = apply_edge_delta(target, delta)
        else:
            target = self._part
            for delta in deltas:
                target, _ = target.apply_edge_delta(delta)
            # a mutated partition re-keys the tuned plan before it runs
            self.engine.refresh_plan(target)
        self._set_target(target)
        # a re-keyed cache hit can adopt a compacted plan for the mutated
        # graph; sum-monoid lanes stay dense
        self._clamp_sum_monoid_plan()

    def _local_src(self, source: int):
        """Original vertex id → admission operand: the master slot (single
        shard) or a (shard, local slot) pair (stacked shards)."""
        if not self._dist:
            return int(source)
        g = int(self._ag.old2new[int(source)])
        return (g // self._ag.cap, g % self._ag.cap)

    def tick(self) -> None:
        """Advance every resident lane by `steps_per_tick` supersteps."""
        self._busy_lane_ticks += sum(
            q is not None for q in self._lane_query)
        if self._dist:
            self.state = self._tick_fn(self._topo, self.state)
        else:
            state = self.state
            for _ in range(self.steps_per_tick):
                state = self.engine.superstep(self._part, state)
            self.state = state
        self.ticks += 1
        self.supersteps += self.steps_per_tick
        for q in self._lane_query:
            if q is not None:
                q.supersteps_used += self.steps_per_tick

    def run(self, max_ticks: int = 100_000) -> List[Query]:
        """Pump/tick until queue and lanes drain; returns the queries
        finished during this call (done or evicted), in completion order."""
        out = list(self.pump())
        while self.busy and self.ticks < max_ticks:
            self.tick()
            out.extend(self.pump())
        return out

    # --------------------------------------------------------------- metrics
    def metrics(self) -> Dict[str, float]:
        """Service metrics over everything finished so far."""
        done = [q for q in self.finished if q.status == "done"]
        lat = sorted(q.latency_s for q in done)
        steps = sorted(float(q.supersteps_used) for q in done)
        waits = [q.wait_s for q in done]
        span = (max(q.finished_at for q in done) - self._first_submit
                if done and self._first_submit is not None else 0.0)
        cap = self.ticks * self.num_lanes
        return {
            "queries_done": float(len(done)),
            "queries_evicted": float(
                sum(q.status == "evicted" for q in self.finished)),
            "ticks": float(self.ticks),
            "supersteps": float(self.supersteps),
            "lane_occupancy": self._busy_lane_ticks / cap if cap else 0.0,
            "qps": len(done) / span if span > 0 else float("nan"),
            "latency_p50_s": _percentile(lat, 0.50),
            "latency_p95_s": _percentile(lat, 0.95),
            "latency_mean_s": float(np.mean(lat)) if lat else float("nan"),
            "queue_wait_mean_s": (float(np.mean(waits)) if waits
                                  else float("nan")),
            "supersteps_p50": _percentile(steps, 0.50),
            "supersteps_p95": _percentile(steps, 0.95),
        }


class ServingFrontend:
    """Routes a mixed-kind query stream to per-kind batchers.

    Payload lanes batch queries of ONE program, so a deployment serving
    BFS + SSSP + PPR runs one `GraphQueryBatcher` per kind; the frontend
    owns submission routing and a fair round-robin tick loop (each busy
    batcher advances one tick per round)."""

    def __init__(self, batchers: Dict[str, GraphQueryBatcher]):
        self.batchers = batchers

    def submit(self, kind: str, source: int, **kw) -> Query:
        return self.batchers[kind].submit(source, kind=kind, **kw)

    @property
    def idle(self) -> bool:
        return all(b.idle for b in self.batchers.values())

    def step(self) -> List[Query]:
        """One round: pump every batcher, tick the busy ones."""
        out: List[Query] = []
        for b in self.batchers.values():
            out.extend(b.pump())
            if b.busy:
                b.tick()
        return out

    def run(self, max_rounds: int = 100_000) -> List[Query]:
        out: List[Query] = []
        for _ in range(max_rounds):
            out.extend(self.step())
            if self.idle:
                break
        for b in self.batchers.values():
            out.extend(b.pump())
        return out

    def metrics(self) -> Dict[str, Dict[str, float]]:
        return {kind: b.metrics() for kind, b in self.batchers.items()}
