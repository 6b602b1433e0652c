"""Distributed GRE engine: the canonical superstep over k stacked shards.

Each shard owns one agent-graph partition (masters, agents and an edge
shard; `repro_torch.core.agent_graph`) and runs the SAME superstep as the
single-shard engine, with an exchange backend supplying the communication
(`repro_torch.core.exchange`):

  exchange="agent"     — scatter refresh before the local scatter-combine,
      combiner flush after it: |V_s| + |V_c| values a superstep (§5.1).
      `overlap=True` flushes the remote-destined edges' combine before the
      local-destined edges compute (§6.2): the pipelined backend's split
      tiles and phase shape.
  exchange="dense"     — the hash-partition/Pregel baseline: a collective ⊕
      over the full relabeled vertex vector `[k·cap]`.
  exchange="pipelined" — the Agent-Graph protocol over the static
      remote/local edge split of ingress, its flush merged at the top of
      the next superstep (a two-slot `Mailbox`).
  exchange="async"     — bounded staleness over the same split tiles:
      refresh and flush once per `staleness` supersteps.  Monotone programs
      (halting, ⊕ = min/max) only; others raise ValueError.
  exchange="null"      — no communication; correct only for k = 1.

Where the JAX package maps the k shards onto a device mesh with
`shard_map`, this engine lays the shards its process holds end to end in
ONE slot space on one device, held shard h at `[h·num_slots,
(h+1)·num_slots)` with its own local numbering (masters, scatter agents,
combiners, sink).  Each shard's edges are sorted by dst and the shards are
in order, so the stacked dst is sorted too and one row pointer built at
ingress lets one combine-kernel launch ⊕ every held shard at once.  The
shard-axis collectives go through a communicator
(`repro_torch.dist.comm`): `StackedComm(k)` (the default) holds all k
shards in one process, `ProcessGroupComm` one shard a rank of a
`torch.distributed` world (`comm.shards` says which; every host array of
the `AgentGraph` stays whole on each rank's host, and only the held rows
go to the device).  Every rank issues the same collectives in the same
order: no frontier route issues one, so each rank may pick its own.

The frontier choice (dense or compacted, and the capacities) is made once
for the held shards over their stacked slot space, where the JAX package
makes it per shard; an explicit `frontier_cap` is each shard's, as there,
so the stacked plan takes k_local times it.  For min/max programs both
give the dense scan's result bitwise.

Vertex state is flat over the held masters, `[k_local·cap, ...]` in
relabeled global-id order, so `run` returns the all-gathered
`vertex_data[old2new]` on every rank.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.agent_graph import AgentGraph, split_edge_tiles
from repro_torch.core.engine import (DevicePartition, EngineState, GREEngine,
                                     resolve_device)
from repro_torch.core.exchange import (AgentExchange, AsyncAgentExchange,
                                       CombineRoute, DenseExchange,
                                       NullExchange, PipelinedAgentExchange,
                                       PipelineTiles, ShardTopology)
from repro_torch.core.plan import execute_plan, execute_superstep
from repro_torch.core.vertex_program import VertexProgram
from repro_torch.dist.comm import StackedComm
from repro_torch.graph.structures import degree_buckets

__all__ = ["DistGREEngine", "stacked_from_arrays"]


def _check_async_eligible(program: VertexProgram) -> None:
    """Bounded staleness is sound only when delayed delivery cannot change
    the fixed point (`VertexProgram.monotone`): min/max messages are bounds
    that re-tighten on late arrival, but a sum-monoid message folded
    against a stale accumulator is double-counted."""
    if not program.monotone:
        raise ValueError(
            f"exchange='async' requires a monotone program (halting with "
            f"an idempotent min/max monoid); {program.name!r} uses "
            f"monoid={program.monoid.name!r}, halts={program.halts} — "
            f"bounded-staleness delivery would corrupt its fixed point. "
            f"Use exchange='agent' or 'pipelined' instead.")


def _stack_rows(a: np.ndarray, block: int) -> np.ndarray:
    """`[k, n]` local indices -> flat stacked indices `i * block + a[i]`."""
    k = a.shape[0]
    off = (np.arange(k, dtype=np.int64) * block).reshape(
        (k,) + (1,) * (a.ndim - 1))
    return a.astype(np.int64) + off


def _stacked_csr(indptr: np.ndarray, eidx: np.ndarray, width: int):
    """The shards' CSR indices (`[k, slots + 1]`, `[k, width]`) as one CSR
    over the stacked slot space, positions into the stacked edge columns:
    what `csr_layout` of the stacked columns gives (its stable src sort
    keeps each shard's edges in their own order), without the sort."""
    k = indptr.shape[0]
    n_real = indptr[:, -1].astype(np.int64)
    base = np.concatenate([[0], np.cumsum(n_real)[:-1]])
    ptr = (indptr[:, :-1].astype(np.int64) + base[:, None]).reshape(-1)
    ptr = np.concatenate([ptr, [n_real.sum()]]).astype(np.int32)
    ex = np.zeros(k * width, dtype=np.int32)
    ex[:n_real.sum()] = np.concatenate(
        [eidx[i, :n_real[i]].astype(np.int64) + i * width
         for i in range(k)])
    return ptr, ex


def _edge_part(src, dst, mask, props, indptr, eidx, max_deg, num_slots, k,
               cap, aux, device) -> DevicePartition:
    """A stacked partition of `[k, width]` edge columns with their shards'
    CSR indices: src are local slots (`num_slots` a shard), dst already
    index the stacked segment space."""
    total = k * num_slots
    ptr, ex = _stacked_csr(indptr, eidx, src.shape[1])
    bucket_id, sizes, max_degs = degree_buckets(ptr, total)
    arrays = {"src": _stack_rows(src, num_slots).reshape(-1).astype(np.int32),
              "dst": dst.reshape(-1).astype(np.int32),
              "edge_mask": mask.reshape(-1),
              "edge_props": {n: v.reshape(-1) for n, v in props.items()},
              "aux": aux, "csr_indptr": ptr, "csr_eidx": ex,
              "bucket_id": bucket_id}
    statics = {"num_masters": cap, "num_slots": total,
               "edges_sorted_by_dst": True, "csr_max_deg": max_deg,
               "bucket_sizes": sizes, "bucket_max_deg": max_degs,
               "shards": k}
    return DevicePartition.from_arrays(arrays, statics, device=device)


class DistGREEngine:
    """Runs a VertexProgram over an AgentGraph of `k` shards: the shards
    `comm.shards` of the communicator (all k, stacked, by default) on one
    device (CUDA unless `device="cpu"`).

    `plan=SuperstepPlan(...)` adopts a composed mode now (`adopt_plan`);
    `plan="auto-tuned"` asks the tuned-plan cache at `plan_cache` (as
    `GREEngine` does), keyed by the agent graph's fingerprint, the program
    and `mesh_size` = k, the first time an agent graph is in hand
    (`device_topology`, `init_state`, `make_superstep`, `make_run`); a
    miss keeps the arguments' knobs."""

    EXCHANGES = ("agent", "dense", "null", "pipelined", "async")

    def __init__(self, program: VertexProgram, k: int,
                 exchange: str = "agent", overlap: bool = False,
                 frontier: str = "auto", frontier_cap: Optional[int] = None,
                 staleness: int = 2, device="cuda", plan=None,
                 plan_cache=None, comm=None):
        if exchange not in self.EXCHANGES:
            raise ValueError(f"exchange must be one of {self.EXCHANGES}, "
                             f"got {exchange!r}")
        if exchange == "null" and k != 1:
            raise ValueError("exchange='null' drops all cross-shard "
                             f"traffic; it needs k == 1, got k={k}")
        if exchange == "async":
            _check_async_eligible(program)
            if staleness < 1:
                raise ValueError(
                    f"exchange='async' needs staleness >= 1, got {staleness}")
        self.device = resolve_device(device)
        self.program = program
        self.k = k
        self.comm = StackedComm(k) if comm is None else comm
        if self.comm.k != k:
            raise ValueError(f"the communicator spans {self.comm.k} shards, "
                             f"this engine k={k}")
        held = self.comm.shards
        # the held shards' rows of every `[k, ...]` host array (a view)
        self.rows = slice(held.start, held.stop)
        self.k_local = len(held)
        self.exchange = exchange
        self.overlap = overlap
        self.staleness = staleness
        # `frontier_cap` is a shard's capacity (as in the JAX package); the
        # local engine resolves the frontier over the held stacked shards
        self.frontier_cap = frontier_cap
        self.local = GREEngine(
            program, frontier=frontier,
            frontier_cap=(None if frontier_cap is None
                          else self.k_local * frontier_cap))
        self._plan_cache = plan_cache
        self._auto_plan_pending = False
        if plan is None:
            pass
        elif plan == "auto-tuned":
            self._auto_plan_pending = True
        else:
            self.adopt_plan(plan)

    def adopt_plan(self, plan) -> None:
        """Take a composed SuperstepPlan for every shard: the frontier
        stage lands on the local engine (its `frontier_cap` a shard's, so
        the stacked engine takes k_local times it) and the phase shape selects
        the exchange: "pipelined" the split-tile pipelined exchange,
        "async" the k-deep ring (monotone programs only; refuses
        otherwise, so a cached plan cannot bring staleness to a sum
        monoid), "sync" demotes either back to the sync agent exchange
        (and drops `overlap`, which runs the pipelined shape here).  The
        dense and null baselines are left alone: a plan tunes the
        Agent-Graph protocol."""
        if plan.phases == "async":
            _check_async_eligible(self.program)
        self.local.adopt_plan(plan)
        self.frontier_cap = plan.frontier_cap
        if plan.frontier_cap is not None:
            self.local.frontier_cap = self.k_local * plan.frontier_cap
        if plan.phases == "pipelined":
            self.exchange = "pipelined"
        elif plan.phases == "async":
            self.exchange = "async"
            self.staleness = plan.staleness
        else:
            if self.exchange in ("pipelined", "async"):
                self.exchange = "agent"
            self.overlap = False

    def _resolve_auto_plan(self, ag: AgentGraph) -> None:
        """`plan="auto-tuned"` against the plan cache (see
        `GREEngine._consult_plan_cache`).  The key folds in the shard
        count, the agent graph's remote-destination edge fraction and its
        partitioner: the facets a single-shard tuning run cannot see.  It
        has no frontier-density facet (the histogram is a shard's)."""
        self._auto_plan_pending = False
        from repro_torch.tuning import PlanCache, plan_cache_key
        cache = self._plan_cache
        if not isinstance(cache, PlanCache):
            cache = PlanCache(cache)
        plan = cache.lookup(plan_cache_key(agent_graph=ag,
                                           program=self.program,
                                           mesh_size=self.k))
        if plan is not None:
            self.adopt_plan(plan)

    @property
    def plan(self):
        """The plan every shard executes: the local engine's frontier stage
        and the phase shape, which picks the backend (`make_exchange`) and
        the topology's edge layout (`device_topology`)."""
        if self.exchange == "async":
            return self.local.make_plan(phases="async",
                                        staleness=self.staleness)
        split = self.exchange == "pipelined" or (self.exchange == "agent"
                                                 and self.overlap)
        return self.local.make_plan(phases="pipelined" if split else "sync")

    def _check(self, ag: AgentGraph) -> None:
        if ag.k != self.k:
            raise ValueError(f"the agent graph has k={ag.k} shards, this "
                             f"engine k={self.k}")
        if self._auto_plan_pending:
            self._resolve_auto_plan(ag)

    # ------------------------------------------------------ backend selection
    def make_exchange(self, topo: ShardTopology):
        """The exchange backend over `topo`: the plan's phase shape picks
        it, and among the sync shapes the configured exchange."""
        plan = self.plan
        dense = self.local.dense_frontier
        monoid = self.program.monoid
        if plan.phases == "async":
            return AsyncAgentExchange(topo, self.comm, monoid, dense,
                                      staleness=plan.staleness)
        if plan.phases == "pipelined":
            return PipelinedAgentExchange(topo, self.comm, monoid, dense)
        if self.exchange == "null":
            return NullExchange()
        if self.exchange == "dense":
            return DenseExchange(topo, self.comm, monoid, dense)
        return AgentExchange(topo, self.comm, monoid, dense)

    # ----------------------------------------------------------- host → device
    def _aux(self, ag: AgentGraph) -> Dict[str, np.ndarray]:
        """The held masters' `aux` columns, `[k_local·cap]` each."""
        masters = slice(self.rows.start * ag.cap, self.rows.stop * ag.cap)
        return {"out_degree": ag.out_degree[self.rows].reshape(-1),
                "global_id": ag.new2old[masters].astype(np.float32)}

    def device_topology(self, ag: AgentGraph) -> ShardTopology:
        """The held shards' stacked topology on the engine's device.

        Under the pipelined and async phase shapes every edge scan runs on
        the split tiles (`ShardTopology.tiles`) and the canonical partition
        carries no edge columns, only the slot statics and `aux` apply
        reads.
        """
        self._check(ag)
        kl, cap, ns, sink = self.k_local, ag.cap, ag.num_slots, ag.sink
        rows, dev = self.rows, self.device
        aux = self._aux(ag)
        tiles = None
        if self.plan.phases != "sync":
            part = DevicePartition.from_arrays(
                {"aux": aux}, {"num_masters": cap, "num_slots": kl * ns,
                               "edges_sorted_by_dst": True, "shards": kl},
                device=dev)
            tiles = self._pipeline_tiles(ag)
        else:
            part = _edge_part(
                ag.src[rows], _stack_rows(ag.dst[rows], ns),
                ag.edge_mask[rows],
                {n: v[rows] for n, v in ag.edge_props.items()},
                ag.csr_indptr[rows], ag.csr_eidx[rows], ag.csr_max_deg, ns,
                kl, cap, aux, dev)

        def to_dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        # received [k_local, k, s_x] buffer: row i, column j = what held
        # shard i got from shard j, landing on scat_recv_slot[i, j]
        keep = ag.scat_recv_slot[rows].reshape(-1) != sink
        recv_slot = _stack_rows(ag.scat_recv_slot[rows], ns).reshape(-1)
        # combine flush: received row j, column i lands on the master
        # comb_recv_master[j, i] of held shard j
        recv_master = ag.comb_recv_master[rows]
        comb_keep = recv_master != sink
        comb_recv = dense_route = None
        if self.plan.phases == "sync" and self.exchange != "null":
            comb_recv = CombineRoute.build(_stack_rows(recv_master, ns),
                                           comb_keep, kl * ns, dev)
        if self.exchange == "dense":
            dense_route = self._dense_route(ag)
        return ShardTopology(
            part=part,
            scat_send=to_dev(_stack_rows(ag.scat_send_master[rows], ns)),
            scat_recv_pos=to_dev(np.flatnonzero(keep)),
            scat_recv_slot=to_dev(recv_slot[keep]),
            comb_send=to_dev(_stack_rows(ag.comb_send_slot[rows], ns)),
            comb_recv=comb_recv, dense_route=dense_route, tiles=tiles)

    def _dense_route(self, ag: AgentGraph) -> CombineRoute:
        """DenseExchange's vectors `[k_local, k·cap]`, one a held shard:
        buffer entries are the held shards' masters (`[k_local·cap]`),
        then their combiners' partials (`[k_local, k, c_x]`); held shard
        h = shard i puts its master m at global id `i·cap + m` of row h and
        its partial for shard j's master r at `j·cap + r`."""
        k, kl, cap = ag.k, self.k_local, ag.cap
        width = k * cap
        h = np.arange(kl, dtype=np.int64)
        i = h + self.rows.start
        own = (h[:, None] * width + i[:, None] * cap
               + np.arange(cap)[None, :]).reshape(-1)
        # [i, j, p]: where shard j puts the partial it gets from shard i
        recv = ag.comb_recv_master.transpose(1, 0, 2)[self.rows]
        tgt = (h[:, None, None] * width
               + np.arange(k, dtype=np.int64)[None, :, None] * cap
               + recv.astype(np.int64))
        targets = np.concatenate([own, tgt.reshape(-1)])
        keep = np.concatenate([np.ones(own.shape, bool),
                               (recv < cap).reshape(-1)])
        return CombineRoute.build(targets, keep, kl * width, self.device)

    def _pipeline_tiles(self, ag: AgentGraph) -> PipelineTiles:
        """Stacked remote/local edge tiles and their exchange indices.

        Combiner slots start at `cap + s_pad` and the padding fill is the
        sink (`cap + s_pad + c_pad`), so a uniform subtraction sends real
        slots to `[0, c_pad)` and fills to `c_pad`, the remote tile's
        identity slot.  Receive-side master slots keep their index; padding
        is dropped (it would land on `cap`, the local identity slot).
        """
        # only the held shards' tiles are built (the pads are every
        # shard's)
        split = split_edge_tiles(ag, shards=self.comm.shards)
        kl, cap, c_pad, ns = self.k_local, ag.cap, ag.c_pad, ag.num_slots
        rows, comb_base = self.rows, cap + ag.s_pad

        def tile_part(t, block):
            return _edge_part(t.src, _stack_rows(t.dst, block), t.mask,
                              t.props, t.csr_indptr, t.csr_eidx,
                              t.csr_max_deg, ns, kl, cap, {}, self.device)

        recv = ag.comb_recv_master[rows]
        return PipelineTiles(
            part_remote=tile_part(split.remote, c_pad + 1),
            part_local=tile_part(split.local, cap + 1),
            comb_send=torch.from_numpy(_stack_rows(
                ag.comb_send_slot[rows] - comb_base,
                c_pad + 1)).to(self.device),
            comb_recv=CombineRoute.build(_stack_rows(recv, cap + 1),
                                         recv != ag.sink, kl * (cap + 1),
                                         self.device),
            num_combiners=c_pad)

    def init_state(self, ag: AgentGraph, source=None,
                   lane_tracking: bool = False) -> EngineState:
        """The held shards' initial state.  `source` is an ORIGINAL vertex
        id, or, for `payload_shape=(D,)` multi-source programs, a length-D
        sequence of original ids (source d seeds payload lane d; a `None`
        or negative entry leaves lane d empty); a source seeds only on the
        process that holds its master.

        `lane_tracking=True` attaches the per-lane halt vector
        `[k_local, D]`."""
        self._check(ag)
        p = self.program
        kl, cap, ns = self.k_local, ag.cap, ag.num_slots
        dev = self.device
        aux = {n: torch.from_numpy(a).to(dev)
               for n, a in self._aux(ag).items()}
        vd = p.init_vertex_data(kl * cap, aux)
        sd0 = p.init_scatter_data(kl * cap, aux).to(p.msg_dtype)
        payload = tuple(sd0.shape[1:])
        sd = torch.full((kl, ns) + payload, p.monoid.identity,
                        dtype=p.msg_dtype, device=dev)
        sd[:, :cap] = sd0.reshape((kl, cap) + payload)
        act = torch.zeros((kl, ns), dtype=torch.bool, device=dev)
        # padding masters (no original vertex) stay inactive
        real = aux["global_id"] >= 0
        act[:, :cap] = (p.init_active(kl * cap, aux) & real).reshape(kl, cap)
        sd = sd.reshape((kl * ns,) + payload)
        act = act.reshape(-1)
        seeded = []
        if source is not None:
            multi = isinstance(source, (list, tuple, np.ndarray))
            act = torch.zeros_like(act)
            for d, sv in enumerate(source if multi else [source]):
                ok = sv is not None and int(sv) >= 0
                seeded.append(ok)
                if not ok:
                    continue
                g = int(ag.old2new[int(sv)])
                i, s = g // cap - self.rows.start, g % cap
                if not 0 <= i < kl:
                    continue          # another process holds its master
                g, slot = i * cap + s, i * ns + s
                if multi and p.seed_sources is not None:
                    rows = slice(i * cap, (i + 1) * cap)
                    srows = slice(i * ns, (i + 1) * ns)
                    aux_i = {n: a[rows] for n, a in aux.items()}
                    vd_i, sd_i = p.seed_sources(
                        vd[rows], sd[srows],
                        torch.tensor([s], dtype=torch.int32, device=dev),
                        torch.tensor([d], dtype=torch.int32, device=dev),
                        aux_i)
                    vd[rows], sd[srows] = vd_i, sd_i
                elif multi:  # seed payload lane d only
                    vd[g, d] = 0.0
                    sd[slot, d] = 0.0
                else:
                    vd[g] = 0.0
                    sd[slot] = 0.0
                act[slot] = True
        lane_active = None
        if lane_tracking:
            if p.lane_activates is None or not p.payload_shape:
                raise ValueError(
                    "lane_tracking needs a multi-source program with "
                    "lane_activates (per-lane halt rule)")
            D = p.payload_shape[0]
            if len(seeded) not in (0, D):
                raise ValueError(f"expected {D} source entries")
            row = np.zeros(D, dtype=bool) if not seeded else np.array(seeded)
            lane_active = torch.from_numpy(
                np.broadcast_to(row, (kl, D)).copy()).to(dev)
        return EngineState(vd, sd, act, 0, lane_active)

    # ------------------------------------------------------------ incremental
    def warm_start_state(self, ag: AgentGraph, prev_state: EngineState,
                         report, source=None, lane_tracking: bool = False
                         ) -> EngineState:
        """Distributed warm start (see `GREEngine.warm_start_state`): the
        invalidation and seeding passes run on the host in ORIGINAL vertex
        order over every shard (`old2new` maps the stacked master rows out
        and back; a process all-gathers the master rows it does not hold),
        so the policy code (`repro_torch.core.incremental`) is the single
        shard's; the held rows are then taken.  `ag` is the MUTATED agent
        graph; `apply_edge_delta` keeps master placement, so `prev_state`'s
        master rows (this process's) line up even when the pads regrew."""
        from repro_torch.core import incremental
        from repro_torch.core.agent_graph import slot_to_original
        self._check(ag)
        p = self.program
        incremental.check_supported(p, report)
        k, kl, cap, V = ag.k, self.k_local, ag.cap, ag.num_vertices
        ns = ag.num_slots
        state0 = self.init_state(ag, source=source,
                                 lane_tracking=lane_tracking)
        payload = tuple(state0.scatter_data.shape[1:])
        ns_prev = prev_state.scatter_data.shape[0] // kl

        def masters(sd, slots):   # [kl·slots, ...] -> [kl·cap, ...]
            return sd.reshape((kl, slots) + payload)[:, :cap].reshape(
                (kl * cap,) + payload)

        sd = state0.scatter_data.clone()
        sd_view = sd.view((kl, ns) + payload)
        if not p.halts:
            sd_view[:, :cap] = masters(prev_state.scatter_data,
                                       ns_prev).reshape(
                                           (kl, cap) + payload)
            return dataclasses.replace(state0,
                                       vertex_data=prev_state.vertex_data,
                                       scatter_data=sd)

        def every(x):   # held master rows -> [k·cap, ...] on the host
            rows = x.reshape((kl, cap) + tuple(x.shape[1:]))
            return self.comm.all_gather(rows).reshape(
                (k * cap,) + tuple(x.shape[1:])).cpu().numpy()

        o2n = ag.old2new
        vd_prev = every(prev_state.vertex_data)[o2n]
        sd_prev = every(masters(prev_state.scatter_data, ns_prev))[o2n]
        s2o = slot_to_original(ag)
        m = ag.edge_mask
        lsrc = np.concatenate([s2o[i][ag.src[i]][m[i]] for i in range(k)])
        ldst = np.concatenate([s2o[i][ag.dst[i]][m[i]] for i in range(k)])
        eprop = (np.concatenate([ag.edge_props[p.needs_edge_prop][i][m[i]]
                                 for i in range(k)])
                 if p.needs_edge_prop else None)
        protected = incremental.source_mask(vd_prev.shape, source)
        tainted = incremental.compute_taint(p, V, lsrc, ldst, eprop,
                                            vd_prev, report, protected)
        vd0 = every(state0.vertex_data)
        vd = np.where(tainted, vd0[o2n], vd_prev)
        sd0 = every(masters(state0.scatter_data, ns))
        sd_new = np.where(tainted, sd0[o2n], sd_prev)
        tany = tainted if tainted.ndim == 1 else tainted.any(axis=-1)
        aux_orig = {
            "out_degree": torch.from_numpy(
                ag.out_degree.reshape(k * cap)[o2n]),
            "global_id": torch.arange(V, dtype=torch.float32)}
        init_act = p.init_active(V, aux_orig).numpy()
        act = incremental.warm_seed_active(V, lsrc, ldst, tany,
                                           report.added_src, init_act)
        # scatter the original-order columns back into the stacked layout,
        # then keep the held rows
        vd_st = vd0.copy()
        vd_st[o2n] = vd
        sd_st = sd0.copy()
        sd_st[o2n] = sd_new
        act_st = np.zeros(k * cap, dtype=bool)
        act_st[o2n] = act
        held = slice(self.rows.start * cap, self.rows.stop * cap)
        dev = self.device
        sd_view[:, :cap] = torch.from_numpy(sd_st[held]).to(dev).reshape(
            (kl, cap) + payload)
        active = torch.zeros((kl, ns), dtype=torch.bool, device=dev)
        active[:, :cap] = torch.from_numpy(act_st[held]).to(dev).reshape(
            kl, cap)
        return dataclasses.replace(
            state0, vertex_data=torch.from_numpy(vd_st[held]).to(dev),
            scatter_data=sd, active_scatter=active.reshape(-1))

    def rerun_incremental(self, ag: AgentGraph, prev_state: EngineState,
                          delta, *, source=None, max_steps: int = 100):
        """Apply an EdgeDelta to the agent graph and re-converge from
        `prev_state`'s fixed point.  A delta appends exchange pairs, so
        the stacked topology is rebuilt from the new agent graph.

        Returns ``(new_ag, result_in_original_order, final_state,
        report)``, bitwise-equal to a cold `run` on the mutated graph for
        halting min-monoid programs.  `last_rerun_s` keeps the host
        seconds of its stages (delta ingress, warm start, topology
        rebuild, run)."""
        from repro_torch.core.agent_graph import apply_edge_delta
        t0 = time.perf_counter()
        new_ag, report = apply_edge_delta(ag, delta)
        t1 = time.perf_counter()
        state = self.warm_start_state(new_ag, prev_state, report,
                                      source=source)
        t2 = time.perf_counter()
        topo = self.device_topology(new_ag)
        t3 = time.perf_counter()
        out = self.make_run(new_ag, max_steps=max_steps)(topo, state)
        result = self.original_order(new_ag, out.vertex_data)
        t4 = time.perf_counter()
        self.last_rerun_s = {"apply_edge_delta": t1 - t0,
                             "warm_start_state": t2 - t1,
                             "device_topology": t3 - t2, "run": t4 - t3}
        return new_ag, result, out, report

    # ------------------------------------------------------------------ tick
    def make_superstep(self, ag: AgentGraph, steps_per_tick: int = 1):
        """The SERVING TICK: `fn(topo, state)` runs `steps_per_tick`
        supersteps over the stacked shards with NO convergence loop around
        them; the serving layer (`repro_torch.serving.graph_scheduler`)
        owns the loop, so it can retire and admit payload lanes between
        ticks.

        Each superstep merges within the tick (`plan.execute_superstep`):
        a mailbox carried across ticks would hold partial combines of a
        retired query.  The per-lane halt rows are OR-ed over every shard
        through the communicator (`pmax`, as the JAX package's
        `lax.pmax`), so every row of `lane_active` is the global verdict.
        `exchange="async"` cannot serve ticks: its ring holds remote
        partials for up to `staleness` supersteps, and dropping them at a
        tick boundary would lose messages outright."""
        self._check(ag)
        if self.exchange == "async":
            raise ValueError(
                "exchange='async' cannot drive the serving tick: the "
                "staleness ring carries un-flushed remote partials across "
                "supersteps, and a per-tick merge would drop them. Use "
                "exchange='agent' or 'pipelined' for serving.")

        def tick(topo: ShardTopology, state: EngineState) -> EngineState:
            backend = self.make_exchange(topo)
            for _ in range(steps_per_tick):
                state = execute_superstep(self.local, topo.part, state,
                                          backend)
            if state.lane_active is not None:
                la = self.comm.pmax(
                    state.lane_active.reshape(self.k_local, -1))
                state = dataclasses.replace(state,
                                            lane_active=la.contiguous())
            return state
        return tick

    # ------------------------------------------------------------------- run
    def make_run(self, ag: AgentGraph, max_steps: int = 100):
        """The distributed run: `fn(topo, state) -> final state` (the held
        shards'), through the one BSP loop (`plan.execute_plan`) with the
        communicator's `any` as the halt test over all shards."""
        self._check(ag)

        def run(topo: ShardTopology, state: EngineState) -> EngineState:
            backend = self.make_exchange(topo)
            return execute_plan(self.local, topo.part, state, backend,
                                max_steps=max_steps,
                                any_active=self.comm.any)
        return run

    def run(self, ag: AgentGraph, source=None,
            max_steps: int = 100) -> Tuple[np.ndarray, EngineState]:
        """Execute; returns (vertex_data of every shard in ORIGINAL vertex
        order, the held shards' final state)."""
        topo = self.device_topology(ag)
        state = self.init_state(ag, source=source)
        out = self.make_run(ag, max_steps=max_steps)(topo, state)
        return self.original_order(ag, out.vertex_data), out

    def original_order(self, ag: AgentGraph,
                       vertex_data: torch.Tensor) -> np.ndarray:
        """The held master rows `[k_local·cap, ...]` -> every shard's
        `[V, ...]` in original ids (`comm.all_gather`: a collective)."""
        payload = tuple(vertex_data.shape[1:])
        rows = vertex_data.reshape((self.k_local, ag.cap) + payload)
        every = self.comm.all_gather(rows).reshape((-1,) + payload)
        return _original_order(ag, every)


def _original_order(ag: AgentGraph, vertex_data: torch.Tensor) -> np.ndarray:
    """Stacked master rows `[k·cap, ...]` -> `[V, ...]` in original ids."""
    return vertex_data.cpu().numpy()[ag.old2new]


def stacked_from_arrays(engine: DistGREEngine, ag_fields: Dict[str, object],
                        state_arrays: Optional[Dict[str, object]] = None):
    """Carry a graph and its state across from host arrays.

    `ag_fields` holds every field of an `AgentGraph`, e.g. `vars()` of a
    JAX-package `AgentGraph` (its host arrays are numpy); `state_arrays`
    holds `np.asarray` of every field of a JAX-package stacked
    `EngineState` (`vertex_data [k, cap, ...]`, `scatter_data [k, slots,
    ...]`, `active_scatter [k, slots]`, `step [k]`, optional `lane_active
    [k, D]`).  Returns `(ag, topo, state)` of this package on the engine's
    device, the state of the shards the engine holds (`engine.rows`);
    `state` is None without `state_arrays`.
    """
    names = {f.name for f in dataclasses.fields(AgentGraph)}
    ag = AgentGraph(**{n: v for n, v in ag_fields.items() if n in names})
    topo = engine.device_topology(ag)
    if state_arrays is None:
        return ag, topo, None
    dev = engine.device

    def flat(a):
        a = np.asarray(a)[engine.rows]
        return torch.from_numpy(np.require(
            a.reshape((-1,) + a.shape[2:]),
            requirements=["C", "W"])).to(dev)

    steps = np.asarray(state_arrays.get("step", 0)).reshape(-1)
    if steps.size and not np.all(steps == steps[0]):
        raise ValueError(f"shards disagree on the superstep: {steps}")
    lane = state_arrays.get("lane_active")
    state = EngineState(
        vertex_data=flat(state_arrays["vertex_data"]),
        scatter_data=flat(state_arrays["scatter_data"]),
        active_scatter=flat(state_arrays["active_scatter"]),
        step=int(steps[0]) if steps.size else 0,
        lane_active=None if lane is None else torch.from_numpy(
            np.require(np.asarray(lane)[engine.rows],
                       requirements=["C", "W"])).to(dev))
    return ag, topo, state
