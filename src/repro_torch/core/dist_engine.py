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
`shard_map`, this engine lays them end to end in ONE slot space on one
device, shard i at `[i·num_slots, (i+1)·num_slots)` with its own local
numbering (masters, scatter agents, combiners, sink).  Each shard's edges
are sorted by dst and the shards are in order, so the stacked dst is
sorted too and one row pointer built at ingress lets one combine-kernel
launch ⊕ every shard at once.  The shard-axis collectives go through a
communicator (`repro_torch.dist.comm.StackedComm`).  The frontier choice
(dense or compacted, and the capacities) is made once for all shards over
the stacked slot space, where the JAX package makes it per shard; an
explicit `frontier_cap` is each shard's, as there, so the stacked plan
takes k times it.  For min/max programs both give the dense scan's result
bitwise.

Vertex state is flat over the stacked masters, `[k·cap, ...]` in relabeled
global-id order, so `run` returns `vertex_data[old2new]`.
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
    """Runs a VertexProgram over an AgentGraph of `k` shards, stacked on one
    device (CUDA unless `device="cpu"`)."""

    EXCHANGES = ("agent", "dense", "null", "pipelined", "async")

    def __init__(self, program: VertexProgram, k: int,
                 exchange: str = "agent", overlap: bool = False,
                 frontier: str = "auto", frontier_cap: Optional[int] = None,
                 staleness: int = 2, device="cuda"):
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
        self.comm = StackedComm(k)
        self.exchange = exchange
        self.overlap = overlap
        self.staleness = staleness
        # `frontier_cap` is a shard's capacity (as in the JAX package); the
        # local engine resolves the frontier over all k stacked shards
        self.frontier_cap = frontier_cap
        self.local = GREEngine(
            program, frontier=frontier,
            frontier_cap=None if frontier_cap is None else k * frontier_cap)

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
        return {"out_degree": ag.out_degree.reshape(-1),
                "global_id": ag.new2old.astype(np.float32)}

    def device_topology(self, ag: AgentGraph) -> ShardTopology:
        """The stacked topology on the engine's device.

        Under the pipelined and async phase shapes every edge scan runs on
        the split tiles (`ShardTopology.tiles`) and the canonical partition
        carries no edge columns, only the slot statics and `aux` apply
        reads.
        """
        self._check(ag)
        k, cap, ns, sink = ag.k, ag.cap, ag.num_slots, ag.sink
        dev = self.device
        aux = self._aux(ag)
        tiles = None
        if self.plan.phases != "sync":
            part = DevicePartition.from_arrays(
                {"aux": aux}, {"num_masters": cap, "num_slots": k * ns,
                               "edges_sorted_by_dst": True, "shards": k},
                device=dev)
            tiles = self._pipeline_tiles(ag)
        else:
            part = _edge_part(ag.src, _stack_rows(ag.dst, ns), ag.edge_mask,
                              ag.edge_props, ag.csr_indptr, ag.csr_eidx,
                              ag.csr_max_deg, ns, k, cap, aux, dev)

        def to_dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        # received [k, k, s_x] buffer: row i, column j = what shard i got
        # from shard j, landing on scat_recv_slot[i, j]
        keep = ag.scat_recv_slot.reshape(-1) != sink
        recv_slot = _stack_rows(ag.scat_recv_slot, ns).reshape(-1)
        # combine flush: received row j, column i lands on the master
        # comb_recv_master[j, i] of shard j
        recv_master = ag.comb_recv_master
        comb_keep = recv_master != sink
        comb_recv = dense_route = None
        if self.plan.phases == "sync" and self.exchange != "null":
            comb_recv = CombineRoute.build(_stack_rows(recv_master, ns),
                                           comb_keep, k * ns, dev)
        if self.exchange == "dense":
            dense_route = self._dense_route(ag)
        return ShardTopology(
            part=part,
            scat_send=to_dev(_stack_rows(ag.scat_send_master, ns)),
            scat_recv_pos=to_dev(np.flatnonzero(keep)),
            scat_recv_slot=to_dev(recv_slot[keep]),
            comb_send=to_dev(_stack_rows(ag.comb_send_slot, ns)),
            comb_recv=comb_recv, dense_route=dense_route, tiles=tiles)

    def _dense_route(self, ag: AgentGraph) -> CombineRoute:
        """DenseExchange's per-shard vectors `[k, k·cap]`: buffer entries
        are each shard's masters (`[k·cap]`), then its combiners' partials
        (`[k, k, c_x]`); shard i's vector puts its master m at global id
        `i·cap + m` and its partial for shard j's master r at `j·cap + r`."""
        k, cap = ag.k, ag.cap
        width = k * cap
        i = np.arange(k, dtype=np.int64)
        own = (i[:, None] * width + i[:, None] * cap
               + np.arange(cap)[None, :]).reshape(-1)
        recv = ag.comb_recv_master.transpose(1, 0, 2)    # [i, j, p] on j
        tgt = (i[:, None, None] * width + i[None, :, None] * cap
               + recv.astype(np.int64))
        targets = np.concatenate([own, tgt.reshape(-1)])
        keep = np.concatenate([np.ones(own.shape, bool),
                               (recv < cap).reshape(-1)])
        return CombineRoute.build(targets, keep, k * width, self.device)

    def _pipeline_tiles(self, ag: AgentGraph) -> PipelineTiles:
        """Stacked remote/local edge tiles and their exchange indices.

        Combiner slots start at `cap + s_pad` and the padding fill is the
        sink (`cap + s_pad + c_pad`), so a uniform subtraction sends real
        slots to `[0, c_pad)` and fills to `c_pad`, the remote tile's
        identity slot.  Receive-side master slots keep their index; padding
        is dropped (it would land on `cap`, the local identity slot).
        """
        split = split_edge_tiles(ag)
        k, cap, c_pad, ns = ag.k, ag.cap, ag.c_pad, ag.num_slots
        comb_base = cap + ag.s_pad

        def tile_part(t, block):
            return _edge_part(t.src, _stack_rows(t.dst, block), t.mask,
                              t.props, t.csr_indptr, t.csr_eidx,
                              t.csr_max_deg, ns, k, cap, {}, self.device)

        recv = ag.comb_recv_master
        return PipelineTiles(
            part_remote=tile_part(split.remote, c_pad + 1),
            part_local=tile_part(split.local, cap + 1),
            comb_send=torch.from_numpy(_stack_rows(
                ag.comb_send_slot - comb_base, c_pad + 1)).to(self.device),
            comb_recv=CombineRoute.build(_stack_rows(recv, cap + 1),
                                         recv != ag.sink, k * (cap + 1),
                                         self.device),
            num_combiners=c_pad)

    def init_state(self, ag: AgentGraph, source=None,
                   lane_tracking: bool = False) -> EngineState:
        """The stacked initial state.  `source` is an ORIGINAL vertex id,
        or, for `payload_shape=(D,)` multi-source programs, a length-D
        sequence of original ids (source d seeds payload lane d; a `None`
        or negative entry leaves lane d empty).

        `lane_tracking=True` attaches the per-lane halt vector `[k, D]`."""
        self._check(ag)
        p = self.program
        k, cap, ns = ag.k, ag.cap, ag.num_slots
        dev = self.device
        aux = {n: torch.from_numpy(a).to(dev)
               for n, a in self._aux(ag).items()}
        vd = p.init_vertex_data(k * cap, aux)
        sd0 = p.init_scatter_data(k * cap, aux).to(p.msg_dtype)
        payload = tuple(sd0.shape[1:])
        sd = torch.full((k, ns) + payload, p.monoid.identity,
                        dtype=p.msg_dtype, device=dev)
        sd[:, :cap] = sd0.reshape((k, cap) + payload)
        act = torch.zeros((k, ns), dtype=torch.bool, device=dev)
        # padding masters (no original vertex) stay inactive
        real = torch.from_numpy(ag.new2old >= 0).to(dev)
        act[:, :cap] = (p.init_active(k * cap, aux) & real).reshape(k, cap)
        sd = sd.reshape((k * ns,) + payload)
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
                i, s = g // cap, g % cap
                slot = i * ns + s
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
                np.broadcast_to(row, (k, D)).copy()).to(dev)
        return EngineState(vd, sd, act, 0, lane_active)

    # ------------------------------------------------------------ incremental
    def warm_start_state(self, ag: AgentGraph, prev_state: EngineState,
                         report, source=None, lane_tracking: bool = False
                         ) -> EngineState:
        """Distributed warm start (see `GREEngine.warm_start_state`): the
        invalidation and seeding passes run on the host in ORIGINAL vertex
        order (`old2new` maps the stacked master rows out and back), so
        the policy code (`repro_torch.core.incremental`) is the single
        shard's.  `ag` is the MUTATED agent graph; `apply_edge_delta`
        keeps master placement, so `prev_state`'s master rows line up even
        when the pads regrew."""
        from repro_torch.core import incremental
        from repro_torch.core.agent_graph import slot_to_original
        self._check(ag)
        p = self.program
        incremental.check_supported(p, report)
        k, cap, V, ns = ag.k, ag.cap, ag.num_vertices, ag.num_slots
        state0 = self.init_state(ag, source=source,
                                 lane_tracking=lane_tracking)
        payload = tuple(state0.scatter_data.shape[1:])
        ns_prev = prev_state.scatter_data.shape[0] // k

        def masters(sd, slots):   # stacked [k·slots, ...] -> [k·cap, ...]
            return sd.reshape((k, slots) + payload)[:, :cap].reshape(
                (k * cap,) + payload)

        sd = state0.scatter_data.clone()
        sd_view = sd.view((k, ns) + payload)
        if not p.halts:
            sd_view[:, :cap] = masters(prev_state.scatter_data,
                                       ns_prev).reshape(
                                           (k, cap) + payload)
            return dataclasses.replace(state0,
                                       vertex_data=prev_state.vertex_data,
                                       scatter_data=sd)
        o2n = ag.old2new
        vd_prev = prev_state.vertex_data.cpu().numpy()[o2n]
        sd_prev = masters(prev_state.scatter_data, ns_prev).cpu().numpy()[o2n]
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
        vd0 = state0.vertex_data.cpu().numpy()
        vd = np.where(tainted, vd0[o2n], vd_prev)
        sd0 = masters(state0.scatter_data, ns).cpu().numpy()
        sd_new = np.where(tainted, sd0[o2n], sd_prev)
        tany = tainted if tainted.ndim == 1 else tainted.any(axis=-1)
        aux_orig = {
            "out_degree": torch.from_numpy(
                ag.out_degree.reshape(k * cap)[o2n]),
            "global_id": torch.arange(V, dtype=torch.float32)}
        init_act = p.init_active(V, aux_orig).numpy()
        act = incremental.warm_seed_active(V, lsrc, ldst, tany,
                                           report.added_src, init_act)
        # scatter the original-order columns back into the stacked layout
        vd_st = vd0.copy()
        vd_st[o2n] = vd
        sd_st = sd0.copy()
        sd_st[o2n] = sd_new
        act_st = np.zeros(k * cap, dtype=bool)
        act_st[o2n] = act
        dev = self.device
        sd_view[:, :cap] = torch.from_numpy(sd_st).to(dev).reshape(
            (k, cap) + payload)
        active = torch.zeros((k, ns), dtype=torch.bool, device=dev)
        active[:, :cap] = torch.from_numpy(act_st).to(dev).reshape(k, cap)
        return dataclasses.replace(
            state0, vertex_data=torch.from_numpy(vd_st).to(dev),
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
        result = original_order(new_ag, out.vertex_data)
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
        retired query.  The per-lane halt rows are OR-ed over the shards,
        so every row of `lane_active` is the global verdict.
        `exchange="async"` cannot serve ticks: its ring holds remote
        partials for up to `staleness` supersteps, and dropping them at a
        tick boundary would lose messages outright."""
        if self.exchange == "async":
            raise ValueError(
                "exchange='async' cannot drive the serving tick: the "
                "staleness ring carries un-flushed remote partials across "
                "supersteps, and a per-tick merge would drop them. Use "
                "exchange='agent' or 'pipelined' for serving.")
        self._check(ag)

        def tick(topo: ShardTopology, state: EngineState) -> EngineState:
            backend = self.make_exchange(topo)
            for _ in range(steps_per_tick):
                state = execute_superstep(self.local, topo.part, state,
                                          backend)
            if state.lane_active is not None:
                la = state.lane_active.any(dim=0, keepdim=True)
                state = dataclasses.replace(
                    state, lane_active=la.expand_as(
                        state.lane_active).contiguous())
            return state
        return tick

    # ------------------------------------------------------------------- run
    def make_run(self, ag: AgentGraph, max_steps: int = 100):
        """The distributed run: `fn(topo, state) -> final state`, through
        the one BSP loop (`plan.execute_plan`) with the communicator's `any`
        as the halt test over all shards."""
        self._check(ag)

        def run(topo: ShardTopology, state: EngineState) -> EngineState:
            backend = self.make_exchange(topo)
            return execute_plan(self.local, topo.part, state, backend,
                                max_steps=max_steps,
                                any_active=self.comm.any)
        return run

    def run(self, ag: AgentGraph, source=None,
            max_steps: int = 100) -> Tuple[np.ndarray, EngineState]:
        """Execute; returns (vertex_data in ORIGINAL vertex order, state)."""
        topo = self.device_topology(ag)
        state = self.init_state(ag, source=source)
        out = self.make_run(ag, max_steps=max_steps)(topo, state)
        return original_order(ag, out.vertex_data), out


def original_order(ag: AgentGraph, vertex_data: torch.Tensor) -> np.ndarray:
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
    device; `state` is None without `state_arrays`.
    """
    names = {f.name for f in dataclasses.fields(AgentGraph)}
    ag = AgentGraph(**{n: v for n, v in ag_fields.items() if n in names})
    topo = engine.device_topology(ag)
    if state_arrays is None:
        return ag, topo, None
    dev = engine.device

    def flat(a):
        a = np.asarray(a)
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
            np.require(lane, requirements=["C", "W"])).to(dev))
    return ag, topo, state
