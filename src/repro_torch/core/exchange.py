"""ExchangeBackend: the communication seam of the superstep.

The GRE computation model (paper §4, Alg. 2) is one canonical superstep,
refresh → scatter-combine → apply, whatever carries partial combines across
shards.  The backends:

  NullExchange   — single shard: every destination is local, nothing moves.
  AgentExchange  — the paper's Agent-Graph (§5): masters push ONE message
                   per (master, peer) to scatter agents before the local
                   phase; combiners push ONE ⊕-reduced message per agent to
                   their master after it.  |V_s| + |V_c| values a superstep.
  DenseExchange  — hash-partition/Pregel baseline: each shard ⊕-reduces the
                   full relabeled vertex vector `[k·cap]` with the others.
  PipelinedAgentExchange — the Agent-Graph protocol over the static
                   remote/local edge split of ingress
                   (`agent_graph.split_edge_tiles`): the remote tile is
                   combined and flushed first, the local tile after, and
                   the two partials ride a `Mailbox` whose merge waits for
                   the top of the next superstep (`plan.execute_plan`).
                   It also serves the agent exchange's `overlap=True`
                   (§6.2: the remote-destined edges combine and flush
                   before the local-destined ones compute).
  AsyncAgentExchange — bounded staleness for MONOTONE programs (halting,
                   ⊕ = min/max): the mailbox becomes a `staleness`-deep ring
                   of remote partials, refresh and flush run once per
                   window, local updates merge every superstep.

The distributed backends work on the stacked layout of
`repro_torch.core.dist_engine`: the shards a process holds (all k, or one
a rank) lie end to end in one slot space, every exchange index is a flat
index into it, and the shard-axis collectives go through a communicator
(`repro_torch.dist.comm`), whose `k` and `shards` are the only facts of
the world the backends read.  Padding
entries of the exchange lists (sink targets) are dropped where values land,
so every write is to a distinct slot and the sink keeps the identity.

Every backend speaks the phase protocol `plan.execute_plan` drives:
`local_phase` produces the superstep's carry, `merge` folds it into what
apply consumes, `carry_init` builds an identity-valued placeholder, and
`carry_pending` says whether the carry holds contributions the halt test
must wait for.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from repro_torch.core.vertex_program import Monoid
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.segment_combine import segment_row_pointer

if TYPE_CHECKING:  # pragma: no cover - typing only, avoids a cycle
    from repro_torch.core.engine import DevicePartition, EngineState


@dataclasses.dataclass
class CombineRoute:
    """The fixed receive side of a ⊕ across shards.

    A received buffer's entries land on targets known at ingress, so they
    are sorted once: `order` holds the positions of the entries that land
    (padding dropped), stably sorted by target, `dst` their targets and
    `seg_ptr` its row pointer.  Each superstep's ⊕ is then one dense-route
    combine launch, in the buffer's order within a segment.
    """

    order: torch.Tensor     # [n] int64 positions into the flat buffer
    dst: torch.Tensor       # [n] int32 targets, ascending
    seg_ptr: torch.Tensor   # [num_segments + 1] int32
    num_segments: int

    @staticmethod
    def build(targets: np.ndarray, keep: np.ndarray, num_segments: int,
              device: torch.device) -> "CombineRoute":
        """`targets[p]` is where buffer entry p lands when `keep[p]`."""
        targets, keep = targets.reshape(-1), keep.reshape(-1)
        pos = np.flatnonzero(keep)
        order = pos[np.argsort(targets[pos], kind="stable")]
        dst = torch.from_numpy(targets[order].astype(np.int32)).to(device)
        return CombineRoute(torch.from_numpy(order).to(device), dst,
                            segment_row_pointer(dst, num_segments),
                            num_segments)

    def combine(self, flat: torch.Tensor, monoid: Monoid) -> torch.Tensor:
        """⊕ of `flat [N, *payload]` into `[num_segments, *payload]`."""
        return kernel_ops.segment_combine(
            flat.index_select(0, self.order), self.dst, self.num_segments,
            monoid.name, seg_ptr=self.seg_ptr)


@dataclasses.dataclass
class PipelineTiles:
    """Stacked remote/local edge tiles of the pipelined and async backends.

    `part_remote` holds the combiner-destined edges with dst relabeled into
    the compact combiner space, shard i at `[i·(c_pad+1), (i+1)·(c_pad+1))`,
    `part_local` the master-destined ones in the compact master space,
    shard i at `[i·(cap+1), (i+1)·(cap+1))`; the last slot of each shard's
    block is its identity slot.  `comb_send` indexes the remote ⊕ array,
    `comb_recv` folds the flush into the compact master space.
    """

    part_remote: "DevicePartition"
    part_local: "DevicePartition"
    comb_send: torch.Tensor          # [k, k, c_x] into the remote ⊕ array
    comb_recv: CombineRoute          # into [k·(cap + 1)]
    num_combiners: int               # c_pad


@dataclasses.dataclass
class Mailbox:
    """Two-slot superstep buffer of the pipelined loop: `flushed` is the
    flush's landing buffer, `local` the local-tile partial ⊕; the merge at
    the top of the next superstep folds the two."""

    local: torch.Tensor    # [k·(cap + 1), *payload]
    flushed: torch.Tensor  # [k·(cap + 1), *payload]


@dataclasses.dataclass
class AsyncRing:
    """k-deep generalisation of `Mailbox` for bounded staleness.

    `ring[i]` is the remote-tile partial ⊕ of the superstep with
    `step % k == i`; at the window's end the k entries ⊕-fold and flush at
    once, landing in `landed` for the next merge.  `dirty` records whether
    a master improved since the last scatter refresh.
    """

    local: torch.Tensor    # [shards·(cap + 1), *payload]
    landed: torch.Tensor   # [shards·(cap + 1), *payload]
    ring: tuple            # k tensors [shards·(c_pad + 1), *payload]
    dirty: torch.Tensor    # 0-dim bool


@dataclasses.dataclass
class ShardTopology:
    """The stacked topology: the held shards' partitions and exchange
    indices (k_local of the k shards: all k when stacked, one a rank).

    Indices are flat slot indices of the stacked slot space.  `scat_send`
    and `comb_send` are `[k_local, k, x]` send buffers (row i, column j:
    what held shard i sends to shard j); the receive sides hold only the
    entries that land: `scat_recv_pos` are positions in the received
    `[k_local·k·s_x]` buffer and `scat_recv_slot` their agent slots.
    """

    part: "DevicePartition"          # masters, agents, edges of held shards
    scat_send: torch.Tensor          # [k_local, k, s_x] master slots
    scat_recv_pos: torch.Tensor      # [n_s] int64
    scat_recv_slot: torch.Tensor     # [n_s] int64 agent slots
    comb_send: torch.Tensor          # [k_local, k, c_x] combiner slots
    comb_recv: Optional[CombineRoute] = None     # into [k_local·num_slots]
    dense_route: Optional[CombineRoute] = None   # DenseExchange's vectors
    tiles: Optional[PipelineTiles] = None


def _gather(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """`x[index]` for a multi-dimensional index over x's rows."""
    return x.index_select(0, index.reshape(-1)).reshape(
        tuple(index.shape) + tuple(x.shape[1:]))


def _flat(x: torch.Tensor, payload) -> torch.Tensor:
    return x.reshape((-1,) + tuple(payload))


def refresh_scatter_agents(topo: ShardTopology, comm,
                           scatter_data: torch.Tensor, active: torch.Tensor,
                           dense: bool = False):
    """Exchange 1 (master → scatter agent): ONE message per (master, peer).

    Returns the refreshed `(scatter_data, active)`, new tensors.  With
    `dense=True` (iterative programs: every vertex active) the activity
    payload is skipped.
    """
    payload = scatter_data.shape[1:]
    rec = _flat(comm.all_to_all(_gather(scatter_data, topo.scat_send)),
                payload)
    sd = scatter_data.index_copy(0, topo.scat_recv_slot,
                                 rec.index_select(0, topo.scat_recv_pos))
    if dense:
        return sd, active
    rec_a = comm.all_to_all(_gather(active, topo.scat_send)).reshape(-1)
    act = active.index_copy(0, topo.scat_recv_slot,
                            rec_a.index_select(0, topo.scat_recv_pos))
    return sd, act


def flush_combiners(comm, combined: torch.Tensor, send: torch.Tensor,
                    recv: CombineRoute, monoid: Monoid,
                    routes=None) -> torch.Tensor:
    """Exchange 2 (combiner → master): ONE ⊕-reduced value per agent.

    `send` gathers the combiners' partials out of `combined`, the
    communicator delivers them, and `recv` ⊕-folds them into their
    masters: `[recv.num_segments, *payload]`, identity elsewhere.

    `routes`, the `GatherRoute`s of the flat `send` (over `combined`'s
    rows) and of `recv.order` (over the received buffer), makes the flush
    differentiable through the combine kernel (`kernels.ops.gather_rows`):
    no gradient then takes an `index_add_`.
    """
    payload = tuple(combined.shape[1:])
    if routes is None:
        rec = comm.all_to_all(_gather(combined, send))
        return recv.combine(_flat(rec, payload), monoid)
    send_route, recv_route = routes
    sent = kernel_ops.gather_rows(combined, send.reshape(-1), send_route)
    rec = comm.all_to_all(sent.reshape(tuple(send.shape) + payload))
    landed = kernel_ops.gather_rows(_flat(rec, payload), recv.order,
                                    recv_route)
    return kernel_ops.segment_combine(landed, recv.dst, recv.num_segments,
                                      monoid.name, seg_ptr=recv.seg_ptr)


def flush_routes(topo: ShardTopology):
    """`flush_combiners`' `routes` over a sync topology: the
    `GatherRoute`s of its flat `comb_send` (over the stacked slots) and of
    its `comb_recv.order` (over the received buffer), built once."""
    return (kernel_ops.GatherRoute.build(topo.comb_send.reshape(-1),
                                         topo.part.num_slots),
            kernel_ops.GatherRoute.build(topo.comb_recv.order,
                                         topo.comb_send.numel()))


class _SyncPhase:
    """Sync phase shape: the whole ⊕-reduce is the local phase and the merge
    is the identity, so the BSP loop is refresh → reduce → apply."""

    def local_phase(self, engine, part, state, carry=None):
        return self.reduce(engine, part, state)

    def merge(self, carry):
        return carry

    def carry_init(self, engine, part):
        p = engine.program
        return torch.full((part.num_slots,) + tuple(p.payload_shape),
                          p.monoid.identity, dtype=p.msg_dtype,
                          device=part.device)

    def carry_pending(self, carry):
        return False  # a sync carry is consumed by the very next merge


class NullExchange(_SyncPhase):
    """Single shard: all destinations are local; refresh is the identity."""

    def refresh(self, state):
        return state

    def reduce(self, engine, part, state):
        return engine.scatter_combine(part, state)


NULL_EXCHANGE = NullExchange()


def _master_mask(part: "DevicePartition") -> torch.Tensor:
    """`[num_slots]` bool: the master slots of every shard."""
    per = part.num_slots // part.shards
    slot = torch.arange(part.num_slots, device=part.device)
    return slot % per < part.num_masters


def _identity(shape, monoid: Monoid, like: torch.Tensor) -> torch.Tensor:
    return torch.full(shape, monoid.identity, dtype=like.dtype,
                      device=like.device)


class _RefreshingExchange(_SyncPhase):
    """Shared base of the backends that refresh scatter agents before the
    local phase (the first half of the Agent-Graph protocol)."""

    def __init__(self, topo: ShardTopology, comm, monoid: Monoid,
                 dense_frontier: bool = False):
        self.topo = topo
        self.comm = comm
        self.monoid = monoid
        self.dense_frontier = dense_frontier

    def refresh(self, state):
        sd, act = refresh_scatter_agents(self.topo, self.comm,
                                         state.scatter_data,
                                         state.active_scatter,
                                         dense=self.dense_frontier)
        return dataclasses.replace(state, scatter_data=sd,
                                   active_scatter=act)


class AgentExchange(_RefreshingExchange):
    """Agent-Graph exchange (paper §5): scatter refresh + combiner flush.

    `overlap=True` is not this class: its remote-first order runs on the
    static edge split of ingress, `PipelinedAgentExchange`.
    """

    def __init__(self, topo: ShardTopology, comm, monoid: Monoid,
                 dense_frontier: bool = False):
        super().__init__(topo, comm, monoid, dense_frontier)
        self.masters = _master_mask(topo.part)

    def reduce(self, engine, part, state):
        t, monoid = self.topo, self.monoid
        combined = engine.scatter_combine(part, state)
        flushed = flush_combiners(self.comm, combined, t.comb_send,
                                  t.comb_recv, monoid)
        # master slots take direct local + flushed remote contributions
        mask = self.masters.reshape((-1,) + (1,) * (combined.dim() - 1))
        local = torch.where(mask, combined, monoid.identity)
        return monoid.op(local, flushed)


class DenseExchange(_RefreshingExchange):
    """Pregel-style baseline: collective ⊕ over the full relabeled vector.

    Each shard builds its `[k·cap]` vector of contributions (its own
    masters' combines at their global ids, its combiners' partials at
    their masters' global ids) and the shards reduce the vectors with
    `psum`/`pmin`/`pmax`, each keeping its own masters' block:
    strictly more traffic than AgentExchange, kept as the communication
    baseline.
    """

    def reduce(self, engine, part, state):
        t, monoid, comm = self.topo, self.monoid, self.comm
        # the held shards (part.shards of them) each build a vector over
        # all comm.k shards' masters and keep their own block of the total
        k, kl, cap = comm.k, part.shards, part.num_masters
        combined = engine.scatter_combine(part, state)
        payload = tuple(combined.shape[1:])
        buf = torch.cat([part.master_rows(combined),
                         _flat(_gather(combined, t.comb_send), payload)])
        vecs = t.dense_route.combine(buf, monoid).reshape(
            (kl, k * cap) + payload)
        reduce = {"sum": comm.psum, "min": comm.pmin,
                  "max": comm.pmax}[monoid.name]
        total = reduce(vecs).reshape((kl, k, cap) + payload)
        held = torch.arange(kl, device=combined.device)
        mine = total[held, held + comm.shards[0]]     # [kl, cap, *payload]
        out = _identity((kl, part.num_slots // kl) + payload, monoid,
                        combined)
        out[:, :cap] = mine
        return _flat(out, payload)


class PipelinedAgentExchange(_RefreshingExchange):
    """Double-buffered Agent-Graph exchange (paper §6.2 overlap).

    Per superstep, over the static edge split (`ShardTopology.tiles`):
    `local_phase` ⊕-combines the remote tile into the compact combiner
    space, issues the flush, then ⊕-combines the local tile; `merge`, at
    the top of the next superstep, folds `local ⊕ flushed` into the compact
    master space `[k·(cap + 1)]`.  Each edge is scanned once.  Min/max
    results are bitwise those of the synchronous AgentExchange.
    """

    def __init__(self, topo: ShardTopology, comm, monoid: Monoid,
                 dense_frontier: bool = False):
        super().__init__(topo, comm, monoid, dense_frontier)
        if topo.tiles is None:
            raise ValueError(f"{type(self).__name__} needs "
                             "ShardTopology.tiles (split_edge_tiles)")
        self.tiles = topo.tiles

    def _remote(self, engine, state):
        t = self.tiles
        return engine.scatter_combine(
            t.part_remote, state,
            num_segments=t.part_remote.shards * (t.num_combiners + 1))

    def _flush(self, remote):
        t = self.tiles
        return flush_combiners(self.comm, remote, t.comb_send, t.comb_recv,
                               self.monoid)

    def _local(self, engine, state):
        t = self.tiles
        return engine.scatter_combine(t.part_local, state,
                                      num_segments=t.comb_recv.num_segments)

    def local_phase(self, engine, part, state, carry=None) -> Mailbox:
        """Remote-tile combine + flush, then the local-tile combine; `part`
        (the canonical partition, which carries no edge columns under this
        backend) is unused."""
        flushed = self._flush(self._remote(engine, state))
        return Mailbox(local=self._local(engine, state), flushed=flushed)

    def merge(self, mailbox: Mailbox) -> torch.Tensor:
        return self.monoid.op(mailbox.local, mailbox.flushed)

    def carry_init(self, engine, part):
        p = engine.program
        idm = torch.full((self.tiles.comb_recv.num_segments,)
                         + tuple(p.payload_shape), p.monoid.identity,
                         dtype=p.msg_dtype, device=part.device)
        return Mailbox(local=idm, flushed=idm)

    def reduce(self, engine, part, state):
        return self.merge(self.local_phase(engine, part, state))


class AsyncAgentExchange(PipelinedAgentExchange):
    """Bounded-staleness Agent-Graph exchange: collectives once per k steps.

    Valid only for monotone programs (halting, ⊕ = min/max): a delayed
    min/max bound re-tightens later, so the fixed point is that of the
    synchronous schedule.  Per superstep, with `k = staleness`:

      refresh      — the scatter refresh runs only at `step % k == 0`;
                     agent activity is then re-derived from value change
                     (received copy != held copy), so a master that
                     improved anywhere inside the window scatters once
                     after landing;
      local_phase  — the remote-tile partial goes into ring slot
                     `step % k`; at `step % k == k - 1` the k entries
                     ⊕-fold and flush at once and land for the next merge;
                     the local tile is combined every superstep;
      merge        — `local ⊕ landed` every superstep.

    The halt test counts the ring and `dirty` (`carry_pending`): without
    `dirty`, an improvement whose only readers are agents on other shards
    would be stranded between refreshes.
    """

    def __init__(self, topo: ShardTopology, comm, monoid: Monoid,
                 dense_frontier: bool = False, staleness: int = 2):
        super().__init__(topo, comm, monoid, dense_frontier)
        if staleness < 1:
            raise ValueError(f"staleness must be >= 1, got {staleness}")
        self.staleness = staleness
        self.masters = _master_mask(topo.part)

    def refresh(self, state):
        if state.step % self.staleness:
            return state
        sd, act = refresh_scatter_agents(self.topo, self.comm,
                                         state.scatter_data,
                                         state.active_scatter,
                                         dense=self.dense_frontier)
        if not self.dense_frontier:
            changed = sd != state.scatter_data
            if changed.dim() > 1:
                changed = changed.any(dim=tuple(range(1, changed.dim())))
            act = act | changed
        return dataclasses.replace(state, scatter_data=sd,
                                   active_scatter=act)

    def local_phase(self, engine, part, state, carry=None) -> AsyncRing:
        if carry is None:
            raise ValueError("async local_phase needs the prior AsyncRing "
                             "carry (driven by plan.execute_plan)")
        k = self.staleness
        slot = state.step % k
        ring = list(carry.ring)
        ring[slot] = self._remote(engine, state)
        if slot == k - 1:
            folded = ring[0]
            for r in ring[1:]:
                folded = self.monoid.op(folded, r)
            landed = self._flush(folded)
            ring = [_identity(r.shape, self.monoid, r) for r in ring[:1]] * k
        else:
            landed = _identity(carry.landed.shape, self.monoid, carry.landed)
        local = self._local(engine, state)
        # improvements land on masters as activity the superstep after they
        # happen; at a refresh step everything so far was just pushed
        if state.step % k == 0:
            dirty = torch.zeros((), dtype=torch.bool, device=local.device)
        else:
            dirty = carry.dirty | (state.active_scatter & self.masters).any()
        return AsyncRing(local=local, landed=landed, ring=tuple(ring),
                         dirty=dirty)

    def merge(self, carry: AsyncRing) -> torch.Tensor:
        return self.monoid.op(carry.local, carry.landed)

    def carry_init(self, engine, part):
        p = engine.program
        t = self.tiles
        payload = tuple(p.payload_shape)
        idm = torch.full((t.comb_recv.num_segments,) + payload,
                         p.monoid.identity, dtype=p.msg_dtype,
                         device=part.device)
        ring = torch.full((t.part_remote.shards * (t.num_combiners + 1),)
                          + payload, p.monoid.identity, dtype=p.msg_dtype,
                          device=part.device)
        return AsyncRing(local=idm, landed=idm, ring=(ring,) * self.staleness,
                         dirty=torch.zeros((), dtype=torch.bool,
                                           device=part.device))

    def carry_pending(self, carry: AsyncRing) -> torch.Tensor:
        held = torch.stack([(r != self.monoid.identity).any()
                            for r in carry.ring])
        return held.any() | carry.dirty

    def reduce(self, engine, part, state):
        raise NotImplementedError(
            "AsyncAgentExchange has no single-superstep reduce: partials "
            "live in the k-deep ring across supersteps.  Use the plan "
            "executor (DistGREEngine.make_run).")
