"""GRE BSP engine on PyTorch: executes VertexPrograms in supersteps (paper
Alg. 2).

There is ONE canonical superstep, parameterized by an exchange backend
(`repro_torch.core.exchange`; the single-shard `NullExchange` here):

  refresh          — push master scatter state to remote readers (identity
      on a single shard);
  scatter-combine  — every scatter-active vertex emits active messages along
      its out-edges and the messages are ⊕-combined at their destinations
      (one gather → message → segment-reduce, no edge-state storage);
  apply            — every vertex whose combine_data changed recomputes
      vertex_data and decides whether to stay scatter-active.

HOW a run executes (which frontier strategy scans the edges) is a
`SuperstepPlan` (`repro_torch.core.plan`), driven by ONE loop,
`plan.execute_plan`.  The ⊕ runs the hand-written CUDA kernel when the
partition lies on the card and the plain PyTorch version when it lies on
the CPU (`repro_torch.kernels.ops`).

Entry points run on CUDA unless the caller passes `device="cpu"`; asked for
CUDA with no card present they raise.  The engine takes its device from the
partition's tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.exchange import NULL_EXCHANGE
from repro_torch.core.plan import (XLA_KERNEL, SuperstepPlan, execute_plan,
                                   execute_superstep)
from repro_torch.core.vertex_program import VertexProgram, segment_combine
from repro_torch.graph.structures import (DEFAULT_BUCKET_BOUNDS,
                                          DeltaReport, csr_layout,
                                          degree_buckets, merge_order,
                                          stable_argsort,
                                          validate_edge_delta)
from repro_torch.kernels.segment_combine import segment_row_pointer


def resolve_device(device="cuda") -> torch.device:
    """`torch.device(device)`, refusing CUDA when no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available()"
                           " is False; pass device='cpu' to run on the CPU")
    return dev


def _to(arr, device: torch.device) -> torch.Tensor:
    # copies only arrays torch cannot wrap (read-only or strided)
    return torch.from_numpy(np.require(arr, requirements=["C", "W"])).to(device)


@dataclasses.dataclass
class DevicePartition:
    """Static per-shard topology (column storage, local 32-bit ids).

    `num_slots` = masters + 1 padding sink; padded edges point at the sink
    so combines on padding never touch real state.  `seg_ptr` is the row
    pointer of the dst-sorted columns (`segment_row_pointer`), built once
    at ingress for the combine kernel's dense route; None when the edges
    are not sorted by dst.

    `shards` > 1 lays that many shards end to end in one slot space (the
    distributed engine's stacked layout, `repro_torch.core.dist_engine`):
    `num_slots` is then the total, each shard owning `num_slots // shards`
    slots whose first `num_masters` are its masters.  Edge columns are
    optional: a partition that only anchors slot statics and `aux` for
    apply carries none.  `device` is always set.
    """

    src: Optional[torch.Tensor]        # [E_pad] int32 src slot
    dst: Optional[torch.Tensor]        # [E_pad] int32 dst slot
    edge_mask: Optional[torch.Tensor]  # [E_pad] bool, False on padding
    num_masters: int
    num_slots: int
    edges_sorted_by_dst: bool
    edge_props: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    aux: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    # Src-sorted CSR secondary index (graph.structures.csr_layout), the
    # substrate of frontier compaction.  None disables compaction.
    csr_indptr: Optional[torch.Tensor] = None   # [num_slots + 1] int32
    csr_eidx: Optional[torch.Tensor] = None     # [E_pad] pos in dst-sorted cols
    csr_max_deg: int = 0
    # Degree-bucket binning (graph.structures.degree_buckets).
    bucket_id: Optional[torch.Tensor] = None    # [num_slots] int32, -1 = deg 0
    bucket_sizes: tuple = ()
    bucket_max_deg: tuple = ()
    seg_ptr: Optional[torch.Tensor] = None      # [num_slots + 1] int32
    shards: int = 1
    device: Optional[torch.device] = None

    def __post_init__(self):
        if self.device is None:
            raise ValueError("DevicePartition needs its `device`")

    def master_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The master rows of `x`, whose rows are `shards` equal blocks
        each led by its shard's masters (the slot space, or a compact
        master space of `num_masters + 1` rows a shard):
        `[shards * num_masters, *payload]`."""
        if self.shards == 1:
            return x[:self.num_masters]
        blocks = x.reshape((self.shards, -1) + tuple(x.shape[1:]))
        return blocks[:, :self.num_masters].reshape(
            (-1,) + tuple(x.shape[1:]))

    @staticmethod
    def from_graph(graph, pad_to: Optional[int] = None,
                   sort_by_dst: bool = True, transpose: bool = False,
                   bucket_bounds: Optional[tuple] = None,
                   edge_slack: int = 0, chunk_size: Optional[int] = None,
                   device="cuda") -> "DevicePartition":
        """Whole graph on one shard (slots = V + sink), built on the host
        and moved to `device`.

        `transpose=True` builds the partition of the reversed graph;
        `bucket_bounds` overrides the default degree-bucket ladder.
        `edge_slack` pads the edge columns with that many extra masked
        slots, so later `apply_edge_delta` batches append in place.

        `graph` may also be an `EdgeChunkSource`; a `Graph` streams as
        chunks of `chunk_size` rows (default: one chunk of the whole list).
        The padded columns fill from the chunk stream at a cursor and the
        dst sort runs over the filled prefix, so every `chunk_size` gives
        bitwise the same columns with no second copy of the edge list.
        The host build's two stable sorts (by dst, by src) run on `device`.
        """
        dev = resolve_device(device)
        source = graph if hasattr(graph, "chunks") else graph.chunk_source(
            chunk_size or max(graph.num_edges, 1))
        v, e = source.num_vertices, source.num_edges
        e_pad = pad_to or (e + edge_slack)
        assert e_pad >= e, (e_pad, e)
        psrc = np.full(e_pad, v, dtype=np.int32)
        pdst = np.full(e_pad, v, dtype=np.int32)
        mask = np.zeros(e_pad, dtype=bool)
        mask[:e] = True
        props = {k: np.zeros(e_pad, dtype=dt)
                 for k, dt in source.prop_dtypes.items()}
        out_deg = np.zeros(v, dtype=np.int64)
        cur = 0
        for chunk in source.chunks():
            s, d = ((chunk.dst, chunk.src) if transpose
                    else (chunk.src, chunk.dst))
            hi = cur + chunk.num_edges
            psrc[cur:hi] = s
            pdst[cur:hi] = d
            for k in props:
                props[k][cur:hi] = chunk.props[k]
            out_deg += np.bincount(s, minlength=v)
            cur = hi
        if sort_by_dst:
            order = stable_argsort(pdst[:e], dev)
            psrc[:e] = psrc[:e][order]
            pdst[:e] = pdst[:e][order]
            for k in props:
                props[k][:e] = props[k][:e][order]
        out_deg = out_deg.astype(np.float32)
        indptr, eidx, max_deg = csr_layout(psrc, mask, v + 1, dev)
        bucket_id, sizes, max_degs = degree_buckets(
            indptr, v + 1, bounds=tuple(bucket_bounds or
                                        DEFAULT_BUCKET_BOUNDS))
        arrays = {"src": psrc, "dst": pdst, "edge_mask": mask,
                  "edge_props": props,
                  "aux": {"out_degree": out_deg,
                          "global_id": np.arange(v, dtype=np.float32)},
                  "csr_indptr": indptr, "csr_eidx": eidx,
                  "bucket_id": bucket_id}
        statics = {"num_masters": v, "num_slots": v + 1,
                   "edges_sorted_by_dst": sort_by_dst,
                   "csr_max_deg": max_deg, "bucket_sizes": sizes,
                   "bucket_max_deg": max_degs}
        return DevicePartition.from_arrays(arrays, statics, device=dev)

    def apply_edge_delta(self, delta, bucket_bounds: Optional[tuple] = None,
                         pad_multiple: int = 8):
        """Delta ingress: retire and append edges in the padded columns
        without rebuilding the partition from a `Graph`.

        Removed edges become TOMBSTONES: `edge_mask` False and both ends
        repointed at the sink slot, so even the unmasked dense scan never
        re-delivers them (the sink's segment of the row pointer counts
        them).  Added edges take masked slack slots at the tail.  Live
        edges are then re-sorted by destination on the host, and the CSR,
        the degree buckets and the row pointer rebuilt over the same
        padded length.

        The static facets (`csr_max_deg`, `bucket_sizes`,
        `bucket_max_deg`) merge monotonically (elementwise max with this
        partition's), as in the JAX package, where that keeps one jitted
        trace across deltas; here it keeps the frontier plan after a
        delta equal to the JAX package's.  When the live edges outgrow the
        padded columns the partition COMPACTS: the edge length regrows
        with x1.25 head-room, rounded up to `pad_multiple`, and the report
        says so.

        Returns ``(new_partition, DeltaReport)``; `self` is not changed.
        The host work matches the JAX package's field by field; its
        removal matching and sorts take the faster formulations of
        `graph.structures` (`validate_edge_delta`'s hashed match,
        `merge_order`, and `stable_argsort` on the partition's device).
        """
        assert self.src is not None, \
            "tile-only partition carries no edge columns to mutate"
        n, slots = self.num_masters, self.num_slots
        sink = n  # single-shard layout: masters [0, n), sink at n
        src = self.src.cpu().numpy()
        dst = self.dst.cpu().numpy()
        mask = self.edge_mask.cpu().numpy()
        props = {k: v.cpu().numpy() for k, v in self.edge_props.items()}
        # ---- validate up front (single-shard layout: master slot == the
        # original vertex id, so slot-space keys are original-id keys) and
        # retire every live instance of each removed (src, dst) pair
        live = np.flatnonzero(mask)
        sel = validate_edge_delta(
            delta, n, src[live].astype(np.int64) * np.int64(n) + dst[live])
        rem = np.zeros(mask.shape[0], dtype=bool)
        rem[live[sel]] = True
        removed_src = src[rem].astype(np.int64)
        removed_dst = dst[rem].astype(np.int64)
        keep = mask & ~rem
        # ---- stage adds
        if delta.num_adds:
            for k in props:
                if k not in delta.add_props:
                    raise KeyError(f"delta adds missing edge prop {k!r}")
        live_src = np.concatenate([src[keep],
                                   delta.add_src.astype(np.int32)])
        live_dst = np.concatenate([dst[keep],
                                   delta.add_dst.astype(np.int32)])
        live_props = {
            k: np.concatenate([v[keep],
                               np.asarray(delta.add_props[k], v.dtype)
                               if delta.num_adds else v[:0]])
            for k, v in props.items()}
        e_live = int(live_src.shape[0])
        e_pad = int(src.shape[0])
        compacted = False
        if e_live > e_pad:  # slack exhausted: the partition regrows
            e_pad = max(e_live, int(e_pad * 1.25))
            e_pad = -(-e_pad // pad_multiple) * pad_multiple
            compacted = True
        if self.edges_sorted_by_dst:
            # the kept edges are still dst-sorted: merge the adds in (the
            # permutation of a stable sort by dst)
            order = merge_order(live_dst[:e_live - delta.num_adds],
                                live_dst[e_live - delta.num_adds:])
            live_src, live_dst = live_src[order], live_dst[order]
            live_props = {k: v[order] for k, v in live_props.items()}
        psrc = np.full(e_pad, sink, np.int32)
        pdst = np.full(e_pad, sink, np.int32)
        pmask = np.zeros(e_pad, dtype=bool)
        psrc[:e_live] = live_src
        pdst[:e_live] = live_dst
        pmask[:e_live] = True
        pprops = {}
        for k, v in live_props.items():
            col = np.zeros((e_pad,) + v.shape[1:], dtype=v.dtype)
            col[:e_live] = v
            pprops[k] = col
        indptr, eidx, max_deg = csr_layout(psrc, pmask, slots, self.device)
        bucket_id, sizes, max_degs = degree_buckets(
            indptr, slots,
            bounds=tuple(bucket_bounds or DEFAULT_BUCKET_BOUNDS))
        # monotone static merge (see docstring)
        max_deg = max(max_deg, self.csr_max_deg)
        if len(sizes) == len(self.bucket_sizes):
            sizes = tuple(max(a, b)
                          for a, b in zip(sizes, self.bucket_sizes))
            max_degs = tuple(max(a, b)
                             for a, b in zip(max_degs, self.bucket_max_deg))
        aux = {k: v.cpu().numpy() for k, v in self.aux.items()}
        aux["out_degree"] = np.bincount(
            live_src, minlength=slots)[:n].astype(np.float32)
        new = DevicePartition.from_arrays(
            {"src": psrc, "dst": pdst, "edge_mask": pmask,
             "edge_props": pprops, "aux": aux, "csr_indptr": indptr,
             "csr_eidx": eidx, "bucket_id": bucket_id},
            {"num_masters": n, "num_slots": slots,
             "edges_sorted_by_dst": self.edges_sorted_by_dst,
             "csr_max_deg": max_deg, "bucket_sizes": sizes,
             "bucket_max_deg": max_degs, "shards": self.shards},
            device=self.device)
        report = DeltaReport(added_src=delta.add_src.copy(),
                             added_dst=delta.add_dst.copy(),
                             removed_src=removed_src,
                             removed_dst=removed_dst,
                             compacted=compacted)
        return new, report

    @staticmethod
    def from_arrays(arrays: Dict[str, object], statics: Dict[str, object],
                    device="cuda") -> "DevicePartition":
        """Build a partition from host arrays: `arrays` holds `src`, `dst`,
        `edge_mask`, `csr_indptr`, `csr_eidx`, `bucket_id` (each may be
        None) and the dicts `edge_props` and `aux`, e.g. `np.asarray` of
        every field of a JAX-package `DevicePartition`; `statics` holds
        `num_masters`, `num_slots`, `edges_sorted_by_dst`, `csr_max_deg`,
        `bucket_sizes` and `bucket_max_deg`, and optionally `shards`.  Adds
        the row pointer."""
        dev = resolve_device(device)

        def opt(key):
            a = arrays.get(key)
            return None if a is None else _to(a, dev)

        part = DevicePartition(
            src=opt("src"), dst=opt("dst"), edge_mask=opt("edge_mask"),
            num_masters=int(statics["num_masters"]),
            num_slots=int(statics["num_slots"]),
            edges_sorted_by_dst=bool(statics["edges_sorted_by_dst"]),
            shards=int(statics.get("shards", 1)), device=dev,
            edge_props={k: _to(a, dev)
                        for k, a in (arrays.get("edge_props") or {}).items()},
            aux={k: _to(a, dev) for k, a in (arrays.get("aux") or {}).items()},
            csr_indptr=opt("csr_indptr"), csr_eidx=opt("csr_eidx"),
            csr_max_deg=int(statics.get("csr_max_deg", 0)),
            bucket_id=opt("bucket_id"),
            bucket_sizes=tuple(int(s) for s in statics.get("bucket_sizes", ())),
            bucket_max_deg=tuple(int(d) for d in
                                 statics.get("bucket_max_deg", ())))
        if part.edges_sorted_by_dst and part.dst is not None:
            part.seg_ptr = segment_row_pointer(part.dst, part.num_slots)
        return part


@dataclasses.dataclass
class EngineState:
    """Runtime vertex states (paper §6.1.3), flat columns per slot.

    `step` is the superstep counter, kept on the host (the loop's halt test
    reads it every superstep).  `lane_active` is the optional per-lane halt
    tracker (`[D]` bool) of multi-source programs.  On a partition of k
    stacked shards the columns run over all shards' masters and slots in
    shard order, and `lane_active` is `[k, D]`, one row a shard.
    """

    vertex_data: torch.Tensor     # [shards * num_masters, *V]
    scatter_data: torch.Tensor    # [num_slots, *S]
    active_scatter: torch.Tensor  # [num_slots] bool
    step: int = 0
    lane_active: Optional[torch.Tensor] = None  # [D] bool, [k, D] stacked

    @staticmethod
    def from_arrays(arrays: Dict[str, object], device="cuda") -> "EngineState":
        """Build a state from host arrays (`vertex_data`, `scatter_data`,
        `active_scatter`, `step`, optional `lane_active`), e.g. `np.asarray`
        of every field of a JAX-package `EngineState`."""
        dev = resolve_device(device)
        lane = arrays.get("lane_active")
        return EngineState(
            vertex_data=_to(arrays["vertex_data"], dev),
            scatter_data=_to(arrays["scatter_data"], dev),
            active_scatter=_to(arrays["active_scatter"], dev),
            step=int(np.asarray(arrays.get("step", 0))),
            lane_active=None if lane is None else _to(lane, dev))


def _bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Reshape a `[n]` mask to broadcast against `[n, *payload]`."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


class GREEngine:
    """Drives a VertexProgram over one DevicePartition.

    `frontier` selects the scatter strategy (core/frontier.py):

      "auto"    — per superstep: dense scan when the frontier is large,
                  degree-bucketed compacted gather when it fits; statically
                  dense where even the worst-case bucket tiles would
                  out-scan the dense path;
      "compact" — always attempt bucketed compaction (per-bucket overflow
                  still degrades an overflowing bucket to a restricted
                  dense scan);
      "flat"    — one padded `[cap, max_deg]` tile over the whole frontier;
      "dense"   — the every-edge masked scan.

    Engines in `dense_frontier` mode (iterative programs like PageRank,
    where every vertex stays active) always take the dense path, unmasked.

    `plan` replaces the knob-by-knob arguments with one `SuperstepPlan`
    (`adopt_plan`), or, as `plan="auto-tuned"`, asks the tuned-plan cache
    (`repro_torch.tuning.PlanCache` at `plan_cache`, else its default
    location) the first time a partition is in hand (`init_state`): a hit
    adopts the stored plan without running a probe, a miss keeps the
    defaults.  `bucket_bounds` records the degree-bucket ladder an adopted
    plan was tuned against (None: the default); callers rebuild a matching
    partition with `DevicePartition.from_graph(bucket_bounds=...)`.
    """

    FRONTIERS = ("auto", "dense", "compact", "flat")

    def __init__(self, program: VertexProgram,
                 dense_frontier: Optional[bool] = None,
                 frontier: str = "auto", frontier_cap: Optional[int] = None,
                 plan=None, plan_cache=None):
        if frontier not in self.FRONTIERS:
            raise ValueError(f"frontier must be one of {self.FRONTIERS}, "
                             f"got {frontier!r}")
        self.program = program
        self.frontier = frontier
        self.frontier_cap = frontier_cap
        # Iterative programs (halts=False) keep every vertex active, so
        # per-edge activity masks are pure overhead; the sink slot's
        # scatter_data is pinned to the identity so padded edges still
        # contribute nothing.
        self.dense_frontier = (dense_frontier if dense_frontier is not None
                               else not program.halts)
        self.kernel = XLA_KERNEL    # carried for plan JSON, selects nothing
        self.bucket_bounds = None
        self.frontier_hist = None   # set by calibrate_frontier_cap
        self._plan_cache = plan_cache
        self._auto_plan_pending = False
        # the last consulted cache key and its frontier-histogram facet:
        # `refresh_plan` re-keys against these after a graph mutation
        self._plan_key = None
        self._plan_hist = None
        if plan is None:
            pass
        elif plan == "auto-tuned":
            self._auto_plan_pending = True
        else:
            self.adopt_plan(plan)

    def adopt_plan(self, plan: SuperstepPlan) -> None:
        """Take a composed plan's stages as this engine's knobs (the
        inverse of `make_plan`)."""
        if plan.strategy not in self.FRONTIERS:
            raise ValueError(f"plan strategy must be one of "
                             f"{self.FRONTIERS}, got {plan.strategy!r}")
        self.frontier = plan.strategy
        self.frontier_cap = plan.frontier_cap
        self.dense_frontier = plan.dense_frontier
        self.kernel = plan.kernel
        self.bucket_bounds = plan.bucket_bounds

    def _plan_cache_lookup(self, key: str) -> Optional[SuperstepPlan]:
        from repro_torch.tuning import PlanCache
        cache = self._plan_cache
        if not isinstance(cache, PlanCache):
            cache = PlanCache(cache)
        return cache.lookup(key)

    def _consult_plan_cache(self, part: DevicePartition,
                            state: EngineState) -> None:
        """`plan="auto-tuned"`: probe the live frontier histogram (the
        fingerprint's density facet, as `tune()` keys its plans), look the
        partition's key up in the plan cache, adopt a hit; a miss keeps
        the engine's defaults."""
        self._auto_plan_pending = False
        from repro_torch.tuning import plan_cache_key
        hist = self.probe_frontier_hist(part, state)
        key = plan_cache_key(part=part, program=self.program, mesh_size=1,
                             frontier_hist=hist)
        self._plan_key, self._plan_hist = key, hist
        plan = self._plan_cache_lookup(key)
        if plan is not None:
            self.adopt_plan(plan)

    def refresh_plan(self, part: DevicePartition) -> bool:
        """Re-key a consulted tuned plan after a graph mutation.

        The fingerprint quantizes its facets (log2 edge counts, skew
        bins), so a small `apply_edge_delta` is absorbed: same key, the
        adopted plan stands.  A large delta shifts a bin: the cache is
        consulted under the new key (hit = adopt, miss = keep the current
        knobs) and the new key becomes current.  Returns True when the key
        changed.  A no-op unless this engine consulted the cache
        (`plan="auto-tuned"`).
        """
        if self._plan_key is None:
            return False
        from repro_torch.tuning import plan_cache_key
        key = plan_cache_key(part=part, program=self.program, mesh_size=1,
                             frontier_hist=self._plan_hist)
        if key == self._plan_key:
            return False
        self._plan_key = key
        plan = self._plan_cache_lookup(key)
        if plan is not None:
            self.adopt_plan(plan)
        return True

    def make_plan(self, phases: str = "sync",
                  staleness: int = 0) -> SuperstepPlan:
        """The engine's SuperstepPlan, rebuilt on demand so
        `calibrate_frontier_cap`'s capacity update is honored."""
        return SuperstepPlan(strategy=self.frontier,
                             frontier_cap=self.frontier_cap,
                             dense_frontier=self.dense_frontier,
                             phases=phases, staleness=staleness,
                             kernel=self.kernel)

    def calibrate_frontier_cap(self, part: DevicePartition,
                               state: EngineState, probe_steps: int = 2
                               ) -> list:
        """Derive `frontier_cap` from the live frontier sizes of the first
        superstep(s) instead of a fixed fraction of `num_slots`.  `state`
        is not consumed.  Returns the histogram (also `frontier_hist`)."""
        from repro_torch.core.frontier import default_cap
        self.frontier_hist = self.probe_frontier_hist(part, state,
                                                      probe_steps)
        self.frontier_cap = default_cap(part.num_slots,
                                        frontier_hist=self.frontier_hist)
        return self.frontier_hist

    def probe_frontier_hist(self, part: DevicePartition, state: EngineState,
                            probe_steps: int = 2) -> list:
        """Run up to `probe_steps` dense supersteps from `state` and return
        the live frontier sizes `[|F_0|, |F_1|, ...]`."""
        probe = GREEngine(self.program, dense_frontier=self.dense_frontier,
                          frontier="dense")
        hist, s = [], state
        for _ in range(probe_steps):
            n = int(s.active_scatter.sum())
            if n == 0:
                break
            hist.append(n)
            s = probe.superstep(part, s)
        return hist

    # ------------------------------------------------------------------ init
    def init_state(self, part: DevicePartition, source=None,
                   lane_tracking: bool = False) -> EngineState:
        """`source` may be a single vertex id, or, for multi-source programs
        with `payload_shape=(D,)`, a length-D sequence: source d seeds lane
        d.  Entries that are None or negative leave their lane unseeded
        (identity values, inactive).  `lane_tracking=True` attaches the
        per-lane halt tracker (needs a multi-source program with
        `lane_activates`)."""
        p = self.program
        n, s = part.num_masters, part.num_slots
        dev = part.device
        vertex_data = p.init_vertex_data(n, part.aux)
        sd0 = p.init_scatter_data(n, part.aux).to(p.msg_dtype)
        scatter_data = torch.full((s,) + tuple(sd0.shape[1:]),
                                  p.monoid.identity, dtype=p.msg_dtype,
                                  device=dev)
        scatter_data[:n] = sd0
        active = torch.zeros(s, dtype=torch.bool, device=dev)
        active[:n] = p.init_active(n, part.aux)
        lane_active = None
        multi = source is not None and np.ndim(source) > 0
        if source is not None and not multi:
            src_idx = int(source)
            vertex_data[src_idx] = 0.0
            scatter_data[src_idx] = 0.0
            active = torch.zeros(s, dtype=torch.bool, device=dev)
            active[src_idx] = True
        elif multi:  # one source per payload lane, None/-1 = lane unseeded
            seeded = np.array([sv is not None and int(sv) >= 0
                               for sv in source])
            src_np = np.array([int(sv) if ok else s
                               for sv, ok in zip(source, seeded)], np.int64)
            lanes_np = np.arange(src_np.shape[0])
            # drop out-of-range entries explicitly (the unseeded sentinel s)
            in_n, in_s = src_np < n, src_np < s
            src_n = torch.from_numpy(src_np[in_n]).to(dev)
            lanes_n = torch.from_numpy(lanes_np[in_n]).to(dev)
            if p.seed_sources is not None:
                vertex_data, scatter_data = p.seed_sources(
                    vertex_data, scatter_data, src_n, lanes_n, part.aux)
            else:
                vertex_data[src_n, lanes_n] = 0.0
                scatter_data[torch.from_numpy(src_np[in_s]).to(dev),
                             torch.from_numpy(lanes_np[in_s]).to(dev)] = 0.0
            active = torch.zeros(s, dtype=torch.bool, device=dev)
            active[torch.from_numpy(src_np[in_s]).to(dev)] = True
            if lane_tracking:
                lane_active = torch.from_numpy(seeded).to(dev)
        if lane_tracking and (lane_active is None
                              or p.lane_activates is None):
            raise ValueError("lane_tracking needs a multi-source (sequence) "
                             "`source` and a program with `lane_activates` "
                             "(payload_shape=(D,))")
        state = EngineState(vertex_data, scatter_data, active, 0, lane_active)
        if self._auto_plan_pending:
            # plan="auto-tuned": the key's frontier-density facet needs the
            # seeded state
            self._consult_plan_cache(part, state)
        return state

    # ------------------------------------------------------------ incremental
    def warm_start_state(self, part: DevicePartition, prev_state: EngineState,
                         report, source=None, lane_tracking: bool = False
                         ) -> EngineState:
        """Seed a re-convergence run on the MUTATED partition from the
        previous fixed point (`repro_torch.core.incremental`).

        Iterative programs (PageRank) carry the previous values forward
        under fresh init activity: the contraction resumes from a nearby
        point.  Halting min-monoid traversals get the exact treatment:
        entries no longer certified by the surviving edges are reset to
        their initial values (the program's `invalidation` policy), and
        only add-endpoints, in-neighbors of resets and self-seeding resets
        start active.  An empty delta yields an empty frontier: the run
        ends at once at the previous fixed point.  The passes run on the
        host; the state goes back to the partition's device.
        """
        from repro_torch.core import incremental
        p = self.program
        incremental.check_supported(p, report)
        n = part.num_masters
        state0 = self.init_state(part, source=source,
                                 lane_tracking=lane_tracking)
        sd = state0.scatter_data.clone()
        if not p.halts:
            sd[:n] = prev_state.scatter_data[:n]
            return dataclasses.replace(state0,
                                       vertex_data=prev_state.vertex_data,
                                       scatter_data=sd)
        vd_prev = prev_state.vertex_data.cpu().numpy()
        sd_prev = prev_state.scatter_data[:n].cpu().numpy()
        mask = part.edge_mask.cpu().numpy()
        lsrc = part.src.cpu().numpy()[mask].astype(np.int64)
        ldst = part.dst.cpu().numpy()[mask].astype(np.int64)
        eprop = None
        if p.needs_edge_prop:
            eprop = part.edge_props[p.needs_edge_prop].cpu().numpy()[mask]
        protected = incremental.source_mask(vd_prev.shape, source)
        tainted = incremental.compute_taint(p, n, lsrc, ldst, eprop,
                                            vd_prev, report, protected)
        vd = np.where(tainted, state0.vertex_data.cpu().numpy(), vd_prev)
        sd_new = np.where(tainted, state0.scatter_data[:n].cpu().numpy(),
                          sd_prev)
        tany = tainted if tainted.ndim == 1 else tainted.any(axis=-1)
        init_act = p.init_active(n, part.aux).cpu().numpy()
        act = incremental.warm_seed_active(n, lsrc, ldst, tany,
                                           report.added_src, init_act)
        dev = part.device
        sd[:n] = torch.from_numpy(sd_new.astype(np.float32)).to(dev).to(
            p.msg_dtype)
        active = torch.zeros(part.num_slots, dtype=torch.bool, device=dev)
        active[:n] = torch.from_numpy(act).to(dev)
        return dataclasses.replace(
            state0,
            vertex_data=torch.from_numpy(vd.astype(vd_prev.dtype)).to(dev),
            scatter_data=sd, active_scatter=active)

    def rerun_incremental(self, part: DevicePartition, prev_state: EngineState,
                          delta, *, source=None, max_steps: int = 100,
                          lane_tracking: bool = False):
        """Apply an EdgeDelta and re-converge from `prev_state`'s fixed
        point through the unchanged plan executor.

        Returns ``(new_partition, final_state, report)``.  The final state
        is bitwise-equal to a cold `run` on the mutated graph for halting
        min-monoid programs; iterative programs re-converge to the
        tolerance they always carry.  Supersteps and edge scans follow the
        perturbation, not the graph.  A tuned plan is re-keyed against the
        mutated partition (`refresh_plan`) before the run.
        """
        new_part, report = part.apply_edge_delta(
            delta, bucket_bounds=self.bucket_bounds)
        state = self.warm_start_state(new_part, prev_state, report,
                                      source=source,
                                      lane_tracking=lane_tracking)
        self.refresh_plan(new_part)
        out = self.run(new_part, state, max_steps)
        return new_part, out, report

    # ------------------------------------------------------- scatter-combine
    def scatter_combine(self, part: DevicePartition, state: EngineState,
                        num_segments: Optional[int] = None) -> torch.Tensor:
        """Phase 1: active messages on all out-edges of active vertices,
        ⊕-accumulated over `num_segments` slots (default: all).  Dispatches
        dense scan vs compacted gather through the plan."""
        return self.make_plan().scatter_combine(self, part, state,
                                                num_segments)

    def dense_scatter_combine(self, part: DevicePartition, state: EngineState,
                              num_segments: Optional[int] = None
                              ) -> torch.Tensor:
        """The dense strategy: scan every edge, mask inactive sources."""
        p = self.program
        eprop = (part.edge_props[p.needs_edge_prop]
                 if p.needs_edge_prop else None)
        gathered = state.scatter_data.index_select(0, part.src)
        msgs = p.scatter_msg(gathered, eprop)
        if self.dense_frontier:
            msgs = msgs.to(p.msg_dtype)
        else:
            live = state.active_scatter.index_select(0, part.src) \
                & part.edge_mask
            msgs = torch.where(_bcast(live, msgs), msgs.to(p.msg_dtype),
                               p.monoid.identity)
        return segment_combine(
            msgs, part.dst, num_segments or part.num_slots, p.monoid,
            indices_are_sorted=part.edges_sorted_by_dst, seg_ptr=part.seg_ptr)

    # ------------------------------------------------------------------ apply
    def apply(self, part: DevicePartition, state: EngineState,
              combined: torch.Tensor) -> EngineState:
        """Phase 2: fold combine_data into vertex_data; assert_to_halt.
        Returns a new state; `state` is not modified.  `combined` holds
        each shard's masters first (`DevicePartition.master_rows`)."""
        p = self.program
        n, k = part.num_masters, part.shards
        combined_m = part.master_rows(combined)
        aux = dict(part.aux)
        aux["step"] = state.step
        act_apply = p.combine_activates(state.vertex_data, combined_m)
        new_vd, new_sd, act_scatter = p.apply_fn(state.vertex_data,
                                                 combined_m, aux)
        vertex_data = torch.where(_bcast(act_apply, new_vd), new_vd,
                                  state.vertex_data)
        # per shard: masters take the new scatter data, agents keep theirs
        payload = tuple(state.scatter_data.shape[1:])
        sd = state.scatter_data.reshape((k, -1) + payload)
        masters = torch.where(_bcast(act_apply, new_sd),
                              new_sd.to(p.msg_dtype),
                              sd[:, :n].reshape((-1,) + payload))
        scatter_data = torch.cat([masters.reshape((k, n) + payload),
                                  sd[:, n:]], dim=1).reshape(
                                      state.scatter_data.shape)
        if p.halts:  # traversal: only improved vertices scatter next round
            next_active = act_apply & act_scatter
        else:        # iterative: activity is whatever apply asserts
            next_active = act_scatter
        rest = state.active_scatter.reshape(k, -1)[:, n:]
        active = torch.cat([next_active.reshape(k, n),
                            torch.zeros_like(rest)], dim=1).reshape(-1)
        lane_active = state.lane_active
        if lane_active is not None and p.lane_activates is not None:
            lanes = p.lane_activates(state.vertex_data, combined_m)
            lane_active = (lanes.any(dim=0) if k == 1 else
                           lanes.reshape((k, n, -1)).any(dim=1))
        return EngineState(vertex_data, scatter_data, active, state.step + 1,
                           lane_active)

    # ------------------------------------------------------------- superstep
    def superstep(self, part: DevicePartition, state: EngineState,
                  exchange=NULL_EXCHANGE) -> EngineState:
        """THE superstep: refresh → scatter-combine/reduce → apply."""
        return execute_superstep(self, part, state, exchange)

    # -------------------------------------------------------------------- run
    def run(self, part: DevicePartition, state: EngineState,
            max_steps: int = 100) -> EngineState:
        """BSP loop: terminate when no vertex is scatter-active (paper §4.1)
        or after `max_steps` supersteps."""
        return execute_plan(self, part, state, NULL_EXCHANGE,
                            max_steps=max_steps)

    # ------------------------------------------------- GAS baseline (ablation)
    def gas_superstep(self, part: DevicePartition, state: EngineState,
                      edge_state: torch.Tensor) -> tuple:
        """Two-sided GAS emulation (paper §2.2, Fig. 2 left): materialize
        per-edge messages into `edge_state`, then gather and reduce.  Same
        result as the Scatter-Combine superstep, with one extra [E] store
        and load."""
        p = self.program
        eprop = (part.edge_props[p.needs_edge_prop]
                 if p.needs_edge_prop else None)
        gathered = state.scatter_data.index_select(0, part.src)
        msgs = p.scatter_msg(gathered, eprop)
        live = state.active_scatter.index_select(0, part.src) & part.edge_mask
        new_edge_state = torch.where(_bcast(live, msgs),
                                     msgs.to(p.msg_dtype), p.monoid.identity)
        # --- super-step boundary: edge_state persists ---
        combined = segment_combine(
            new_edge_state, part.dst, part.num_slots, p.monoid,
            indices_are_sorted=part.edges_sorted_by_dst, seg_ptr=part.seg_ptr)
        return self.apply(part, state, combined), new_edge_state
