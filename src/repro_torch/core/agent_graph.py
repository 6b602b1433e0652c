"""Agent-Graph construction (paper §5.1).

Given an edge partition P(e) and master placement owner(v), extends the
directed graph with agent vertices:

  combiner  v_c — lives on a partition holding in-edges of a remote master v;
                  local messages ⊕-accumulate on v_c, then ONE message
                  (v_c → v) crosses the network per superstep;
  scatter   v_s — lives on a partition holding out-edges of a remote master;
                  the master sends ONE message (v → v_s) per superstep and
                  v_s fans out locally.

Local slot layout per partition (paper §6.1.1 renumbering, masters first then
agents, plus one padding sink for XLA static shapes):

  [0, cap)                       masters (global ids relabeled contiguous)
  [cap, cap+S_pad)               scatter agents
  [cap+S_pad, cap+S_pad+C_pad)   combiners
  cap+S_pad+C_pad                sink (padding target, never read)

All per-partition arrays are stacked along a leading axis of size k; the
distributed engine (`repro_torch.core.dist_engine`) lays the k shards end
to end in one slot space on the device.

The port's copy of `repro.core.agent_graph`: every field of the host-side
build and of the delta ingress (`apply_edge_delta`) is byte-identical to
the JAX package's for the same inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.core.partition import (accumulate_owner_counts,
                                        owners_from_counts, rebalance_owners)
from repro_torch.graph.structures import (DeltaReport, Graph, csr_layout,
                                          degree_buckets, merge_order,
                                          removal_selector,
                                          validate_edge_delta)


@dataclasses.dataclass
class AgentGraph:
    """Host-side stacked representation of k agent-graph partitions."""

    k: int
    num_vertices: int          # original |V|
    cap: int                   # masters per partition (padded)
    s_pad: int                 # scatter-agent slots per partition
    c_pad: int                 # combiner slots per partition
    e_pad: int                 # edge slots per partition
    s_x_pad: int               # scatter-exchange slots per (i, j) peer pair
    c_x_pad: int               # combine-exchange slots per (i, j) peer pair

    # topology, stacked [k, ...]
    src: np.ndarray            # [k, e_pad] local src slot
    dst: np.ndarray            # [k, e_pad] local dst slot
    edge_mask: np.ndarray      # [k, e_pad]
    edge_props: Dict[str, np.ndarray]
    out_degree: np.ndarray     # [k, cap] GLOBAL out-degree of each master

    # vertex id bookkeeping
    old2new: np.ndarray        # [V] -> global relabeled id (owner-contiguous)
    new2old: np.ndarray        # [k*cap] -> original id or -1 (padding master)

    # exchange metadata
    comb_send_slot: np.ndarray    # [k, k, x_pad] on i: row j = combiner slots -> j
    comb_recv_master: np.ndarray  # [k, k, x_pad] on j: row i = master slot for payload from i
    scat_send_master: np.ndarray  # [k, k, x_pad] on j: row i = master slots to push to i
    scat_recv_slot: np.ndarray    # [k, k, x_pad] on i: row j = scatter-agent slot for payload from j

    num_scatter: np.ndarray    # [k] real scatter-agent counts
    num_combiner: np.ndarray   # [k] real combiner counts
    num_edges: np.ndarray      # [k] real edge counts

    # src-sorted CSR secondary index per partition (frontier compaction);
    # masters AND scatter agents have out-edge ranges.
    csr_indptr: np.ndarray     # [k, num_slots + 1]
    csr_eidx: np.ndarray       # [k, e_pad] positions in the dst-sorted cols
    csr_max_deg: int = 0       # max local out-degree over all partitions

    # Degree-bucket binning per partition (graph.structures.degree_buckets,
    # keyed by LOCAL out-degree).  sizes/max_deg are the per-bucket maxima
    # ACROSS partitions (uniform static tile shapes for every shard).
    bucket_id: np.ndarray = None      # [k, num_slots] int32, -1 = deg 0
    bucket_sizes: tuple = ()
    bucket_max_deg: tuple = ()

    # Name of the partitioner that produced `edge_part` ("" when the
    # caller handed in a raw placement array).
    partitioner: str = ""

    @property
    def num_slots(self) -> int:
        return self.cap + self.s_pad + self.c_pad + 1

    @property
    def sink(self) -> int:
        return self.cap + self.s_pad + self.c_pad


def _pad_to(arr: np.ndarray, n: int, fill) -> np.ndarray:
    out = np.full(n, fill, dtype=arr.dtype if arr.size else np.int64)
    out[:arr.shape[0]] = arr
    return out


def _merge_bucket_stats(acc: tuple, stats: tuple) -> tuple:
    """Elementwise max of per-bucket stats across partitions: the static
    bucket shapes (sizes used for caps, tile max degrees) are uniform
    across shards."""
    if not acc:
        return tuple(stats)
    return tuple(max(a, s) for a, s in zip(acc, stats))


@dataclasses.dataclass
class EdgeTile:
    """One destination-class edge tile, stacked [k, width] (host-side)."""

    src: np.ndarray
    dst: np.ndarray                # compact destination index (see split)
    mask: np.ndarray
    props: Dict[str, np.ndarray]
    csr_indptr: np.ndarray         # [k, num_slots + 1]
    csr_eidx: np.ndarray           # [k, width]
    csr_max_deg: int
    # Per-tile degree buckets: a slot's TILE-LOCAL out-degree (its edges
    # that landed in this destination class) drives the binning, so the
    # bucketed frontier gather stays tight on each tile independently.
    bucket_id: np.ndarray = None   # [k, num_slots] int32
    bucket_sizes: tuple = ()       # per-bucket max across partitions
    bucket_max_deg: tuple = ()


@dataclasses.dataclass
class EdgeTileSplit:
    """Static remote/local edge tiles for the pipelined exchange.

    Each partition's edge shard is split ONCE at ingress by destination
    class: `remote` holds the combiner-destined edges (their ⊕ partials
    are what the flush collective carries), `local` the master-destined
    ones.  The pipelined backend (`exchange.PipelinedAgentExchange`) scans
    the remote tile first and issues the flush while the local tile
    computes — total edge work stays E.  The agent exchange's
    `overlap=True` runs on these tiles too (`DistGREEngine.plan`), where
    the JAX package rewrites dst and scans all E edges twice.

    Destination relabeling compacts the ⊕ segment spaces:

      remote tile  dst ∈ [0, c_pad]   — combiner slot minus `cap + s_pad`;
                                        padding lands on the identity slot
                                        `c_pad`;
      local  tile  dst ∈ [0, cap]     — the master slot unchanged; padding
                                        lands on the identity slot `cap`.

    Combiner indices inherit the owner-contiguous global order of
    `comb_ids`, so each tile's combiner range is CONTIGUOUS PER DESTINATION
    SHARD — the flush can take per-peer slices straight out of the remote
    ⊕ array.  Both tiles keep the canonical dst-sorted edge order (they are
    subsequences of it), preserving per-segment reduction order: min/max
    results are bitwise-identical to the unsplit scan, sums reduce in the
    same order.  Per-tile CSR position indices keep the frontier-compacted
    scatter (`core/frontier.py`) available on both tiles.
    """

    remote: EdgeTile               # [k, er_pad] combiner-destined edges
    local: EdgeTile                # [k, el_pad] master-destined edges
    remote_fraction: float         # real remote edges / real edges


def split_edge_tiles(ag: AgentGraph, pad_multiple: int = 8,
                     shards: Optional[range] = None) -> EdgeTileSplit:
    """Split each partition's edges into remote/local destination tiles.

    Host-side (numpy) ingress pass; see `EdgeTileSplit` for the layout
    contract.  Every real edge lands in exactly one tile: destinations are
    either local masters (< cap) or combiners (>= cap + s_pad) — scatter
    agents never terminate edges.

    `shards` (a range of partitions, default all k) selects the rows the
    tiles hold, `[len(shards), width]`: a process that holds one shard
    builds only that shard's tiles.  The shared statics (`er_pad`,
    `el_pad`, `csr_max_deg`, the bucket maxima, `remote_fraction`) are
    still over every partition, from a count pass (the tile-local
    out-degrees are bincounts, no sort), so each held row is bitwise the
    row of the whole split.
    """
    k, cap, s_pad, c_pad = ag.k, ag.cap, ag.s_pad, ag.c_pad
    shards = range(k) if shards is None else shards
    comb_base = cap + s_pad
    num_slots = ag.num_slots
    real = ag.edge_mask
    is_comb = real & (ag.dst >= comb_base) & (ag.dst < ag.sink)
    is_master = real & (ag.dst < cap)
    assert np.array_equal(is_comb | is_master, real), \
        "edge destinations must be masters or combiners"
    n_rem = is_comb.sum(axis=1)
    n_loc = is_master.sum(axis=1)
    er_pad = max(1, int(n_rem.max()))
    el_pad = max(1, int(n_loc.max()))
    er_pad = -(-er_pad // pad_multiple) * pad_multiple
    el_pad = -(-el_pad // pad_multiple) * pad_multiple

    # count pass: the statics over every partition, from each tile's
    # local out-degrees
    stats = {"remote": [0, (), ()], "local": [0, (), ()]}
    for i in range(k):
        for name, sel in (("remote", is_comb[i]), ("local", is_master[i])):
            deg = np.bincount(ag.src[i][sel], minlength=num_slots)
            indptr = np.zeros(num_slots + 1, dtype=np.int64)
            np.cumsum(deg, out=indptr[1:])
            _, sizes, max_degs = degree_buckets(indptr, num_slots)
            st = stats[name]
            st[0] = max(st[0], int(deg.max()) if deg.size else 0)
            st[1] = _merge_bucket_stats(st[1], sizes)
            st[2] = _merge_bucket_stats(st[2], max_degs)

    kh = len(shards)

    def tile(width: int, junk_dst: int, name: str) -> EdgeTile:
        max_deg, sizes, max_degs = stats[name]
        return EdgeTile(
            src=np.full((kh, width), ag.sink, dtype=np.int32),
            dst=np.full((kh, width), junk_dst, dtype=np.int32),
            mask=np.zeros((kh, width), dtype=bool),
            props={n: np.zeros((kh, width), dtype=v.dtype)
                   for n, v in ag.edge_props.items()},
            csr_indptr=np.zeros((kh, num_slots + 1), dtype=np.int32),
            csr_eidx=np.zeros((kh, width), dtype=np.int32),
            csr_max_deg=max_deg,
            bucket_id=np.full((kh, num_slots), -1, dtype=np.int32),
            bucket_sizes=sizes, bucket_max_deg=max_degs,
        )

    remote = tile(er_pad, c_pad, "remote")
    local = tile(el_pad, cap, "local")
    for h, i in enumerate(shards):
        rsel, lsel = np.flatnonzero(is_comb[i]), np.flatnonzero(is_master[i])
        for t, sel, shift in ((remote, rsel, comb_base), (local, lsel, 0)):
            n = sel.shape[0]
            t.src[h, :n] = ag.src[i, sel]
            t.dst[h, :n] = ag.dst[i, sel] - shift
            t.mask[h, :n] = True
            for name, v in ag.edge_props.items():
                t.props[name][h, :n] = v[i, sel]
            t.csr_indptr[h], t.csr_eidx[h], _ = csr_layout(
                t.src[h], t.mask[h], num_slots)
            t.bucket_id[h], _, _ = degree_buckets(t.csr_indptr[h], num_slots)

    n_real = int(n_rem.sum() + n_loc.sum())
    return EdgeTileSplit(remote=remote, local=local,
                         remote_fraction=int(n_rem.sum()) / max(n_real, 1))


def slot_to_original(ag: AgentGraph) -> np.ndarray:
    """Recover, per partition, each local slot's ORIGINAL vertex id
    (`[k, num_slots]` int64; -1 for padding/sink slots).

    Masters come straight from `new2old`; agent slots are recovered from
    the positional exchange pairs — `scat_recv_slot[i, j, p]` (agent slot
    on i) is paired with `scat_send_master[j, i, p]` (master slot on j),
    and `comb_send_slot[i, j, p]` with `comb_recv_master[j, i, p]`.  This
    is the inverse the delta-ingress pass needs to match mutations
    (expressed in original ids) against a built AgentGraph's edges.
    """
    k, cap, sink = ag.k, ag.cap, ag.sink
    out = np.full((k, ag.num_slots), -1, dtype=np.int64)
    for i in range(k):
        out[i, :cap] = ag.new2old[i * cap:(i + 1) * cap]
        for j in range(k):
            slots = ag.scat_recv_slot[i, j]
            t = slots != sink
            g = j * cap + ag.scat_send_master[j, i][t]
            out[i, slots[t]] = ag.new2old[g]
            slots = ag.comb_send_slot[i, j]
            t = slots != sink
            g = j * cap + ag.comb_recv_master[j, i][t]
            out[i, slots[t]] = ag.new2old[g]
    return out


def _ranks_within(groups: np.ndarray) -> np.ndarray:
    """Each entry's rank among the entries of its group, in array order."""
    order = np.argsort(groups, kind="stable")
    gs = groups[order]
    starts = np.flatnonzero(np.r_[True, gs[1:] != gs[:-1]])
    lens = np.diff(np.r_[starts, gs.shape[0]])
    ranks = np.empty(groups.shape[0], dtype=np.int64)
    ranks[order] = np.arange(gs.shape[0]) - np.repeat(starts, lens)
    return ranks


def apply_edge_delta(ag: AgentGraph, delta, pad_multiple: int = 8):
    """Delta ingress on a built AgentGraph: retire and append edges WITHOUT
    repartitioning.  Master placement (`old2new`), `cap` and every live
    slot's meaning are kept, so a warm-started state stays valid on the
    mutated topology.

    Fast path (slack-consuming, no shape change):

      * removals tombstone in place: `edge_mask` goes False and the edge
        is repointed at the sink;
      * adds land on `owner(dst)` (the destination is always a local
        master there, so every real dst stays a master or a combiner, as
        `split_edge_tiles` needs), reusing an existing scatter agent for a
        remote src or taking a fresh one from the `s_pad` slack, with its
        exchange pair appended at the next free position of its peer row;
      * each partition's live edges re-sort by destination slot and the
        CSR/bucket indices rebuild; the static facets merge monotonically
        (elementwise max).

    When any pad would overflow (`e_pad` edges, `s_pad` agents, `s_x_pad`
    exchange slots) the graph COMPACTS instead: it is rebuilt from the
    recovered edge set through `build_agent_graph` with the SAME owner
    vector, so `old2new` is unchanged and only the pads regrow; the report
    says so.

    Returns ``(new_ag, DeltaReport)``; `ag` is not changed.  Byte-identical
    to the JAX package's; the agent allocation, which the JAX package
    makes one add row at a time, is vectorised here in the same order
    (first appearance in the delta).
    """
    V, k, cap, sink = ag.num_vertices, ag.k, ag.cap, ag.sink
    s2o = slot_to_original(ag)
    # ---- validate up front, against the ORIGINAL-id live edge set, with
    # the same rules (and messages) as the single-shard path
    o_s = [s2o[i][ag.src[i]] for i in range(k)]
    o_d = [s2o[i][ag.dst[i]] for i in range(k)]
    # masked rows read -1 (negative key) and can never match
    keys = np.concatenate([o_s[i] * np.int64(V) + o_d[i] for i in range(k)])
    rem_all = validate_edge_delta(delta, V, live_keys=keys)
    if delta.num_adds:
        for name in ag.edge_props:
            if name not in delta.add_props:
                raise KeyError(f"delta adds missing edge prop {name!r}")
    owner = (ag.old2new // cap).astype(np.int64)

    # ---- removals: match (src, dst) pairs in original-id space
    rem = rem_all.reshape(k, -1) & ag.edge_mask
    keep = ag.edge_mask & ~rem
    removed_src = np.concatenate([o_s[i][rem[i]] for i in range(k)])
    removed_dst = np.concatenate([o_d[i][rem[i]] for i in range(k)])

    # ---- stage adds on owner(dst); allocate scatter agents as needed
    u, v = delta.add_src, delta.add_dst
    i_of = owner[v]
    j_of = owner[u]
    d_loc = ag.old2new[v] - i_of * cap
    s_loc = ag.old2new[u] - j_of * cap          # right where j == i
    remote = np.flatnonzero(j_of != i_of)
    num_scatter = ag.num_scatter.copy()
    scat_used = (ag.scat_recv_slot != sink).sum(axis=2)      # [i, j]
    overflow = False
    scat_appends = None
    if remote.size:
        # existing scatter agents of each partition, keyed (i, original)
        rows = [np.arange(cap, cap + int(ag.num_scatter[i]))
                for i in range(k)]
        akeys = np.concatenate([i * np.int64(V) + s2o[i][r]
                                for i, r in enumerate(rows)])
        aslot = np.concatenate(rows)
        order = np.argsort(akeys, kind="stable")
        akeys, aslot = akeys[order], aslot[order]
        want = i_of[remote] * np.int64(V) + u[remote]
        found = np.zeros(want.shape[0], dtype=bool)
        if akeys.size:
            pos = np.minimum(np.searchsorted(akeys, want), akeys.size - 1)
            found = akeys[pos] == want
            s_loc[remote[found]] = aslot[pos[found]]
        fresh = remote[~found]
        if fresh.size:
            # one new agent per distinct (i, u), in order of first
            # appearance in the delta: its slot by rank among partition
            # i's new agents, its exchange position by rank among (i, j)'s
            _, first, inv = np.unique(want[~found], return_index=True,
                                      return_inverse=True)
            by_first = np.argsort(first, kind="stable")
            rows_new = fresh[first[by_first]]
            fi, fj = i_of[rows_new], j_of[rows_new]
            new_i = np.bincount(fi, minlength=k)
            new_ij = np.bincount(fi * k + fj, minlength=k * k).reshape(k, k)
            if (np.any(num_scatter + new_i > ag.s_pad)
                    or np.any(scat_used + new_ij > ag.s_x_pad)):
                overflow = True
            else:
                slot = cap + num_scatter[fi] + _ranks_within(fi)
                scat_appends = (fi, fj, slot,
                                ag.old2new[u[rows_new]] - fj * cap,
                                scat_used[fi, fj] + _ranks_within(fi * k
                                                                  + fj))
                slot_of = np.empty(first.shape[0], dtype=np.int64)
                slot_of[by_first] = slot
                s_loc[fresh] = slot_of[inv.reshape(-1)]
                num_scatter += new_i
    if not overflow:
        adds_per = np.bincount(i_of, minlength=k)
        overflow = bool(np.any(keep.sum(axis=1) + adds_per > ag.e_pad))
    if overflow:
        return _rebuild_with_delta(ag, delta, pad_multiple)

    # ---- commit: tombstone + append + per-partition dst re-sort
    src = np.full_like(ag.src, sink)
    dst = np.full_like(ag.dst, sink)
    edge_mask = np.zeros_like(ag.edge_mask)
    eprops = {name: np.zeros_like(val) for name, val in ag.edge_props.items()}
    num_edges = np.zeros(k, dtype=np.int64)
    num_slots = ag.num_slots
    csr_indptr = np.zeros_like(ag.csr_indptr)
    csr_eidx = np.zeros_like(ag.csr_eidx)
    csr_max_deg = ag.csr_max_deg          # monotone: max with old statics
    bucket_id = np.full_like(ag.bucket_id, -1)
    bucket_sizes, bucket_max_deg = (), ()
    add_order = np.argsort(i_of, kind="stable")
    add_starts = np.r_[0, np.cumsum(np.bincount(i_of, minlength=k))]
    for i in range(k):
        ksel = np.flatnonzero(keep[i])
        tsel = add_order[add_starts[i]:add_starts[i + 1]]
        s_all = np.concatenate([ag.src[i][ksel],
                                s_loc[tsel].astype(np.int32)])
        d_all = np.concatenate([ag.dst[i][ksel],
                                d_loc[tsel].astype(np.int32)])
        props = {name: np.concatenate(
                     [val[i][ksel],
                      np.asarray(delta.add_props[name], val.dtype)[tsel]
                      if tsel.size else val[i][:0]])
                 for name, val in ag.edge_props.items()}
        eorder = merge_order(d_all[:ksel.shape[0]], d_all[ksel.shape[0]:])
        n_e = int(s_all.shape[0])
        num_edges[i] = n_e
        src[i, :n_e] = s_all[eorder]
        dst[i, :n_e] = d_all[eorder]
        edge_mask[i, :n_e] = True
        for name, val in props.items():
            eprops[name][i, :n_e] = val[eorder]
        csr_indptr[i], csr_eidx[i], deg = csr_layout(src[i], edge_mask[i],
                                                     num_slots)
        csr_max_deg = max(csr_max_deg, deg)
        bucket_id[i], sizes, max_degs = degree_buckets(csr_indptr[i],
                                                       num_slots)
        bucket_sizes = _merge_bucket_stats(bucket_sizes, sizes)
        bucket_max_deg = _merge_bucket_stats(bucket_max_deg, max_degs)
    bucket_sizes = _merge_bucket_stats(bucket_sizes, ag.bucket_sizes)
    bucket_max_deg = _merge_bucket_stats(bucket_max_deg, ag.bucket_max_deg)

    scat_recv = ag.scat_recv_slot.copy()
    scat_send = ag.scat_send_master.copy()
    if scat_appends is not None:
        fi, fj, slot, master_loc, pos = scat_appends
        scat_recv[fi, fj, pos] = slot
        scat_send[fj, fi, pos] = master_loc

    # global out-degree aux: adjust masters by the delta's degree change
    d_out = (np.bincount(delta.add_src, minlength=V)
             - np.bincount(removed_src, minlength=V)).astype(np.float32)
    out_degree = ag.out_degree.copy()
    for i in range(k):
        own_old = ag.new2old[i * cap:(i + 1) * cap]
        valid = own_old >= 0
        out_degree[i, valid] += d_out[own_old[valid]]

    new_ag = dataclasses.replace(
        ag, src=src, dst=dst, edge_mask=edge_mask, edge_props=eprops,
        out_degree=out_degree, scat_recv_slot=scat_recv,
        scat_send_master=scat_send, num_scatter=num_scatter,
        num_edges=num_edges, csr_indptr=csr_indptr, csr_eidx=csr_eidx,
        csr_max_deg=csr_max_deg, bucket_id=bucket_id,
        bucket_sizes=bucket_sizes, bucket_max_deg=bucket_max_deg)
    report = DeltaReport(added_src=delta.add_src.copy(),
                         added_dst=delta.add_dst.copy(),
                         removed_src=removed_src, removed_dst=removed_dst,
                         compacted=False)
    return new_ag, report


def _rebuild_with_delta(ag: AgentGraph, delta, pad_multiple: int):
    """Slack exhausted: recover the live edge set (original ids and their
    partition), apply the delta at the COO level and rebuild through
    `build_agent_graph` with the same owner vector: master placement and
    `old2new` are kept, only the agent and edge pads regrow."""
    V, k, cap = ag.num_vertices, ag.k, ag.cap
    s2o = slot_to_original(ag)
    srcs, dsts, parts = [], [], []
    props = {name: [] for name in ag.edge_props}
    removed_src, removed_dst = [], []
    for i in range(k):
        m = ag.edge_mask[i]
        o_s = s2o[i][ag.src[i]][m]
        o_d = s2o[i][ag.dst[i]][m]
        rem = removal_selector(o_s, o_d, delta.rem_src, delta.rem_dst, V)
        srcs.append(o_s[~rem])
        dsts.append(o_d[~rem])
        parts.append(np.full(int((~rem).sum()), i, np.int64))
        removed_src.append(o_s[rem])
        removed_dst.append(o_d[rem])
        for name, val in ag.edge_props.items():
            props[name].append(val[i][m][~rem])
    owner = (ag.old2new // cap).astype(np.int64)
    srcs.append(delta.add_src)
    dsts.append(delta.add_dst)
    parts.append(owner[delta.add_dst])
    for name in props:
        col = (np.asarray(delta.add_props[name],
                          ag.edge_props[name].dtype)
               if delta.num_adds else props[name][0][:0])
        props[name].append(col)
    graph = Graph(V, np.concatenate(srcs), np.concatenate(dsts),
                  {name: np.concatenate(val) for name, val in props.items()})
    new_ag = build_agent_graph(graph, np.concatenate(parts), k,
                               owner=owner, pad_multiple=pad_multiple,
                               partitioner=ag.partitioner)
    if not np.array_equal(new_ag.old2new, ag.old2new):
        raise AssertionError("compaction must preserve master placement")
    report = DeltaReport(added_src=delta.add_src.copy(),
                         added_dst=delta.add_dst.copy(),
                         removed_src=np.concatenate(removed_src),
                         removed_dst=np.concatenate(removed_dst),
                         compacted=True)
    return new_ag, report


def _bits_to_ids(row: np.ndarray) -> np.ndarray:
    """Set-bit positions of one packed uint64 bitset row, ascending."""
    return np.flatnonzero(np.unpackbits(row.view(np.uint8),
                                        bitorder="little"))


def build_agent_graph(graph, edge_part, k: int,
                      owner: Optional[np.ndarray] = None,
                      pad_multiple: int = 8,
                      transpose: bool = False,
                      chunk_size: Optional[int] = None,
                      partitioner: Optional[str] = None) -> AgentGraph:
    """Chunked two-pass Agent-Graph ingress.

    `graph` is either an in-memory `Graph` or any `EdgeChunkSource`
    (`graph.structures`): the build only ever touches the edge stream
    through restartable chunk iteration, so per-shard tiles are assembled
    WITHOUT a second full copy of the edge list — peak host state is the
    output tiles themselves plus one chunk plus O(V·k/8) packed
    bookkeeping bitsets (the same bound the streaming partitioners obey).
    An in-memory `Graph` with `chunk_size=None` streams as one
    whole-list chunk; any `chunk_size` produces a BITWISE-identical
    AgentGraph, because both passes visit edges in stream order and the
    final per-partition dst sort is stable.

      pass A  per chunk: master-placement incidence counts (when `owner`
              is None), global out-degrees, per-partition edge counts,
              and packed (partition, vertex) src/dst touch bitsets — the
              bounded substitute for the monolithic path's per-partition
              `np.unique` over materialized relabeled endpoints;
      pass B  per chunk: translate endpoints to local slots and append to
              each partition's tile at its cursor (stream order), then
              stable-sort every tile by destination slot and build the
              CSR/bucket/exchange metadata.

    `edge_part` may be the usual per-edge placement array or a partitioner
    NAME (`partition_stream.PARTITIONERS`); a name is dispatched through
    `partition_edges` and recorded on `AgentGraph.partitioner`.

    `transpose=True` builds the agent graph of the REVERSED edge set
    (paper §4.2: backward traversal for multi-stage algorithms) while
    keeping the same edge partition and master placement (owners are
    assigned on the FORWARD graph), so forward and backward stages share
    vertex ownership and results relabel identically stage to stage."""
    from repro_torch.core.partition_stream import bitset_set, partition_edges

    if isinstance(edge_part, str):
        partitioner = edge_part
        edge_part = partition_edges(graph, k, method=partitioner)
    if hasattr(graph, "chunks"):
        source = graph
    else:
        source = graph.chunk_source(chunk_size or max(graph.num_edges, 1))
    V, E = source.num_vertices, source.num_edges
    edge_part = np.asarray(edge_part)
    if edge_part.shape[0] != E:
        raise ValueError(f"edge_part has {edge_part.shape[0]} entries "
                         f"for a {E}-edge stream")

    # ---- pass A: counts + touch bitsets -------------------------------
    need_owner = owner is None
    counts = np.zeros((k, V), dtype=np.int64) if need_owner else None
    glob_outdeg = np.zeros(V, dtype=np.int64)
    ne = np.zeros(k, dtype=np.int64)
    words = (V + 63) >> 6
    touch_src = np.zeros((k, words), dtype=np.uint64)
    touch_dst = np.zeros((k, words), dtype=np.uint64)
    for chunk in source.chunks():
        ep = edge_part[chunk.offset:chunk.offset + chunk.num_edges]
        fs, fd = chunk.src, chunk.dst
        s, d = (fd, fs) if transpose else (fs, fd)
        if need_owner:
            accumulate_owner_counts(counts, fs, fd, ep)
        glob_outdeg += np.bincount(s, minlength=V)
        ne += np.bincount(ep, minlength=k)
        bitset_set(touch_src, ep, s)
        bitset_set(touch_dst, ep, d)
    if need_owner:
        owner = owners_from_counts(counts)
        del counts

    cap = -(-V // k)
    cap = -(-cap // pad_multiple) * pad_multiple
    owner = rebalance_owners(owner, k, cap)

    # contiguous relabeling: partition i owns global ids [i*cap, i*cap+n_i)
    order = np.lexsort((np.arange(V), owner))
    old2new = np.empty(V, dtype=np.int64)
    new2old = np.full(k * cap, -1, dtype=np.int64)
    offs = np.zeros(k + 1, dtype=np.int64)
    np.cumsum(np.bincount(owner, minlength=k), out=offs[1:])
    ranks = np.arange(V) - offs[owner[order]]
    old2new[order] = owner[order] * cap + ranks
    new2old[old2new] = np.arange(V)

    # remote-master agent id lists, from the touch bitsets: ascending
    # relabeled order (old2new of a set, sorted) == the monolithic
    # `np.unique(s_g[s_rem])`.
    per = []
    for i in range(k):
        us = _bits_to_ids(touch_src[i])
        vs = _bits_to_ids(touch_dst[i])
        scat_ids = np.sort(old2new[us[owner[us] != i]])  # scatter FROM
        comb_ids = np.sort(old2new[vs[owner[vs] != i]])  # combine FOR
        per.append(dict(scat_ids=scat_ids, comb_ids=comb_ids))

    s_pad = max(1, max(p["scat_ids"].shape[0] for p in per))
    c_pad = max(1, max(p["comb_ids"].shape[0] for p in per))
    e_pad = max(1, int(ne.max()))
    s_pad = -(-s_pad // pad_multiple) * pad_multiple
    c_pad = -(-c_pad // pad_multiple) * pad_multiple
    e_pad = -(-e_pad // pad_multiple) * pad_multiple
    sink = cap + s_pad + c_pad

    src = np.full((k, e_pad), sink, dtype=np.int32)
    dst = np.full((k, e_pad), sink, dtype=np.int32)
    edge_mask = np.zeros((k, e_pad), dtype=bool)
    eprops = {name: np.zeros((k, e_pad), dtype=dt)
              for name, dt in source.prop_dtypes.items()}
    out_degree = np.zeros((k, cap), dtype=np.float32)
    num_scatter = np.zeros(k, dtype=np.int64)
    num_combiner = np.zeros(k, dtype=np.int64)
    num_edges = ne.copy()

    # per-pair exchange lists
    comb_send = [[[] for _ in range(k)] for _ in range(k)]   # [i][j] combiner slots on i
    comb_recv = [[[] for _ in range(k)] for _ in range(k)]   # [j][i] master slots on j
    scat_send = [[[] for _ in range(k)] for _ in range(k)]   # [j][i] master slots on j
    scat_recv = [[[] for _ in range(k)] for _ in range(k)]   # [i][j] agent slots on i

    # ---- pass B: fill tiles at cursors in stream order ----------------
    cursor = np.zeros(k, dtype=np.int64)
    for chunk in source.chunks():
        ep = edge_part[chunk.offset:chunk.offset + chunk.num_edges]
        fs, fd = chunk.src, chunk.dst
        s, d = (fd, fs) if transpose else (fs, fd)
        s_g, d_g = old2new[s], old2new[d]
        s_own, d_own = owner[s], owner[d]
        for i in np.unique(ep):
            m = ep == i
            p = per[i]
            s_loc = np.where(
                s_own[m] != i,
                cap + np.searchsorted(p["scat_ids"], s_g[m]),
                s_g[m] - i * cap)
            d_loc = np.where(
                d_own[m] != i,
                cap + s_pad + np.searchsorted(p["comb_ids"], d_g[m]),
                d_g[m] - i * cap)
            lo = int(cursor[i])
            hi = lo + s_loc.shape[0]
            src[i, lo:hi] = s_loc
            dst[i, lo:hi] = d_loc
            for name in eprops:
                eprops[name][i, lo:hi] = chunk.props[name][m]
            cursor[i] = hi

    for i, p in enumerate(per):
        n_e = int(ne[i])
        num_scatter[i] = p["scat_ids"].shape[0]
        num_combiner[i] = p["comb_ids"].shape[0]
        # sort local edges by destination slot (combine key); the stream
        # order laid down in pass B is the monolithic selection order, so
        # the stable permutation — and every downstream array — matches
        # the single-pass build bit for bit.
        eorder = np.argsort(dst[i, :n_e], kind="stable")
        src[i, :n_e] = src[i, :n_e][eorder]
        dst[i, :n_e] = dst[i, :n_e][eorder]
        edge_mask[i, :n_e] = True
        for name in eprops:
            eprops[name][i, :n_e] = eprops[name][i, :n_e][eorder]
        # master aux: global out-degree
        own_old = new2old[i * cap:(i + 1) * cap]
        valid = own_old >= 0
        out_degree[i, valid] = glob_outdeg[own_old[valid]].astype(np.float32)
        # exchange lists
        for r, g in enumerate(p["comb_ids"]):
            j = int(g // cap)
            comb_send[i][j].append(cap + s_pad + r)
            comb_recv[j][i].append(int(g - j * cap))
        for r, g in enumerate(p["scat_ids"]):
            j = int(g // cap)
            scat_send[j][i].append(int(g - j * cap))
            scat_recv[i][j].append(cap + r)

    # The scatter/combiner loads are SKEWED (paper Fig. 12b/13b); sizing the
    # two exchange buffers independently halves all_to_all bytes on fan-in
    # or fan-out heavy graphs.
    c_x_pad = max(1, max(len(comb_send[i][j]) for i in range(k)
                         for j in range(k)))
    s_x_pad = max(1, max(len(scat_send[i][j]) for i in range(k)
                         for j in range(k)))
    c_x_pad = -(-c_x_pad // pad_multiple) * pad_multiple
    s_x_pad = -(-s_x_pad // pad_multiple) * pad_multiple

    def stack(lists, fill, width):
        out = np.full((k, k, width), fill, dtype=np.int32)
        for a in range(k):
            for b in range(k):
                v = np.asarray(lists[a][b], dtype=np.int32)
                out[a, b, :v.shape[0]] = v
        return out

    # src-sorted CSR over each partition's local edges (frontier compaction)
    num_slots = sink + 1
    csr_indptr = np.zeros((k, num_slots + 1), dtype=np.int32)
    csr_eidx = np.zeros((k, e_pad), dtype=np.int32)
    csr_max_deg = 0
    bucket_id = np.full((k, num_slots), -1, dtype=np.int32)
    bucket_sizes = bucket_max_deg = ()
    for i in range(k):
        csr_indptr[i], csr_eidx[i], deg = csr_layout(src[i], edge_mask[i],
                                                     num_slots)
        csr_max_deg = max(csr_max_deg, deg)
        bucket_id[i], sizes, max_degs = degree_buckets(csr_indptr[i],
                                                       num_slots)
        bucket_sizes = _merge_bucket_stats(bucket_sizes, sizes)
        bucket_max_deg = _merge_bucket_stats(bucket_max_deg, max_degs)

    return AgentGraph(
        k=k, num_vertices=V, cap=cap, s_pad=s_pad, c_pad=c_pad, e_pad=e_pad,
        s_x_pad=s_x_pad, c_x_pad=c_x_pad,
        src=src, dst=dst, edge_mask=edge_mask, edge_props=eprops,
        out_degree=out_degree, old2new=old2new, new2old=new2old,
        comb_send_slot=stack(comb_send, sink, c_x_pad),
        comb_recv_master=stack(comb_recv, sink, c_x_pad),  # identity-safe
        scat_send_master=stack(scat_send, 0, s_x_pad),
        scat_recv_slot=stack(scat_recv, sink, s_x_pad),
        num_scatter=num_scatter, num_combiner=num_combiner,
        num_edges=num_edges,
        csr_indptr=csr_indptr, csr_eidx=csr_eidx, csr_max_deg=csr_max_deg,
        bucket_id=bucket_id, bucket_sizes=bucket_sizes,
        bucket_max_deg=bucket_max_deg,
        partitioner=partitioner or "",
    )
