"""DimeNet: directional message passing (arXiv:2003.03123), the counterpart
of `repro/models/dimenet.py`.

Kernel regime: TRIPLET GATHER — messages live on edges; each interaction
block aggregates over triplets (k→j→i): the incoming message m_kj is
modulated by the angular basis of angle ∠(k,j,i) through a bilinear layer,
then summed back onto edge (j→i).  Two nested levels of the GRE
primitive: edge→triplet gather, triplet→edge combine, plus the edge→node
combine of the output blocks.

Every sum goes through the combine kernel (`kernels.ops.route_sum`, one
dense-route launch over a route sorted once) and every row gather through
`kernels.ops.gather_rows` (its backward one combine launch): the routes
(`DimeNetRoutes`) are built with the inputs, since `jax.ops.segment_sum`
takes its index in any order and the kernel takes segments in order.
Triplet lists are precomputed host-side (`build_triplets`) like the
paper's offline graph ingress.  Positions and species are data: no
gradient flows into them.

`dimenet_forward_sharded` runs both combines through the Agent-Graph
exchange (`core/exchange.py`): triplets live on the shard of their kj edge
(a local gather), their sums go into combiner slots of the line graph's
topology and flush once a block, and the edge→node sum flushes through the
molecule graph's topology; `shard_molecule_graph` lays a graph out so.
Entry points build on CUDA unless the caller passes `device="cpu"`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import GNNConfig
from repro_torch.core.engine import resolve_device
from repro_torch.core.exchange import flush_combiners, flush_routes
from repro_torch.core.vertex_program import MONOIDS
from repro_torch.kernels import ops
from repro_torch.models.gnn import _leaf, _map, leaves_from_numpy
from repro_torch.nn.equivariant import bessel_basis, cosine_cutoff
from repro_torch.nn.layers import dense_init, mlp_apply, mlp_init

CUTOFF = 5.0


def build_triplets(src: np.ndarray, dst: np.ndarray, num_nodes: int,
                   pad_to: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side: for each edge pair (k→j, j→i) with k != i emit a triplet.

    Returns (edge_kj [T], edge_ji [T], mask [T]) padded to `pad_to`
    (padding `0, 0, False` at the end).
    """
    E = src.shape[0]
    by_dst: Dict[int, list] = {}
    for e in range(E):
        by_dst.setdefault(int(dst[e]), []).append(e)
    kj, ji = [], []
    for e_ji in range(E):
        j = int(src[e_ji])
        for e_kj in by_dst.get(j, ()):
            if int(src[e_kj]) != int(dst[e_ji]):
                kj.append(e_kj)
                ji.append(e_ji)
    t = len(kj)
    pad_to = max(pad_to, t, 1)
    out_kj = np.zeros(pad_to, np.int32)
    out_ji = np.zeros(pad_to, np.int32)
    mask = np.zeros(pad_to, bool)
    out_kj[:t] = kj
    out_ji[:t] = ji
    mask[:t] = True
    return out_kj, out_ji, mask


def angular_basis(cos_angle: torch.Tensor, n_spherical: int) -> torch.Tensor:
    """Chebyshev angular expansion T_n(cos θ) (stand-in for the spherical
    Bessel × Legendre basis; same tensor shape and smoothness class)."""
    terms = [torch.ones_like(cos_angle), cos_angle]
    for _ in range(2, n_spherical):
        terms.append(2 * cos_angle * terms[-1] - terms[-2])
    return torch.stack(terms[:n_spherical], dim=-1)


def init_dimenet(generator: torch.Generator, cfg: GNNConfig,
                 n_species: int = 16, d_out: int = 1, device="cuda"):
    """Random parameters drawn from `generator` (on `device`) with the JAX
    package's tree, shapes and scales: leaf tensors that require
    gradients."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, device {dev}")
    ch, nb = cfg.d_hidden, cfg.n_bilinear
    nr, ns = cfg.n_radial, cfg.n_spherical

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=dev) * scale

    params = {
        "embed": normal((n_species, ch), 0.5),
        "rbf_proj": dense_init(generator, nr, ch),
        "msg_init": mlp_init(generator, [3 * ch, ch]),
        "blocks": [],
        "out_rbf": dense_init(generator, nr, ch),
        "readout": mlp_init(generator, [ch, ch, d_out]),
    }
    for _ in range(cfg.n_layers):
        params["blocks"].append({
            "w_src": dense_init(generator, ch, ch),
            "w_msg": dense_init(generator, ch, ch),
            "sbf_proj": dense_init(generator, ns * nr, nb),
            "bilinear": normal((ch, nb, ch), 1.0 / np.sqrt(ch)),
            "update": mlp_init(generator, [ch, ch, ch]),
        })
    return _map(_leaf, params)


def params_from_numpy(tree, cfg: GNNConfig, device="cuda"):
    """The JAX package's `init_dimenet` parameters, as numpy arrays in its
    tree, as the port's tree of float32 leaf tensors on `device`."""
    if len(tree["blocks"]) != cfg.n_layers:
        raise ValueError(f"{len(tree['blocks'])} blocks, config "
                         f"{cfg.n_layers}")
    return leaves_from_numpy(tree, device)


@dataclasses.dataclass
class DimeNetRoutes:
    """The routes of one molecule graph, built once: the row gathers'
    backward routes (`m[tri_kj]`, `embed[species[src]]`,
    `embed[species[dst]]`) and the two sums' (triplet → ji edge over the
    live triplets; edge → node over the edges with `dst < V`)."""

    species_src: torch.Tensor    # [E] species of each edge's source
    species_dst: torch.Tensor
    kj: ops.GatherRoute
    emb_src: ops.GatherRoute
    emb_dst: ops.GatherRoute
    ji: ops.GatherRoute
    node: ops.GatherRoute

    @staticmethod
    def build(species, src, dst, tri_kj, tri_ji, tri_mask, num_nodes: int,
              n_species: int) -> "DimeNetRoutes":
        E = src.shape[0]
        s_src = species.index_select(0, src.long())
        s_dst = species.index_select(0, dst.long())
        return DimeNetRoutes(
            s_src, s_dst,
            kj=ops.GatherRoute.build(tri_kj, E),
            emb_src=ops.GatherRoute.build(s_src, n_species),
            emb_dst=ops.GatherRoute.build(s_dst, n_species),
            ji=ops.GatherRoute.build(tri_ji, E, mask=tri_mask),
            node=ops.GatherRoute.build(dst, num_nodes,
                                       mask=dst.long() < num_nodes))


def _edge_geometry(pos, src, dst, tri_kj, tri_ji, tri_mask, cfg):
    """`(rbf [E, nr], sbf [T, ns·nr])` of the edges and triplets, as the
    JAX package computes them (masked triplets zero)."""
    vec = pos.index_select(0, dst.long()) - pos.index_select(0, src.long())
    d = torch.linalg.norm(vec, dim=-1)
    rbf = (bessel_basis(d, cfg.n_radial, CUTOFF)
           * cosine_cutoff(d, CUTOFF)[:, None])
    # angle at j between (k→j) and (j→i): cos θ = v_kj·v_ji /(|..||..|)
    v_kj = vec.index_select(0, tri_kj.long())
    v_ji = vec.index_select(0, tri_ji.long())
    cosang = (v_kj * v_ji).sum(-1) / torch.clamp(
        torch.linalg.norm(v_kj, dim=-1) * torch.linalg.norm(v_ji, dim=-1),
        min=1e-6)
    d_kj = d.index_select(0, tri_kj.long())
    sbf = (angular_basis(cosang, cfg.n_spherical)[:, :, None]
           * bessel_basis(d_kj, cfg.n_radial, CUTOFF)[:, None, :]
           ).reshape(-1, cfg.n_spherical * cfg.n_radial)
    return rbf, sbf * tri_mask[:, None].to(sbf.dtype)


def _initial_messages(params, species_src, species_dst, rbf, edge_mask,
                      routes_src, routes_dst):
    """Edge messages from the endpoint embeddings and the rbf, masked."""
    hz_s = ops.gather_rows(params["embed"], species_src, routes_src)
    hz_d = ops.gather_rows(params["embed"], species_dst, routes_dst)
    m = mlp_apply(params["msg_init"], torch.cat(
        [hz_s, hz_d, rbf @ params["rbf_proj"]], dim=-1))
    return m * edge_mask[:, None].to(m.dtype)


def _interaction(blk, m, m_kj, sbf, agg_fn, edge_mask):
    """One block's update of the edge messages `m` from the gathered
    `m_kj`: the bilinear triplet messages, their sum onto ji edges
    (`agg_fn`), the residual updates."""
    sb = sbf @ blk["sbf_proj"]
    inter = torch.einsum("tc,cbd,tb->td", m_kj, blk["bilinear"], sb)
    agg = agg_fn(inter)
    m = m + F.silu(m @ blk["w_msg"] + agg @ blk["w_src"])
    m = m * edge_mask[:, None].to(m.dtype)
    return m + mlp_apply(blk["update"], m, act=F.silu)


def dimenet_forward(params, pos: torch.Tensor, species: torch.Tensor,
                    src: torch.Tensor, dst: torch.Tensor,
                    edge_mask: torch.Tensor, tri_kj: torch.Tensor,
                    tri_ji: torch.Tensor, tri_mask: torch.Tensor,
                    cfg: GNNConfig,
                    routes: Optional[DimeNetRoutes] = None) -> torch.Tensor:
    """Returns per-node outputs [V, d_out].

    `tri_ji` need not be sorted (`build_triplets` pads at the end):
    `routes` (built here when not given) sorts each sum's index once, and
    masked triplets leave the triplet sum.  Each block runs under
    `torch.utils.checkpoint` (the JAX package's `jax.checkpoint`), so the
    backward recomputes it, its triplet sum included.
    """
    V = pos.shape[0]
    if routes is None:
        routes = DimeNetRoutes.build(species, src, dst, tri_kj, tri_ji,
                                     tri_mask, V, params["embed"].shape[0])
    rbf, sbf = _edge_geometry(pos, src, dst, tri_kj, tri_ji, tri_mask, cfg)
    m = _initial_messages(params, routes.species_src, routes.species_dst,
                          rbf, edge_mask, routes.emb_src, routes.emb_dst)
    kj = tri_kj.long()

    def block_fn(m, blk):
        m_kj = ops.gather_rows(m, kj, routes.kj)
        return _interaction(blk, m, m_kj, sbf,
                            lambda x: ops.route_sum(x, routes.ji), edge_mask)

    node_out = torch.zeros((V, params["embed"].shape[1]), dtype=pos.dtype,
                           device=pos.device)
    for blk in params["blocks"]:
        m = checkpoint(block_fn, m, blk, use_reentrant=False)
        # per-block output: edge → node sum
        node_out = node_out + ops.route_sum(m * (rbf @ params["out_rbf"]),
                                            routes.node)
    return mlp_apply(params["readout"], node_out, act=F.silu)


# ------------------------------------------------ the Agent-Graph forward
@dataclasses.dataclass
class ShardedMolecule:
    """A molecule graph laid over the Agent-Graph shards a communicator
    holds (`shard_molecule_graph`).

    `ag_tri`/`topo_tri`: the line graph (vertices are the graph's edges,
    edges its live triplets kj → ji), each edge mastered on its shard;
    `ag_node`/`topo_node`: the graph itself under the same edge placement.
    Per-edge rows follow `topo_tri`'s held masters (`[k_local·cap_tri]`,
    padding masters masked), per-triplet rows its held edge columns.
    """

    comm: object
    ag_tri: object
    ag_node: object
    topo_tri: object
    topo_node: object
    species_src: torch.Tensor    # [k_local·cap_tri]
    species_dst: torch.Tensor
    edge_mask: torch.Tensor      # [k_local·cap_tri] bool, padding False
    rbf: torch.Tensor            # [k_local·cap_tri, nr]
    sbf: torch.Tensor            # [n_tri, ns·nr], masked triplets zero
    tri_kj_row: torch.Tensor     # [n_tri] int64 rows of the edge rows
    tri_mask: torch.Tensor       # [n_tri] bool
    # the gathers' backward routes, the edge → node sum's (over each
    # edge's stacked destination slot in topo_node) and the two flushes'
    routes: Dict[str, object]

    @property
    def node_masters(self) -> torch.Tensor:
        """`[k_local·cap_node]` bool: the held node masters that are real
        vertices."""
        ag, held = self.ag_node, self.comm.shards
        ids = ag.new2old[held.start * ag.cap:held.stop * ag.cap]
        return torch.from_numpy(ids >= 0).to(self.rbf.device)

    def node_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Per-node values `[V, ...]` in original ids -> the held node
        masters' rows `[k_local·cap_node, ...]` (padding zero)."""
        ag, held = self.ag_node, self.comm.shards
        ids = ag.new2old[held.start * ag.cap:held.stop * ag.cap]
        keep = torch.from_numpy(np.flatnonzero(ids >= 0)).to(x.device)
        out = torch.zeros((ids.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        return out.index_copy(0, keep, x.index_select(
            0, torch.from_numpy(ids[ids >= 0]).to(x.device)))

    def original_order(self, rows: torch.Tensor) -> np.ndarray:
        """The held node masters' rows -> every shard's `[V, ...]` in
        original ids (`comm.all_gather`: a collective)."""
        ag = self.ag_node
        payload = tuple(rows.shape[1:])
        every = self.comm.all_gather(rows.detach().reshape(
            (len(self.comm.shards), ag.cap) + payload))
        return every.reshape((-1,) + payload).cpu().numpy()[ag.old2new]


def shard_molecule_graph(pos, species, src, dst, edge_mask, tri_kj, tri_ji,
                         tri_mask, cfg: GNNConfig, comm, n_species: int = 16,
                         device="cuda") -> ShardedMolecule:
    """Lay a molecule graph and its triplets over the k shards of `comm`
    (the rows of the shards it holds), through the existing ingress.

    The edges are placed by `partition_edges(..., method="hdrf")`, then
    capped at the line graph's masters a shard (`rebalance_owners`, the
    ingress' own cap), so an edge's shard is its master's shard in the
    line graph.  `topo_tri` is `build_agent_graph` over the line graph
    (each triplet on its kj edge's shard: the gather of m_kj is local);
    `topo_node` is `build_agent_graph` over the graph under the same
    placement.  `dst_slot` is each edge's destination slot in `topo_node`
    on the edge's own shard (a master or a combiner).  Asserted here: the
    two topologies agree on every edge's shard, every triplet's kj edge is
    a local master and every edge's destination slot exists.  The
    geometry is computed as `dimenet_forward` does, so the sharded forward
    sees the same values.  Inputs are numpy arrays (or tensors).
    """
    from repro_torch.core import algorithms
    from repro_torch.core.agent_graph import build_agent_graph
    from repro_torch.core.dist_engine import DistGREEngine
    from repro_torch.core.partition import rebalance_owners
    from repro_torch.core.partition_stream import partition_edges
    from repro_torch.graph.structures import Graph

    dev = resolve_device(device)
    pos, species, src, dst, edge_mask, tri_kj, tri_ji, tri_mask = (
        np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
        for a in (pos, species, src, dst, edge_mask, tri_kj, tri_ji,
                  tri_mask))
    k, pad = comm.k, 8
    V, E = pos.shape[0], src.shape[0]
    eid = np.arange(E, dtype=np.int64)
    graph = Graph(V, src.astype(np.int64), dst.astype(np.int64),
                  {"eid": eid})
    cap_tri = -(-(-(-E // k)) // pad) * pad
    placement = rebalance_owners(partition_edges(graph, k, method="hdrf"),
                                 k, cap_tri)
    ag_node = build_agent_graph(graph, placement, k, pad_multiple=pad,
                                partitioner="hdrf")
    live = np.flatnonzero(tri_mask)
    tid = np.arange(tri_kj.shape[0], dtype=np.int64)[live]
    line = Graph(E, tri_kj[live].astype(np.int64),
                 tri_ji[live].astype(np.int64), {"tid": tid})
    ag_tri = build_agent_graph(line, placement[tri_kj[live]], k,
                               owner=placement, pad_multiple=pad,
                               partitioner="hdrf")
    if ag_tri.cap != cap_tri or not np.array_equal(
            ag_tri.old2new // cap_tri, placement):
        raise AssertionError("the line graph moved an edge off its shard")

    held = comm.shards
    kl = len(held)

    def topology(ag):
        return DistGREEngine(algorithms.bfs_program(), k, exchange="agent",
                             device=dev, comm=comm).device_topology(ag)

    topo_tri, topo_node = topology(ag_tri), topology(ag_node)

    # each edge's destination slot in topo_node, on the shard holding it
    n_e = ag_node.num_edges
    shard_of = np.concatenate([np.full(int(n_e[i]), i) for i in range(k)])
    e_of = np.concatenate([ag_node.edge_props["eid"][i, :n_e[i]]
                           for i in range(k)])
    d_of = np.concatenate([ag_node.dst[i, :n_e[i]] for i in range(k)])
    if not np.array_equal(np.sort(e_of), eid):
        raise AssertionError("topo_node does not hold every edge once")
    edge_shard = np.empty(E, np.int64)
    edge_shard[e_of] = shard_of
    edge_dst_slot = np.empty(E, np.int64)
    edge_dst_slot[e_of] = d_of
    if not np.array_equal(edge_shard, placement):
        raise AssertionError("the two topologies place an edge apart")
    if np.any(edge_dst_slot >= ag_node.sink):
        raise AssertionError("an edge's destination has no slot")

    # the held line-graph masters: their edges (-1 padding)
    rows = ag_tri.new2old[held.start * cap_tri:held.stop * cap_tri]
    real = rows >= 0
    e_rows = np.where(real, rows, 0)
    dst_slot = np.where(real, (edge_shard[e_rows] - held.start)
                        * ag_node.num_slots + edge_dst_slot[e_rows], 0)

    part = topo_tri.part
    t_src = part.src.cpu().numpy().astype(np.int64)
    t_mask = part.edge_mask.cpu().numpy()
    shard_local = t_src // ag_tri.num_slots
    slot_local = t_src % ag_tri.num_slots
    if np.any(t_mask & (slot_local >= cap_tri)):
        raise AssertionError("a triplet's kj edge is not a local master")
    tri_kj_row = np.where(t_mask, shard_local * cap_tri + slot_local, 0)
    tids = np.where(t_mask, part.edge_props["tid"].cpu().numpy(), 0)

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    pos_t = t(pos, torch.float32)
    src_t, dst_t = t(src, torch.int64), t(dst, torch.int64)
    kj_t, ji_t = t(tri_kj[tids], torch.int64), t(tri_ji[tids], torch.int64)
    tmask_t = t(t_mask)
    # the geometry of every edge and of the held triplets, as the whole
    # forward computes it; then the held edges' rows
    rbf, sbf = _edge_geometry(pos_t, src_t, dst_t, kj_t, ji_t, tmask_t, cfg)
    e_t = t(e_rows, torch.int64)
    spec = t(species, torch.int64)
    s_src = spec.index_select(0, src_t.index_select(0, e_t))
    s_dst = spec.index_select(0, dst_t.index_select(0, e_t))
    tri_kj_row_t = t(tri_kj_row, torch.int64)
    routes = {
        "kj": ops.GatherRoute.build(tri_kj_row_t, kl * cap_tri),
        "emb_src": ops.GatherRoute.build(s_src, n_species),
        "emb_dst": ops.GatherRoute.build(s_dst, n_species),
        "node": ops.GatherRoute.build(t(dst_slot, torch.int64),
                                      kl * ag_node.num_slots, mask=t(real)),
        "tri_flush": flush_routes(topo_tri),
        "node_flush": flush_routes(topo_node),
    }
    return ShardedMolecule(
        comm=comm, ag_tri=ag_tri, ag_node=ag_node, topo_tri=topo_tri,
        topo_node=topo_node, species_src=s_src, species_dst=s_dst, edge_mask=t(real & edge_mask[e_rows]),
        rbf=rbf.index_select(0, e_t), sbf=sbf, tri_kj_row=tri_kj_row_t,
        tri_mask=tmask_t, routes=routes)


def _masters(x: torch.Tensor, kl: int, slots: int, cap: int):
    """`[kl·slots, ...]` -> the master rows `[kl·cap, ...]`."""
    payload = tuple(x.shape[1:])
    return x.reshape((kl, slots) + payload)[:, :cap].reshape(
        (kl * cap,) + payload)


def dimenet_forward_sharded(params, shard: ShardedMolecule,
                            cfg: GNNConfig) -> torch.Tensor:
    """Agent-Graph DimeNet over the shards `shard.comm` holds: per-node
    outputs `[k_local·cap_node, d_out]` of the held node masters (padding
    rows meaningless; `shard.original_order` gathers them).

    Both nested combines run through combiner agents: `m[tri_kj]` is a
    local gather; the triplet → ji-edge sum goes into `topo_tri`'s slots
    (its edges are the triplets, dst-sorted at ingress, so it is one
    combine over the topology's row pointer) and ONE flush a block; the
    edge → node sum goes into `topo_node`'s slots and flushes the same
    way.  Every flush's gathers and the all-to-all carry gradients
    (`flush_combiners(..., routes=)`), so the backward runs the combine
    kernel and the communicator's transposed exchange.
    """
    comm, kl = shard.comm, len(shard.comm.shards)
    ag_t, ag_n = shard.ag_tri, shard.ag_node
    part = shard.topo_tri.part
    r = shard.routes
    sum_m = MONOIDS["sum"]
    m = _initial_messages(params, shard.species_src, shard.species_dst,
                          shard.rbf, shard.edge_mask, r["emb_src"],
                          r["emb_dst"])

    def tri_sum(inter):
        inter = inter * shard.tri_mask[:, None].to(inter.dtype)
        comb = ops.segment_combine(inter, part.dst, part.num_slots, "sum",
                                   seg_ptr=part.seg_ptr)
        flushed = flush_combiners(comm, comb, shard.topo_tri.comb_send,
                                  shard.topo_tri.comb_recv, sum_m,
                                  routes=r["tri_flush"])
        return _masters(comb + flushed, kl, ag_t.num_slots, ag_t.cap)

    def block_fn(m, blk):
        m_kj = ops.gather_rows(m, shard.tri_kj_row, r["kj"])
        return _interaction(blk, m, m_kj, shard.sbf, tri_sum,
                            shard.edge_mask)

    node_out = torch.zeros((kl * ag_n.cap, params["embed"].shape[1]),
                           dtype=m.dtype, device=m.device)
    for blk in params["blocks"]:
        m = checkpoint(block_fn, m, blk, use_reentrant=False)
        comb = ops.route_sum(m * (shard.rbf @ params["out_rbf"]), r["node"])
        flushed = flush_combiners(comm, comb, shard.topo_node.comb_send,
                                  shard.topo_node.comb_recv, sum_m,
                                  routes=r["node_flush"])
        node_out = node_out + _masters(comb + flushed, kl, ag_n.num_slots,
                                       ag_n.cap)
    return mlp_apply(params["readout"], node_out, act=F.silu)
