"""GCN and GIN on the GRE scatter-combine primitive, with gradients (the
counterpart of `repro/models/gnn.py`).

The layer aggregation IS the paper's active-message pattern:
`gather(src) → message → segment-combine(dst)`, and its transpose is the
same pattern the other way round: `gather(dst) → message →
segment-combine(src)`.  So a batch sorts its live edges twice when it is
built (`EdgeRoutes`), by dst for every forward combine and by src for
every backward one, and `propagate` is one autograd Function whose
forward and backward are each one gather into one `[E, D]` message buffer
and one launch of the combine kernel (`repro_torch.kernels.ops`): never a
float atomic, and never two message buffers alive at once.

Full-graph distributed training runs each layer's propagation through the
Agent-Graph exchange (`propagate_sharded`) over the stacked topology of
`repro_torch.core.dist_engine` and its communicator: local partial sums on
combiner slots + one exchange of the agents' values each way per layer.
With a `ProcessGroupComm` each rank holds its shard's rows, the loss's
normaliser is global (`gnn_loss(..., comm=)`), and `psum_shares` /
`psum_grads` sum the ranks' losses and the replicated parameters'
gradients in rank order.

Entry points build on CUDA unless the caller passes `device="cpu"`
(`init_gnn`, `params_from_numpy`, `GraphBatch.build`, `GraphBatch.to`);
asked for CUDA with no card present they raise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from repro_torch.configs.base import GNNConfig
from repro_torch.core.engine import resolve_device
from repro_torch.core.exchange import (_master_mask, flush_combiners,
                                       flush_routes)
from repro_torch.core.vertex_program import MONOIDS
from repro_torch.kernels import ops
from repro_torch.kernels.segment_combine import segment_row_pointer
from repro_torch.nn.layers import dense_init, mlp_apply, mlp_init


@dataclasses.dataclass
class EdgeRoutes:
    """The live edges of a batch (`edge_mask` set, `dst < num_nodes`) in
    stable dst-sorted order: their sources `src`, destinations `dst` and
    row pointer `seg_ptr`, their positions `perm` in the batch's edge
    arrays (to permute per-edge weights), and the backward's src-sorted
    route (`gather`: the order, sorted sources and row pointer) with the
    destinations in that order (`dst_by_src`).  Built once with the batch
    or topology."""

    src: torch.Tensor          # [n] int32
    dst: torch.Tensor          # [n] int32, ascending
    seg_ptr: torch.Tensor      # [num_nodes + 1] int32
    perm: torch.Tensor         # [n] int64
    gather: ops.GatherRoute    # over src, num_nodes rows
    dst_by_src: torch.Tensor   # [n] int32, dst[gather.order]
    num_nodes: int

    @staticmethod
    def build(src: torch.Tensor, dst: torch.Tensor, edge_mask: torch.Tensor,
              num_nodes: int) -> "EdgeRoutes":
        pos = torch.nonzero(edge_mask & (dst < num_nodes)).squeeze(1)
        dst_sorted, order = torch.sort(
            dst.index_select(0, pos).to(torch.int32), stable=True)
        perm = pos.index_select(0, order)
        src_sorted = src.index_select(0, perm).to(torch.int32)
        back = ops.GatherRoute.build(src_sorted, num_nodes)
        return EdgeRoutes(src_sorted, dst_sorted,
                          segment_row_pointer(dst_sorted, num_nodes), perm,
                          back, dst_sorted.index_select(0, back.order),
                          num_nodes)


def _scale_rows(rows: torch.Tensor, w: Optional[torch.Tensor]):
    """`rows * w` per row, in place."""
    if w is None:
        return rows
    return rows.mul_(w.to(rows.dtype).reshape((-1,) + (1,) * (rows.dim() - 1)))


class _Propagate(torch.autograd.Function):
    """`out[v] = Σ_{e: dst[e]=v} w[e]·h[src[e]]` over the routes' live
    edges, differentiable in `h`.  Forward: the messages gathered in dst
    order, scaled in place, combined (dense route).  Backward, its
    transpose: the output gradient gathered at each edge's dst in src
    order, scaled in place, combined over the src row pointer."""

    @staticmethod
    def forward(ctx, h, w, routes):
        ctx.routes = routes
        ctx.save_for_backward(w)
        msg = _scale_rows(h.index_select(0, routes.src), w)
        return ops.segment_combine(msg, routes.dst, routes.num_nodes, "sum",
                                   seg_ptr=routes.seg_ptr)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        r = ctx.routes
        (w,) = ctx.saved_tensors
        if w is not None:
            w = w.index_select(0, r.gather.order)
        rows = _scale_rows(grad.index_select(0, r.dst_by_src), w)
        return (ops.segment_combine(rows, r.gather.seg, r.num_nodes, "sum",
                                    seg_ptr=r.gather.seg_ptr), None, None)


def _as_tensor(a, device, dtype=None) -> Optional[torch.Tensor]:
    if a is None:
        return None
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.require(np.asarray(a),
                                        requirements=["C", "W"]))
    return a.to(device=device, dtype=dtype)


@dataclasses.dataclass
class GraphBatch:
    """Padded COO graph (single shard or a stacked slot space) and its
    routes.

    The fields are the JAX package's; `routes` (the sorted live edges) and
    `pool_ptr` (the row pointer of `graph_ids`, which must be sorted: a
    molecule batch lays its graphs out one after another) are built at
    construction unless given.
    """

    node_feats: torch.Tensor       # [V, F]
    src: torch.Tensor              # [E]
    dst: torch.Tensor              # [E]
    edge_mask: torch.Tensor        # [E] bool
    labels: torch.Tensor           # [V] int or [G] for graph tasks
    train_mask: torch.Tensor       # [V] bool
    edge_norm: Optional[torch.Tensor] = None   # [E] sym-norm coefficients
    graph_ids: Optional[torch.Tensor] = None   # [V] int32, sorted
    num_graphs: int = 1
    routes: Optional[EdgeRoutes] = None
    pool_ptr: Optional[torch.Tensor] = None    # [num_graphs + 1] int32

    def __post_init__(self):
        if self.routes is None:
            self.routes = EdgeRoutes.build(self.src, self.dst,
                                           self.edge_mask,
                                           self.node_feats.shape[0])
        if self.graph_ids is not None and self.pool_ptr is None:
            gid = self.graph_ids
            if gid.numel() > 1 and bool((gid[1:] < gid[:-1]).any()):
                raise ValueError("graph_ids must be sorted ascending (one "
                                 "graph's nodes together)")
            self.pool_ptr = segment_row_pointer(gid, self.num_graphs)

    @staticmethod
    def build(node_feats, src, dst, edge_mask, labels, train_mask,
              edge_norm=None, graph_ids=None, num_graphs: int = 1,
              device="cuda") -> "GraphBatch":
        """A batch on `device` from numpy arrays or tensors: features and
        norms float32, edge ids and graph ids int32, labels int64, masks
        bool; the routes are built there."""
        dev = resolve_device(device)
        return GraphBatch(
            node_feats=_as_tensor(node_feats, dev, torch.float32),
            src=_as_tensor(src, dev, torch.int32),
            dst=_as_tensor(dst, dev, torch.int32),
            edge_mask=_as_tensor(edge_mask, dev, torch.bool),
            labels=_as_tensor(labels, dev, torch.int64),
            train_mask=_as_tensor(train_mask, dev, torch.bool),
            edge_norm=_as_tensor(edge_norm, dev, torch.float32),
            graph_ids=_as_tensor(graph_ids, dev, torch.int32),
            num_graphs=num_graphs)

    def to(self, device) -> "GraphBatch":
        """The same batch on `device`, its routes rebuilt there."""
        return GraphBatch.build(
            self.node_feats, self.src, self.dst, self.edge_mask, self.labels,
            self.train_mask, self.edge_norm, self.graph_ids, self.num_graphs,
            device=device)


def propagate(h: torch.Tensor, src, dst, edge_mask, num_nodes: int,
              edge_weight: Optional[torch.Tensor] = None,
              routes: Optional[EdgeRoutes] = None) -> torch.Tensor:
    """Scatter-combine a feature matrix along edges (⊕ = sum), masked
    edges dropped, differentiable in `h` (`_Propagate`: one `[n, D]`
    message buffer and one combine-kernel launch each way).

    `routes` (built from `src`, `dst`, `edge_mask` when not given) orders
    the edges.  Edge weights are data: one that requires a gradient is
    refused.
    """
    if routes is None:
        routes = EdgeRoutes.build(src, dst, edge_mask, num_nodes)
    w = None
    if edge_weight is not None:
        if edge_weight.requires_grad:
            raise ValueError("propagate: edge weights are data; this one "
                             "requires a gradient")
        w = edge_weight.index_select(0, routes.perm)
    return _Propagate.apply(h, w, routes)


def engine_propagate(batch: GraphBatch):
    """Full-batch aggregation through the GRE engine itself.

    Builds a DevicePartition over the batch's live dst-sorted edges plus a
    `gnn_aggregate_program` with payload_shape = (D,), and returns
    `prop_fn(h, edge_weight)` whose single canonical superstep performs the
    layer propagation on the engine stack (its dense scan and combine
    kernel).  Forward only, as the JAX package uses it: it runs under
    `torch.no_grad()`.
    """
    from repro_torch.core.algorithms import gnn_aggregate_program
    from repro_torch.core.engine import DevicePartition, EngineState, GREEngine
    r = batch.routes
    V = int(batch.node_feats.shape[0])
    dev = batch.node_feats.device
    ones = torch.ones(r.dst.shape[0], dtype=torch.bool, device=dev)
    seg_ptr = segment_row_pointer(r.dst, V + 1)   # + the sink slot

    @torch.no_grad()
    def prop_fn(h, edge_weight):
        d = h.shape[-1]
        eng = GREEngine(gnn_aggregate_program(
            d, edge_weighted=edge_weight is not None), frontier="dense")
        props = ({"edge_norm": edge_weight.index_select(0, r.perm)}
                 if edge_weight is not None else {})
        part = DevicePartition(
            src=r.src, dst=r.dst, edge_mask=ones, num_masters=V,
            num_slots=V + 1, edges_sorted_by_dst=True, edge_props=props,
            aux={"out_degree": torch.zeros(V, device=dev)}, seg_ptr=seg_ptr,
            device=dev)
        sd = torch.zeros((V + 1, d), dtype=h.dtype, device=dev)
        sd[:V] = h
        active = torch.ones(V + 1, dtype=torch.bool, device=dev)
        active[V] = False
        state = EngineState(
            vertex_data=torch.zeros((V, d), dtype=h.dtype, device=dev),
            scatter_data=sd, active_scatter=active, step=0)
        return eng.superstep(part, state).vertex_data

    return prop_fn


# -------------------------------------------------- distributed propagation
@dataclasses.dataclass
class ShardRoutes:
    """The backward routes of `propagate_sharded` over one stacked
    `ShardTopology`, built once with it: the local edges (`EdgeRoutes`), the
    refresh's gathers (masters into the `[k, k, s_x]` send buffer, then the
    received entries that land) and the flush's (combiners into the
    `[k, k, c_x]` send buffer, then the flush route's order), and the
    master slots."""

    edges: EdgeRoutes
    scat_send: ops.GatherRoute       # of topo.scat_send, flat
    scat_recv: ops.GatherRoute       # of topo.scat_recv_pos
    comb_send: ops.GatherRoute       # of topo.comb_send, flat
    comb_recv: ops.GatherRoute       # of topo.comb_recv.order
    masters: torch.Tensor            # [num_slots] bool

    @staticmethod
    def build(topo) -> "ShardRoutes":
        part = topo.part
        if topo.comb_recv is None:
            raise ValueError("propagate_sharded needs the sync topology's "
                             "flush route (DistGREEngine with exchange "
                             "'agent' or 'dense')")
        n = part.num_slots
        comb_send, comb_recv = flush_routes(topo)
        return ShardRoutes(
            edges=EdgeRoutes.build(part.src, part.dst, part.edge_mask, n),
            scat_send=ops.GatherRoute.build(topo.scat_send.reshape(-1), n),
            scat_recv=ops.GatherRoute.build(topo.scat_recv_pos,
                                            topo.scat_send.numel()),
            comb_send=comb_send, comb_recv=comb_recv,
            masters=_master_mask(part))


def propagate_sharded(h_slots: torch.Tensor, topo, comm,
                      edge_weight: Optional[torch.Tensor] = None,
                      routes: Optional[ShardRoutes] = None) -> torch.Tensor:
    """Distributed propagation over the stacked Agent-Graph shards.

    h_slots: `[k_local·num_slots, F]` over the held shards, master
    features valid; agent slots are refreshed here (exchange 1), the local
    edges propagate, and the combiners' partials flush to their masters
    (exchange 2) through `comm` (`StackedComm` or `ProcessGroupComm`,
    whose `all_to_all` both carry gradient).  Returns the combined
    `[k_local·num_slots, F]` (masters valid).  `edge_weight` is per
    stacked edge, in the topology's edge order.  The exchanges' gathers are `gather_rows` and
    the local edges `propagate`, over `routes` (`ShardRoutes.build(topo)`
    when not given), so every backward runs the combine kernel.
    """
    r = routes if routes is not None else ShardRoutes.build(topo)
    payload = tuple(h_slots.shape[1:])
    sent = ops.gather_rows(h_slots, topo.scat_send.reshape(-1), r.scat_send)
    rec = comm.all_to_all(sent.reshape(tuple(topo.scat_send.shape) + payload))
    landed = ops.gather_rows(rec.reshape((-1,) + payload),
                             topo.scat_recv_pos, r.scat_recv)
    h = h_slots.index_copy(0, topo.scat_recv_slot, landed)
    part = topo.part
    combined = propagate(h, part.src, part.dst, part.edge_mask,
                         part.num_slots, edge_weight, routes=r.edges)
    flushed = flush_combiners(comm, combined, topo.comb_send, topo.comb_recv,
                              MONOIDS["sum"],
                              routes=(r.comb_send, r.comb_recv))
    mask = r.masters.reshape((-1,) + (1,) * len(payload))
    return torch.where(mask, combined, 0.0) + flushed


def shard_graph_batch(batch: GraphBatch, ag, topo, comm):
    """A single-card batch's graph laid over an agent graph's stacked
    shards: `(stacked_batch, prop_fn)` for `gnn_forward`/`gnn_loss`.

    Node rows move to their master slots of the shards `comm` holds
    (zeros, label 0 and no loss weight elsewhere); when the batch has an
    `edge_norm` it must be the GCN sym norm (`compute_gcn_edge_norm`),
    which is recomputed on the stacked edges from the batch's degrees.
    `ag` is the `AgentGraph` of the batch's graph, `topo` its sync stacked
    topology (of the held shards) on the engine's device; the batch may
    lie on another device, and only the held rows move.
    """
    degrees = None
    if batch.edge_norm is not None:
        V = batch.node_feats.shape[0]
        live = batch.edge_mask
        degrees = (torch.bincount(batch.src[live].long(), minlength=V),
                   torch.bincount(batch.dst[live].long(), minlength=V))
    return shard_node_rows(ag, topo, comm, batch.node_feats, batch.labels,
                           batch.train_mask, degrees)


def shard_node_rows(ag, topo, comm, node_feats, labels, train_mask,
                    degrees=None):
    """`shard_graph_batch` from the node rows alone: `node_feats [V, F]`,
    `labels [V]`, `train_mask [V]` in original ids, on any device, and for
    GCN's sym norm the graph's `(out_degree, in_degree) [V]` (None: no
    edge weight, as GIN).  A rank reads its own rows of these (they may be
    memory-mapped host arrays wrapped as tensors) and nothing of the edges
    beyond its agent graph."""
    from repro_torch.core.agent_graph import slot_to_original
    part = topo.part
    dev = part.device
    kl, cap, ns = len(comm.shards), ag.cap, ag.num_slots
    first = comm.shards[0]
    g = ag.old2new.astype(np.int64)
    shard = g // cap - first                     # held shard of each vertex
    held = (shard >= 0) & (shard < kl)
    mine = None if held.all() else np.flatnonzero(held)  # original ids held
    slots = torch.from_numpy(shard * ns + g % cap if mine is None
                             else shard[mine] * ns + g[mine] % cap).to(dev)

    def rows(x):
        x = torch.as_tensor(x)
        if mine is not None:
            x = x.index_select(0, torch.from_numpy(mine).to(x.device))
        picked = x.to(dev)
        out = torch.zeros((kl * ns,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=dev)
        return out.index_copy(0, slots, picked)

    routes = ShardRoutes.build(topo)
    norm = None
    if degrees is not None:
        dout, din = (torch.as_tensor(d).to(dev) for d in degrees)
        orig = torch.from_numpy(np.ascontiguousarray(
            slot_to_original(ag)[first:first + kl]).reshape(-1)).to(dev)
        osrc = orig.index_select(0, part.src.long()).clamp(min=0)
        odst = orig.index_select(0, part.dst.long()).clamp(min=0)
        norm = _sym_norm(dout, din, osrc, odst)
        norm = torch.where(part.edge_mask, norm, 0.0)
    stacked = GraphBatch(rows(node_feats), part.src, part.dst,
                         part.edge_mask, rows(labels), rows(train_mask),
                         edge_norm=norm, routes=routes.edges)

    def prop_fn(h, ew):
        return propagate_sharded(h, topo, comm, ew, routes)

    return stacked, prop_fn


def psum_shares(comm, x: torch.Tensor) -> torch.Tensor:
    """`x` summed over the processes of `comm` in rank order (`comm.psum`):
    a value of which each process holds its shards' share, as a rank's
    loss or a replicated parameter's gradient.  A communicator that holds
    every shard (`StackedComm`) holds the whole already, and its sum of
    the one row is `x` itself."""
    return comm.psum(x.unsqueeze(0))[0]


def psum_grads(params, comm) -> None:
    """Sum each parameter's `.grad` over the processes of `comm`
    (`psum_shares`), so every rank holds the gradient of the k-shard
    loss."""
    for p in parameters(params):
        if p.grad is not None:
            p.grad = psum_shares(comm, p.grad)


# ----------------------------------------------------------------- GCN / GIN
def _leaf(x: torch.Tensor) -> torch.Tensor:
    return x.detach().requires_grad_(True)


def init_gnn(generator: torch.Generator, cfg: GNNConfig, d_in: int,
             n_out: int, device="cuda"):
    """Random parameters drawn from `generator`, which must lie on
    `device`, with the JAX package's shapes and scales (`dense_init`,
    zero biases, GIN's eps 0): a tree of leaf tensors that require
    gradients."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, device {dev}")
    dims = [d_in] + [cfg.d_hidden] * cfg.n_layers
    layers = []
    for i in range(cfg.n_layers):
        if cfg.family == "gcn":
            layers.append({"w": dense_init(generator, dims[i], dims[i + 1]),
                           "b": torch.zeros((dims[i + 1],), device=dev)})
        else:  # gin: MLP per layer + learnable eps
            layers.append({
                "mlp": mlp_init(generator, [dims[i], dims[i + 1],
                                            dims[i + 1]]),
                "eps": (torch.zeros((), device=dev) if cfg.eps_learnable
                        else None)})
    params = {"layers": layers,
              "out": dense_init(generator, cfg.d_hidden, n_out),
              "out_b": torch.zeros((n_out,), device=dev)}
    return _map(_leaf, params)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return None if tree is None else fn(tree)


def params_from_numpy(tree, cfg: GNNConfig, device="cuda"):
    """The JAX package's `init_gnn` parameters, as numpy arrays in its
    tree (`None` for a fixed GIN eps), as the port's tree of float32 leaf
    tensors on `device` that require gradients."""
    if len(tree["layers"]) != cfg.n_layers:
        raise ValueError(f"{len(tree['layers'])} layers, config "
                         f"{cfg.n_layers}")
    return leaves_from_numpy(tree, device)


def leaves_from_numpy(tree, device="cuda"):
    """A tree of numpy arrays (dicts, lists, `None`) as the same tree of
    float32 leaf tensors on `device` that require gradients: the JAX
    package's parameters carried across."""
    dev = resolve_device(device)
    return _map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(
        dev).requires_grad_(True), tree)


def parameters(params) -> list:
    """The leaves of a parameter tree in the JAX package's flattening
    order (dict keys sorted, lists in order, `None` skipped): the order of
    `jax.tree.leaves` of the same tree."""
    if isinstance(params, dict):
        return [p for k in sorted(params) for p in parameters(params[k])]
    if isinstance(params, (list, tuple)):
        return [p for v in params for p in parameters(v)]
    return [] if params is None else [params]


def gnn_forward(params, batch: GraphBatch, cfg: GNNConfig,
                prop_fn=None) -> torch.Tensor:
    """Returns per-node logits [V, n_out] (or per-graph after pooling).

    `prop_fn(h, edge_weight) -> aggregated` abstracts local vs agent-sharded
    propagation; defaults to the batch's own routes.  Graph classification
    mean-pools the node rows over the sorted `graph_ids` with the combine
    kernel.
    """
    V = batch.node_feats.shape[0]
    if prop_fn is None:
        def prop_fn(h, ew):
            return propagate(h, batch.src, batch.dst, batch.edge_mask, V, ew,
                             routes=batch.routes)

    h = batch.node_feats
    for lp in params["layers"]:
        if cfg.family == "gcn":
            agg = prop_fn(h, batch.edge_norm)
            h = torch.relu(agg @ lp["w"] + lp["b"])
        else:  # GIN: h = MLP((1 + eps) h + sum_neighbors)
            agg = prop_fn(h, None)
            eps = lp["eps"] if lp["eps"] is not None else 0.0
            h = mlp_apply(lp["mlp"], (1.0 + eps) * h + agg, act=torch.relu,
                          final_act=True)
    if batch.graph_ids is not None:  # graph classification: mean-pool
        pooled = ops.segment_combine(h, batch.graph_ids, batch.num_graphs,
                                     "sum", seg_ptr=batch.pool_ptr)
        cnt = (batch.pool_ptr[1:] - batch.pool_ptr[:-1]).to(h.dtype)
        h = pooled / torch.clamp(cnt, min=1.0)[:, None]
    return h @ params["out"] + params["out_b"]


def gnn_loss(params, batch: GraphBatch, cfg: GNNConfig, prop_fn=None,
             comm=None):
    """Masked mean cross-entropy (all graphs for graph classification).
    The label pick is a select against the class index, so its backward
    is elementwise (no scatter).

    With a communicator (a batch of `shard_graph_batch`) the mean is over
    the training nodes of every shard, counted through `comm.psum`: a
    rank's loss is then its share of the k-shard loss, and the ranks'
    shares sum to it."""
    logits = gnn_forward(params, batch, cfg, prop_fn)
    if batch.graph_ids is not None:
        labels = batch.labels
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    else:
        labels, mask = batch.labels, batch.train_mask.to(torch.float32)
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    pick = labels.reshape(-1, 1) == torch.arange(
        logp.shape[-1], device=logp.device)
    ll = torch.where(pick, logp, 0.0).sum(-1)
    count = mask.sum()
    if comm is not None:     # per held shard, then over every shard
        held = mask.reshape(len(comm.shards), -1).sum(dim=1, keepdim=True)
        count = comm.psum(held)[0, 0]
    return -(ll * mask).sum() / torch.clamp(count, min=1.0)


# ------------------------------------------------- additional GNN families
def gat_layer_init(generator: torch.Generator, d_in: int, d_out: int,
                   n_heads: int = 1):
    return _map(_leaf, {
        "w": dense_init(generator, d_in, d_out * n_heads),
        "a_src": dense_init(generator, d_out, n_heads, scale=0.1),
        "a_dst": dense_init(generator, d_out, n_heads, scale=0.1)})


def gat_layer(params, h, src, dst, edge_mask, num_nodes, n_heads: int = 1,
              leaky_slope: float = 0.2):
    """Graph attention (GAT, arXiv:1710.10903) on scatter-combine:
    SDDMM edge scores → segment-SOFTMAX (max-combine + sum-combine — the
    engine's other two monoids) → weighted sum-combine.  The combines take
    the tile route (`dst` in any order); every gather and combine carries
    its gradient through the kernel."""
    V = num_nodes
    d_out = params["a_src"].shape[0]
    z = (h @ params["w"]).reshape(V, n_heads, d_out)           # [V, H, F]
    e_src = torch.einsum("vhf,fh->vh", z, params["a_src"])
    e_dst = torch.einsum("vhf,fh->vh", z, params["a_dst"])
    logits = ops.gather_rows(e_src, src) + ops.gather_rows(e_dst, dst)
    logits = torch.where(logits >= 0, logits, leaky_slope * logits)
    logits = torch.where(edge_mask[:, None], logits, -1e30)
    # numerically-stable segment softmax: ⊕=max then ⊕=sum
    mx = ops.tile_segment_combine(logits, dst, V, "max")
    p = torch.exp(logits - ops.gather_rows(
        torch.where(torch.isfinite(mx), mx, 0.0), dst))
    p = torch.where(edge_mask[:, None], p, 0.0)
    denom = ops.tile_segment_combine(p, dst, V, "sum")
    alpha = p / torch.clamp(ops.gather_rows(denom, dst), min=1e-9)
    msgs = ops.gather_rows(z, src) * alpha[:, :, None]
    out = ops.tile_segment_combine(msgs, dst, V, "sum")       # [V, H, F]
    return F.elu(out.reshape(V, n_heads * d_out))


def sage_layer_init(generator: torch.Generator, d_in: int, d_out: int):
    return _map(_leaf, {"w_self": dense_init(generator, d_in, d_out),
                        "w_nbr": dense_init(generator, d_in, d_out)})


def sage_layer(params, h, src, dst, edge_mask, num_nodes,
               aggregator: str = "mean"):
    """GraphSAGE (arXiv:1706.02216): mean or max neighbor aggregation, on
    the tile route."""
    V = num_nodes
    nbrs = ops.gather_rows(h, src)
    if aggregator == "mean":
        msgs = torch.where(edge_mask[:, None], nbrs, 0.0)
        s = ops.tile_segment_combine(msgs, dst, V, "sum")
        cnt = ops.tile_segment_combine(edge_mask.to(h.dtype), dst, V, "sum")
        agg = s / torch.clamp(cnt, min=1.0)[:, None]
    else:  # max
        neg = torch.where(edge_mask[:, None], nbrs, -1e30)
        agg = ops.tile_segment_combine(neg, dst, V, "max")
        agg = torch.where(torch.isfinite(agg), agg, 0.0)
    return torch.relu(h @ params["w_self"] + agg @ params["w_nbr"])


def _sym_norm(dout, din, src, dst):
    """`1/sqrt(dout[src]) · 1/sqrt(din[dst])`, degrees at least 1, in the
    JAX package's order of operations."""
    a = torch.clamp(dout.to(torch.float32), min=1.0).index_select(0, src)
    b = torch.clamp(din.to(torch.float32), min=1.0).index_select(0, dst)
    return 1.0 / torch.sqrt(a) * 1.0 / torch.sqrt(b)


def compute_gcn_edge_norm(src, dst, edge_mask, num_nodes):
    """Symmetric normalization 1/sqrt(deg_out(u) deg_in(v)) over the live
    edges (integer degree counts, exact)."""
    src, dst = src.long(), dst.long()
    dout = torch.bincount(src[edge_mask], minlength=num_nodes)
    din = torch.bincount(dst[edge_mask], minlength=num_nodes)
    return _sym_norm(dout, din, src, dst)
