"""Dry-run cells: one `Cell` a (architecture x input shape), the
counterpart of `repro/launch/cells.py`.

A Cell carries the JAX package's analytic `meta` (MODEL_FLOPS and the
sizes the roofline reads, key for key and value for value: nothing runs
to make it) and `setup`, which, called on a device mesh under a
`FakeTensorMode` (`launch/dryrun.py`), makes one device's inputs as fake
tensors and returns the step: the port's own step on the rank's shards,
its collectives over the (fake) process group of the mesh.  Nothing is
allocated and no kernel launches: a kernel wrapper's shape route charges
its counts (`launch/roofline.py`).

The LM cells run `launch.train.train_step` (train) or `prefill` /
`decode_step` under the mesh's `DistCtx`, the shards of
`dist.sharding.lm_mesh_specs`.  The GNN, DimeNet and recsys cells run the
port's models on the Agent-Graph estimates JAX sizes them by
(`_agent_shape_estimates`) or on the batch shards over dp.
"""
from __future__ import annotations

import dataclasses
from math import prod
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs import get_config, get_shape
from repro_torch.configs.base import GNNConfig, LMConfig, LMShape
from repro_torch.dist import sharding as shd
from repro_torch.launch.mesh import mesh_axes
from repro_torch.models import transformer as tfm

R8 = lambda x: max(8, int(-(-x // 8) * 8))               # noqa: E731
R512 = lambda x: max(512, int(-(-x // 512) * 512))       # noqa: E731
# the device a fake tensor claims: autograd on fake CUDA tensors needs a
# torch built with CUDA; elsewhere they claim the meta device
DEV = "cuda" if torch.cuda.is_available() else "meta"


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    meta: Dict[str, Any]
    setup: Callable[[], Callable[[], Any]]


def _fake(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=DEV)


def _ids(shape) -> torch.Tensor:
    return _fake(shape, torch.int64)


def _sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


# ====================================================================== LM
def _lm_trips(cfg: LMConfig, S: int) -> Dict[str, int]:
    """The JAX package's scan trip counts of an LM step (roofline hints)."""
    trips = {}
    if (cfg.remat and cfg.n_layers % cfg.remat_block == 0
            and cfg.remat_block > 1):
        trips["outer"] = cfg.n_layers // cfg.remat_block
        trips["inner"] = cfg.remat_block
    else:
        trips["layers"] = cfg.n_layers
    if cfg.attention_impl == "chunked":
        trips["q_chunks"] = max(1, min(S, -(-S // cfg.q_chunk)))
        trips["kv_chunks"] = max(1, -(-S // cfg.kv_chunk))
    return trips


def lm_meta(cfg: LMConfig, shape: LMShape) -> Dict[str, Any]:
    n_active = cfg.active_param_count()
    B, S = shape.global_batch, shape.seq_len
    base = {"params": cfg.param_count(), "active_params": n_active}
    if shape.kind == "train":
        return {"model_flops": 6.0 * n_active * B * S, "tokens": B * S,
                **base, "scan_lengths": _lm_trips(cfg, S)}
    if shape.kind == "prefill":
        return {"model_flops": 2.0 * n_active * B * S, "tokens": B * S,
                **base, "scan_lengths": _lm_trips(cfg, S)}
    kv_bytes = (2 * cfg.n_layers * B * S * cfg.n_kv * cfg.d_head
                * cfg.param_dtype.itemsize)
    return {"model_flops": 2.0 * n_active * B
            + 4.0 * B * cfg.n_layers * cfg.n_heads * cfg.d_head * S,
            "tokens": B, **base, "kv_bytes": float(kv_bytes),
            "scan_lengths": {"layers": cfg.n_layers}}


def fake_lm(cfg: LMConfig, specs, mesh) -> tfm.LM:
    """An `LM` of fake tensors: the rank's block of each parameter under
    `specs` (whole ones without a mesh)."""
    coords = (shd.mesh_coords(mesh) if mesh is not None else {})
    sizes = _sizes(mesh) if mesh is not None else {}
    tensors: Dict[str, Any] = {}
    for name, (shape, dt) in tfm.param_shapes(cfg).items():
        if specs is not None:
            shape, _ = shd.local_shape(shape, specs[name], sizes, coords)
        tensors[name] = _fake(shape, dt)
    layers = []
    for i in range(cfg.n_layers):
        pre = f"layers.{i}."
        lt: Dict[str, Any] = {}
        for name, t in tensors.items():
            if name.startswith(pre):
                parts = name[len(pre):].split(".")
                if len(parts) == 1:
                    lt[parts[0]] = t
                else:
                    lt.setdefault(parts[0], {})[parts[1]] = t
        layers.append(tfm.Layer(lt))
    return tfm.LM(tensors["embed"], layers, tensors["ln_out"],
                  tensors.get("head"))


def _mesh_ctx(cfg: LMConfig, mesh, batch: int):
    """(ctx, storage specs) of a mesh, as `launch.train` sets them up; the
    local context and no specs on one device."""
    from repro_torch.launch import train
    if mesh is None or prod(mesh.shape) == 1:
        return tfm.LOCAL_CTX, None
    return train.mesh_context(cfg, mesh, batch)


def lm_train_setup(cfg: LMConfig, batch: int, seq: int, mesh,
                   steps: int = 2, lr: float = 3e-3):
    """`setup` of an LM training step at a global batch x seq on `mesh`:
    the rank's parameter blocks, an AdamW of `launch.train`'s settings
    with its moments made (as after a first step), the rank's rows of a
    batch; the step is `train.train_step`."""
    from repro_torch.launch import train
    from repro_torch.optim.adamw import AdamW, cosine_warmup

    def setup():
        ctx, specs = _mesh_ctx(cfg, mesh, batch)
        params = fake_lm(cfg, specs, mesh)
        named = dict(params.named_parameters())
        opt = AdamW(named.values(), lr=lr, schedule=cosine_warmup(10, steps),
                    sq_norm=(None if specs is None
                             else train.mesh_sq_norm(named, specs, ctx)))
        for p in named.values():      # the moments of a step after the first
            opt.state[p] = {"m": torch.zeros_like(p, dtype=torch.float32),
                            "v": torch.zeros_like(p, dtype=torch.float32)}
        rows = batch // ctx.dp_size if (ctx.mesh is not None
                                        and ctx.batch_over_dp) else batch
        data = {"tokens": _ids((rows, seq)),
                "labels": _ids((rows, seq))}

        def step():
            return train.train_step(params, named, opt, None, data, cfg,
                                    ctx, specs)
        return step
    return setup


def _lm_cell(arch, cfg: LMConfig, shape: LMShape, mesh) -> Cell:
    B, S = shape.global_batch, shape.seq_len
    meta = lm_meta(cfg, shape)
    if shape.kind == "train":
        return Cell(arch, shape.name, "train", meta,
                    lm_train_setup(cfg, B, S, mesh))

    def setup():
        ctx, specs = _mesh_ctx(cfg, mesh, B)
        params = fake_lm(cfg, specs, mesh)
        rows = (B // ctx.dp_size if ctx.mesh is not None
                and ctx.batch_over_dp else B)
        if shape.kind == "prefill":
            tokens = _ids((rows, S))
            return lambda: tfm.prefill(params, tokens, cfg, ctx)
        kv = params.layers[0].wk.shape[1] // cfg.d_head
        cache = {"k": _fake((cfg.n_layers, rows, S, kv, cfg.d_head),
                            cfg.param_dtype),
                 "v": _fake((cfg.n_layers, rows, S, kv, cfg.d_head),
                            cfg.param_dtype),
                 "len": _fake((rows,), torch.int32)}
        token = _ids((rows,))
        return lambda: tfm.decode_step(params, cache, token, cfg, ctx)
    return Cell(arch, shape.name, shape.kind, meta, setup)


# ====================================================================== GNN
def _agent_shape_estimates(V: int, E: int, K: int,
                           scatter_rate: float = 0.5) -> Dict[str, int]:
    """The JAX package's static Agent-Graph shapes for the dry run (no
    graph is built at 10^6+ scale here): masters a shard, padded edges,
    scatter and combiner agents (~2-4 agents a vertex on scale-free
    graphs, `scatter_rate` the paper's Fig. 12b skew) and the exchange
    widths."""
    cap = R8(-(-V // K))
    e_pad = R8(int(E / K * 1.25))
    agents = min(V - 1, 6 * cap)
    s_pad = R8(max(8, int(agents * max(scatter_rate, 0.1) * 1.25)))
    c_pad = R8(max(8, int(agents * max(1 - scatter_rate, 0.1) * 1.25)))
    s_x_pad = R8(max(8, (2 * s_pad) // K))
    c_x_pad = R8(max(8, (2 * c_pad) // K))
    return dict(cap=cap, e_pad=e_pad, s_pad=s_pad, c_pad=c_pad,
                s_x_pad=s_x_pad, c_x_pad=c_x_pad)


def _abstract_topo(est: Dict[str, int], K: int, with_weight: bool = False,
                   e_pad: Optional[int] = None):
    """One shard's `ShardTopology` of fake tensors at the estimated shapes
    (every received entry taken to land); `e_pad` overrides the edge
    columns' length."""
    from repro_torch.core.engine import DevicePartition
    from repro_torch.core.exchange import CombineRoute, ShardTopology
    cap = est["cap"]
    e = e_pad or est["e_pad"]
    s_x, c_x = est["s_x_pad"], est["c_x_pad"]
    slots = cap + est["s_pad"] + est["c_pad"] + 1
    i32, i64 = torch.int32, torch.int64
    part = DevicePartition(
        src=_fake((e,), i32), dst=_fake((e,), i32),
        edge_mask=_fake((e,), torch.bool), num_masters=cap, num_slots=slots,
        edges_sorted_by_dst=True,
        edge_props={"weight": _fake((e,))} if with_weight else {},
        aux={"out_degree": _fake((cap,)), "global_id": _fake((cap,))},
        seg_ptr=_fake((slots + 1,), i32), device=torch.device(DEV))
    return ShardTopology(
        part=part, scat_send=_fake((1, K, s_x), i64),
        scat_recv_pos=_fake((K * s_x,), i64),
        scat_recv_slot=_fake((K * s_x,), i64),
        comb_send=_fake((1, K, c_x), i64),
        comb_recv=CombineRoute(_fake((K * c_x,), i64), _fake((K * c_x,), i32),
                               _fake((slots + 1,), i32), slots))


def _gnn_flops(cfg: GNNConfig, V: int, E: int, d_in: int, T: int = 0):
    ch = cfg.d_hidden
    if cfg.family == "gcn":
        return 2.0 * (E * d_in + V * d_in * ch) + \
            2.0 * (cfg.n_layers - 1) * (E * ch + V * ch * ch)
    if cfg.family == "gin":
        f = 2.0 * (E * d_in + V * (d_in * ch + ch * ch))
        f += (cfg.n_layers - 1) * 2.0 * (E * ch + 2 * V * ch * ch)
        return f
    if cfg.family == "dimenet":
        per_block = 2.0 * T * ch * cfg.n_bilinear + 8.0 * E * ch * ch
        return cfg.n_layers * per_block + 4.0 * E * ch * cfg.n_radial
    if cfg.family == "mace":
        n_paths = 15  # valid (l1,l2,l3) for l_max=2
        per_layer = 2.0 * n_paths * E * ch * 27 + 6.0 * V * ch * ch \
            + 2.0 * n_paths * V * ch * 27 * 2
        return cfg.n_layers * per_layer
    raise ValueError(cfg.family)


def _fake_params(tree):
    """A parameter tree (made on the host under the fake mode) as leaf
    tensors on the fake device."""
    if isinstance(tree, dict):
        return {k: _fake_params(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fake_params(v) for v in tree)
    if tree is None:
        return None
    return tree.detach().to(DEV).requires_grad_(tree.requires_grad)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _adamw(params, lr):
    """The port's AdamW over `params` with its moments made (as after a
    first step)."""
    from repro_torch.optim.adamw import AdamW
    leaves = [p for p in _leaves(params) if p.requires_grad]
    opt = AdamW(leaves, lr=lr)
    for p in leaves:
        opt.state[p] = {"m": torch.zeros_like(p, dtype=torch.float32),
                        "v": torch.zeros_like(p, dtype=torch.float32)}
    return opt, leaves


def _sum_grads(leaves, group) -> None:
    """Each replicated parameter's gradient summed over `group`."""
    from repro_torch.dist import comm as dcomm
    for p in leaves:
        if p.grad is not None:
            p.grad = dcomm.group_all_reduce(p.grad, group)


def _init(model, cfg, *args):
    """A model's parameters drawn on the host (fake under the dry run's
    mode), then on the fake device."""
    gen = torch.Generator("cpu").manual_seed(0)
    return _fake_params(model(gen, cfg, *args, device="cpu"))


def _gnn_fullgraph_agent_cell(arch, cfg, shape, mesh) -> Cell:
    """GCN/GIN full-graph training through the Agent-Graph exchange: one
    shard a device, `propagate_sharded` over a `ProcessGroupComm` of every
    device, the loss's shares summed over them, the gradients too."""
    ax = mesh_axes(mesh)
    K = ax["n_devices"]
    est = _agent_shape_estimates(shape.n_nodes, shape.n_edges, K)
    d_in, n_out = shape.d_feat, cfg.n_classes
    meta = {"model_flops": 3.0 * _gnn_flops(cfg, shape.n_nodes,
                                            shape.n_edges, d_in),
            "nodes": shape.n_nodes, "edges": shape.n_edges,
            "agent_est": est, "exchange": "agent"}

    def setup():
        import torch.distributed as dist
        from repro_torch.dist.comm import ProcessGroupComm
        from repro_torch.models import gnn
        comm = ProcessGroupComm()
        topo = _abstract_topo(est, K)
        routes = gnn.ShardRoutes.build(topo)
        part = topo.part
        params = _init(gnn.init_gnn, cfg, d_in, n_out)
        opt, leaves = _adamw(params, 1e-2)
        batch = gnn.GraphBatch(
            _fake((part.num_slots, d_in)), part.src, part.dst,
            part.edge_mask, _ids((part.num_slots,)),
            _fake((part.num_slots,), torch.bool),
            edge_norm=_fake((est["e_pad"],)), routes=routes.edges)

        def prop(h, ew):
            return gnn.propagate_sharded(h, topo, comm, ew, routes)

        def step():
            loss = gnn.gnn_loss(params, batch, cfg, prop_fn=prop, comm=comm)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            _sum_grads(leaves, dist.group.WORLD)
            opt.step()
        return step
    return Cell(arch, shape.name, "train", meta, setup)


def _molecule(cfg, n, e, t, graphs=1):
    """A fake molecule batch of `graphs` graphs of n nodes, e edges and t
    triplets each, laid out one after another."""
    g = graphs
    out = {"pos": _fake((g * n, 3)), "species": _ids((g * n,)),
           "src": _fake((g * e,), torch.int32),
           "dst": _fake((g * e,), torch.int32),
           "edge_mask": _fake((g * e,), torch.bool),
           "target": _fake((g * n,))}
    if cfg.family == "dimenet":
        out.update({"tri_kj": _fake((g * t,), torch.int64),
                    "tri_ji": _fake((g * t,), torch.int64),
                    "tri_mask": _fake((g * t,), torch.bool)})
    return out


def _molecular_loss(params, cfg, b, prop_fn=None):
    from repro_torch.models import dimenet, mace
    if cfg.family == "dimenet":
        out = dimenet.dimenet_forward(params, b["pos"], b["species"],
                                      b["src"], b["dst"], b["edge_mask"],
                                      b["tri_kj"], b["tri_ji"],
                                      b["tri_mask"], cfg)
    else:
        out = mace.mace_forward(params, b["pos"], b["species"], b["src"],
                                b["dst"], b["edge_mask"], cfg,
                                prop_fn=prop_fn)
    return torch.mean((out[:, 0] - b["target"]) ** 2)


def _molecular_init(cfg):
    from repro_torch.models import dimenet, mace
    return _init(dimenet.init_dimenet if cfg.family == "dimenet"
                 else mace.init_mace, cfg)


def _gnn_fullgraph_spmd_cell(arch, cfg, shape, mesh) -> Cell:
    """DimeNet/MACE full graph.  MACE: the edges split over every device,
    the node aggregation summed over them (every device holds the node
    arrays).  DimeNet at this size (`full_graph_sm`) runs whole on every
    device: the port shards DimeNet through the Agent-Graph forward (the
    `ogb_products` cell), not GSPMD's `wsc` constraints."""
    ax = mesh_axes(mesh)
    K = ax["n_devices"]
    V, E = shape.n_nodes, shape.n_edges
    Vp, Ep = R512(V), R512(E)
    T = R512(min(16 * E, 2 ** 31 // 8))
    meta = {"model_flops": 3.0 * _gnn_flops(cfg, V, E, 3, T),
            "nodes": V, "edges": E, "triplets": T, "exchange": "spmd"}

    def setup():
        import torch.distributed as dist
        from repro_torch.dist import comm as dcomm
        params = _molecular_init(cfg)
        opt, leaves = _adamw(params, 1e-3)
        if cfg.family == "dimenet":
            b = _molecule(cfg, Vp, Ep, T)
            prop, sharded = None, False
        else:
            b = _molecule(cfg, Vp, R512(-(-Ep // K)), 0)

            def prop(m, dst):
                from repro_torch.kernels import ops
                local = ops.route_sum(m, ops.GatherRoute.build(
                    dst, Vp, mask=dst.long() < Vp))
                return dcomm.group_all_reduce(local, dist.group.WORLD)
            sharded = True

        def step():
            loss = _molecular_loss(params, cfg, b, prop)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            if sharded:
                _sum_grads(leaves, dist.group.WORLD)
            opt.step()
        return step
    return Cell(arch, shape.name, "train", meta, setup)


def _gnn_batched_cell(arch, cfg, shape, mesh, minibatch: bool) -> Cell:
    """minibatch_lg (one sampled subgraph a data shard) and molecule (128
    small graphs): batch-parallel over dp, the model replicated; a
    device's subgraphs run as one union graph, the gradients summed over
    the data group."""
    ax = mesh_axes(mesh)
    if minibatch:
        G = ax["dp_size"]
        seeds = shape.batch_nodes
        f1, f2 = shape.fanout
        n_sub = R8(seeds * (1 + f1 + f1 * f2))
        e_sub = R8(seeds * (f1 + f1 * f2))
        d_in = shape.d_feat
    else:
        G = shape.batch_graphs
        n_sub, e_sub, d_in = R8(shape.n_nodes), R8(shape.n_edges), 16
    T = R8(e_sub * 8)
    meta = {"model_flops": 3.0 * G * _gnn_flops(cfg, n_sub, e_sub, d_in, T),
            "subgraphs": G, "nodes_per": n_sub, "edges_per": e_sub}
    molecular = cfg.family in ("dimenet", "mace")

    def setup():
        from repro_torch.models import gnn
        local = max(1, G // ax["dp_size"])
        group = _groups(mesh).dp_group if ax["dp_size"] > 1 else None
        if molecular:
            params = _molecular_init(cfg)
            b = _molecule(cfg, n_sub, e_sub, T, graphs=local)
        else:
            params = _init(gnn.init_gnn, cfg, d_in, cfg.n_classes)
            n = local * n_sub
            graph = not minibatch
            batch = gnn.GraphBatch(
                _fake((n, d_in)), _fake((local * e_sub,), torch.int32),
                _fake((local * e_sub,), torch.int32),
                _fake((local * e_sub,), torch.bool),
                _ids((local if graph else n,)),
                _fake((local if graph else n,), torch.bool),
                edge_norm=_fake((local * e_sub,)),
                graph_ids=(_fake((n,), torch.int32) if graph else None),
                num_graphs=local if graph else 1)
        opt, leaves = _adamw(params, 1e-3)

        def step():
            loss = (_molecular_loss(params, cfg, b) if molecular
                    else gnn.gnn_loss(params, batch, cfg))
            opt.zero_grad(set_to_none=True)
            loss.backward()
            if group is not None:
                _sum_grads(leaves, group)
            opt.step()
        return step
    return Cell(arch, shape.name, "train", meta, setup)


def _groups(mesh) -> tfm.DistCtx:
    """The mesh's `DistCtx`, for its dp and tp groups."""
    ax = mesh_axes(mesh)
    return tfm.DistCtx(mesh=mesh, dp=ax["dp"], tp=ax["tp"])


def _dimenet_fullgraph_agent_cell(arch, cfg, shape, mesh) -> Cell:
    """DimeNet on `ogb_products`: both nested combines (triplet -> edge,
    edge -> node) through the Agent-Graph exchange
    (`dimenet_forward_sharded`), one shard a device, at the JAX package's
    estimates."""
    ax = mesh_axes(mesh)
    K = ax["n_devices"]
    V, E = shape.n_nodes, shape.n_edges
    T = min(16 * E, 2 ** 31 // 8)
    e_loc, v_loc, t_loc = (R512(-(-E // K)), R512(-(-V // K)),
                           R512(-(-T // K)))
    est_tri = dict(cap=e_loc, e_pad=8, s_pad=8,
                   c_pad=R512(min(e_loc, t_loc // 8)), s_x_pad=8,
                   c_x_pad=R8(max(8, 2 * min(e_loc, t_loc // 8) // K)))
    est_node = dict(cap=v_loc, e_pad=8, s_pad=8, c_pad=R512(2 * v_loc),
                    s_x_pad=8, c_x_pad=R8(max(8, 4 * v_loc // K)))
    meta = {"model_flops": 3.0 * _gnn_flops(cfg, V, E, 3, T),
            "nodes": V, "edges": E, "triplets": T,
            "exchange": "agent-2level",
            "est_tri": est_tri, "est_node": est_node}

    def setup():
        import types
        import torch.distributed as dist
        from repro_torch.core.exchange import flush_routes
        from repro_torch.dist.comm import ProcessGroupComm
        from repro_torch.kernels import ops
        from repro_torch.models import dimenet
        comm = ProcessGroupComm()
        topo_tri = _abstract_topo(est_tri, K, e_pad=t_loc)
        topo_node = _abstract_topo(est_node, K)
        slots = {n: e["cap"] + e["s_pad"] + e["c_pad"] + 1
                 for n, e in (("tri", est_tri), ("node", est_node))}
        i64 = torch.int64
        s_src, s_dst = _ids((e_loc,)), _ids((e_loc,))
        kj = _fake((t_loc,), i64)
        dst_slot = _fake((e_loc,), i64)
        real = _fake((e_loc,), torch.bool)
        sh = dimenet.ShardedMolecule(
            comm=comm,
            ag_tri=types.SimpleNamespace(num_slots=slots["tri"],
                                         cap=e_loc),
            ag_node=types.SimpleNamespace(num_slots=slots["node"],
                                          cap=v_loc),
            topo_tri=topo_tri, topo_node=topo_node, species_src=s_src,
            species_dst=s_dst, edge_mask=real,
            rbf=_fake((e_loc, cfg.n_radial)),
            sbf=_fake((t_loc, cfg.n_spherical * cfg.n_radial)),
            tri_kj_row=kj, tri_mask=_fake((t_loc,), torch.bool),
            routes={"kj": ops.GatherRoute.build(kj, e_loc),
                    "emb_src": ops.GatherRoute.build(s_src, 16),
                    "emb_dst": ops.GatherRoute.build(s_dst, 16),
                    "node": ops.GatherRoute.build(dst_slot, slots["node"],
                                                  mask=real),
                    "tri_flush": flush_routes(topo_tri),
                    "node_flush": flush_routes(topo_node)})
        target = _fake((v_loc,))
        params = _molecular_init(cfg)
        opt, leaves = _adamw(params, 1e-3)

        def step():
            out = dimenet.dimenet_forward_sharded(params, sh, cfg)
            err = ((out[:, 0] - target) ** 2).sum()
            loss = err / (v_loc * K)          # the rank's share
            opt.zero_grad(set_to_none=True)
            loss.backward()
            _sum_grads(leaves, dist.group.WORLD)
            opt.step()
        return step
    return Cell(arch, shape.name, "train", meta, setup)


def gnn_cell(arch, cfg: GNNConfig, shape, mesh) -> Cell:
    if shape.kind == "full_graph":
        if cfg.family in ("gcn", "gin"):
            return _gnn_fullgraph_agent_cell(arch, cfg, shape, mesh)
        if cfg.family == "dimenet" and shape.n_edges > 10_000_000:
            return _dimenet_fullgraph_agent_cell(arch, cfg, shape, mesh)
        return _gnn_fullgraph_spmd_cell(arch, cfg, shape, mesh)
    return _gnn_batched_cell(arch, cfg, shape, mesh,
                             minibatch=shape.kind == "minibatch")


# =================================================================== recsys
def recsys_cell(arch, cfg, shape, mesh) -> Cell:
    """AutoInt: the table's rows over tp (padded to divide), the lookup a
    `ProcessGroupComm` of the tp group (`sharded_embedding_lookup`), the
    batch over dp; retrieval scores candidates split over every device."""
    ax = mesh_axes(mesh)
    rows = cfg.total_rows()
    rows_pad = -(-rows // ax["tp_size"]) * ax["tp_size"]
    rps = rows_pad // ax["tp_size"]
    B = shape.batch
    flops_interact = (cfg.n_attn_layers *
                      (3 * cfg.n_sparse * cfg.embed_dim * cfg.d_attn * 2 +
                       2 * cfg.n_sparse ** 2 * cfg.d_attn * 2))
    N = -(-shape.n_candidates // 512) * 512
    if shape.kind == "train":
        meta = {"model_flops": 3.0 * B * flops_interact, "rows": rows,
                "batch": B}
    elif shape.kind == "serve":
        meta = {"model_flops": 1.0 * B * flops_interact, "rows": rows,
                "batch": B}
    else:
        meta = {"model_flops": 1.0 * flops_interact + 2.0 * N * cfg.d_attn,
                "candidates": N}

    def setup():
        import torch.distributed as dist
        from repro_torch.dist import comm as dcomm
        from repro_torch.dist.comm import ProcessGroupComm
        from repro_torch.models import autoint
        from repro_torch.nn.embedding import sharded_embedding_lookup
        ctx = _groups(mesh)
        comm = ProcessGroupComm(group=ctx.tp_group)
        gen = torch.Generator("cpu").manual_seed(0)
        # a one-row table drawn, then the rank's block of the padded one
        params = _fake_params(autoint.init_autoint(gen, dataclasses.replace(
            cfg, vocab_sizes=(1,) * cfg.n_sparse), "cpu"))
        params["table"] = _fake((rps, cfg.embed_dim)).requires_grad_()

        def lookup(table, ids):
            return sharded_embedding_lookup(table[None], ids, comm)
        local_b = B // ax["dp_size"] if B % ax["dp_size"] == 0 else B
        if shape.kind == "train":
            opt, leaves = _adamw(params, 1e-3)
            batch = {"ids": _ids((local_b, cfg.n_sparse)),
                     "labels": _ids((local_b,))}

            def step():
                loss = autoint.autoint_loss(params, batch, cfg,
                                            lookup_fn=lookup)
                opt.zero_grad(set_to_none=True)
                loss.backward()
                for p in leaves:
                    if p.grad is None:
                        continue
                    # the table's rows are the tp rank's: summed over dp
                    grp = (ctx.dp_group if p is params["table"]
                           else dist.group.WORLD)
                    p.grad = dcomm.group_all_reduce(p.grad, grp)
                opt.step()
            return step
        if shape.kind == "serve":
            ids = _ids((local_b, cfg.n_sparse))

            def serve():
                with torch.no_grad():
                    return autoint.autoint_logits(params, ids, cfg,
                                                  lookup_fn=lookup)
            return serve
        ids = _ids((1, cfg.n_sparse))
        cand = _fake((N // ax["n_devices"], cfg.d_attn))
        proj = _fake((cfg.n_sparse * cfg.d_attn, cfg.d_attn))

        def retrieval():
            with torch.no_grad():
                rep = autoint.interact(params, lookup(params["table"], ids),
                                       cfg)
                return cand @ (rep @ proj)[0]
        return retrieval
    return Cell(arch, shape.name, shape.kind, meta, setup)


# ============================================================ graph engine
def graph_superstep_setup(K: int, supersteps: int = 30):
    """(setup, meta) of the paper's PageRank on one shard of an estimated
    Agent-Graph of V = 2^26, E = 2^30 over K devices (the JAX package's
    weak-scaling family): `supersteps` canonical supersteps with the agent
    exchange over a `ProcessGroupComm` of every device."""
    V, E = 1 << 26, (1 << 26) * 16
    est = _agent_shape_estimates(V, E, K)
    meta = {"V": V, "E": E, "supersteps": supersteps, "agent_est": est}

    def setup():
        from repro_torch.core import algorithms
        from repro_torch.core.dist_engine import DistGREEngine
        from repro_torch.core.engine import EngineState
        from repro_torch.core.plan import execute_superstep
        from repro_torch.dist.comm import ProcessGroupComm
        topo = _abstract_topo(est, K)
        slots = topo.part.num_slots
        state = EngineState(vertex_data=_fake((est["cap"],)),
                            scatter_data=_fake((slots,)),
                            active_scatter=_fake((slots,), torch.bool),
                            step=0)
        eng = DistGREEngine(algorithms.pagerank_program(), K,
                            exchange="agent", device="cpu",
                            comm=ProcessGroupComm())
        backend = eng.make_exchange(topo)

        def step():
            s = state
            for _ in range(supersteps):
                s = execute_superstep(eng.local, topo.part, s, backend)
            return s
        return step
    return setup, meta


# =================================================================== factory
def build_cell(arch: str, shape_name: str, mesh) -> Cell:
    """The cell of `arch` x `shape_name` on `mesh` (a `DeviceMesh`; its
    `meta` needs only the mesh's axis names and sizes)."""
    cfg, family = get_config(arch)
    shape = get_shape(arch, shape_name)
    if family == "lm":
        return _lm_cell(arch, cfg, shape, mesh)
    if family == "gnn":
        return gnn_cell(arch, cfg, shape, mesh)
    if family == "recsys":
        return recsys_cell(arch, cfg, shape, mesh)
    raise ValueError(family)
