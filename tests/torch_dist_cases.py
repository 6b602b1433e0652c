"""The rank side of tests/test_torch_dist_ranks.py: what each rank of a
`repro_torch.dist.world` runs, with the stacked counterpart the test holds
it against.  It imports neither `jax` nor `repro`, so the spawned ranks
load only the port.

Each rank writes `rank<r>.npz` (its results, by case) into the directory
it is given; the stacked functions return the same keys.
"""
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import algorithms
from repro_torch.core.agent_graph import build_agent_graph
from repro_torch.core.dist_engine import DistGREEngine
from repro_torch.dist.comm import StackedComm
from repro_torch.graph.generators import random_geometric_molecule, rmat_edges
from repro_torch.graph.structures import EdgeDelta, Graph
from repro_torch.models import autoint, dimenet, gnn
from repro_torch.nn.embedding import sharded_embedding_lookup
from repro_torch.serving import GraphQueryBatcher

from torch_parity import (BACKENDS, JAX_K, PROGRAMS, SOURCES4, make_program,
                          mutation_delta)

PR_STEPS, MAX_STEPS = 20, 300
TICK_EXCHANGES = ("agent", "pipelined")
TICKS = 12
INCREMENTAL = ("sssp", "bfs")
INC_FRAC, INC_SEED = 0.01, 3
GNN_ARCHS = ("gcn-cora", "gin-tu")
SERVE_KINDS = ("bfs", "sssp", "ppr")
SERVE_LANES = 4
# more queries than lanes (lanes recycle); query 2 gets a budget of 2
# supersteps and is evicted; the second wave is queued behind a delta
SERVE_FIRST = [0, 3, 17, 42, 99, 7, 55, 123, 200, 31]
SERVE_SECOND = [5, 77, 150, 9, 64, 250]


def inputs():
    """The agent graphs of the JAX k = 4 comparison (R-MAT scale 8, edge
    factor 8, seed 1, HDRF; CC on the undirected graph), the churn delta
    and the GNN's inputs: the graph with every seventh edge masked (its
    live edges as an agent graph, and the whole edge arrays with the mask
    for the whole-graph reference), features, labels and train mask
    (numpy seeds)."""
    g = rmat_edges(scale=8, edge_factor=8, seed=1, weights=True).dedup()
    ags = {False: build_agent_graph(g, "hdrf", JAX_K),
           True: build_agent_graph(g.as_undirected(), "hdrf", JAX_K)}
    delta = mutation_delta(g, INC_SEED, frac=INC_FRAC)
    gg = rmat_edges(scale=7, edge_factor=6, seed=0).dedup()
    rng = np.random.default_rng(0)
    v, e = gg.num_vertices, gg.num_edges
    mask = np.ones(e, bool)
    mask[::7] = False
    src, dst = gg.src.astype(np.int32), gg.dst.astype(np.int32)
    live = Graph(v, src[mask], dst[mask])
    dout = np.bincount(src[mask], minlength=v)
    din = np.bincount(dst[mask], minlength=v)
    gnn_in = {"ag": build_agent_graph(live, "hdrf", JAX_K),
              "src": src, "dst": dst, "mask": mask,
              "feats": rng.normal(size=(v, 12)).astype(np.float32) * 0.5,
              "labels": rng.integers(0, 2, v), "train": rng.random(v) < 0.5,
              "degrees": (dout, din)}
    return ags, delta, gnn_in


def _engine(name, backend, comm):
    exchange, opts = BACKENDS[backend]
    return DistGREEngine(make_program(algorithms, name), JAX_K,
                         exchange=exchange, device="cpu", comm=comm, **opts)


def program_case(ags, name, backend, comm):
    """One JAX_CASES run: `{vd, step, values}` (values: the entries this
    process put into the run's exchange collectives)."""
    _, _, source, undirected = PROGRAMS[name]
    eng = _engine(name, backend, comm)
    ag = ags[undirected]
    topo = eng.device_topology(ag)
    st = eng.init_state(ag, source=source)
    comm.values = 0
    out = eng.make_run(ag, PR_STEPS if name == "pagerank" else MAX_STEPS)(
        topo, st)
    return {"vd": eng.original_order(ag, out.vertex_data),
            "step": np.asarray(out.step), "values": np.asarray(comm.values)}


def tick_case(ags, exchange, comm):
    """BFS x4 served tick by tick (`make_superstep`, one superstep a tick,
    lane tracking on): every tick's global result and this process's
    `lane_active` rows, `[TICKS, ...]`."""
    eng = _engine("bfs_x4", exchange, comm)
    ag = ags[False]
    topo = eng.device_topology(ag)
    st = eng.init_state(ag, source=SOURCES4, lane_tracking=True)
    tick = eng.make_superstep(ag, steps_per_tick=1)
    vds, lanes = [], []
    for _ in range(TICKS):
        st = tick(topo, st)
        vds.append(eng.original_order(ag, st.vertex_data))
        lanes.append(st.lane_active.numpy())
    return {"vd": np.stack(vds), "lane_active": np.stack(lanes)}


def incremental_case(ags, delta, name, comm):
    """A cold run, then `rerun_incremental` of the churn delta from its
    fixed point: the rerun's result and supersteps."""
    _, _, source, _ = PROGRAMS[name]
    eng = _engine(name, "agent", comm)
    ag = ags[False]
    _, prev = eng.run(ag, source=source, max_steps=MAX_STEPS)
    _, vd, out, _ = eng.rerun_incremental(ag, prev, EdgeDelta(**delta),
                                          source=source, max_steps=MAX_STEPS)
    return {"vd": vd, "step": np.asarray(out.step)}


def gnn_case(gnn_in, arch, params_np, comm):
    """One GCN or GIN gradient pass through `propagate_sharded` over the
    shards `comm` holds: the k-shard loss and every parameter's gradient
    (summed over the ranks, `gnn.psum_grads`)."""
    cfg = get_config(arch)[0]
    ag = gnn_in["ag"]
    topo = DistGREEngine(algorithms.bfs_program(), ag.k, exchange="agent",
                         device="cpu", comm=comm).device_topology(ag)
    degrees = gnn_in["degrees"] if cfg.family == "gcn" else None
    batch, prop_fn = gnn.shard_node_rows(
        ag, topo, comm, torch.from_numpy(gnn_in["feats"]),
        torch.from_numpy(gnn_in["labels"]), torch.from_numpy(gnn_in["train"]),
        degrees=None if degrees is None else
        tuple(torch.from_numpy(d) for d in degrees))
    params = gnn.params_from_numpy(params_np, cfg, device="cpu")
    loss = gnn.gnn_loss(params, batch, cfg, prop_fn=prop_fn, comm=comm)
    loss.backward()
    gnn.psum_grads(params, comm)
    out = {"loss": gnn.psum_shares(comm, loss.detach()).numpy()}
    for i, p in enumerate(gnn.parameters(params)):
        out[f"grad{i}"] = p.grad.numpy()
    return out


def _serve_engine(kind, ag, comm):
    prog = {"bfs": algorithms.bfs_program, "sssp": algorithms.sssp_program,
            "ppr": algorithms.ppr_push_program}[kind](SERVE_LANES)
    opts = {"frontier": "dense"} if kind == "ppr" else {}
    return DistGREEngine(prog, ag.k, exchange="agent", device="cpu",
                         comm=comm, **opts)


def serving_case(ag, delta, kind, comm) -> dict:
    """A `GraphQueryBatcher` over the shards `comm` holds: the first wave
    (lanes recycled, query 2 evicted by its budget), then a second wave
    with a churn delta landing under "finish" while it is resident, and
    the waves after it on the mutated graph.  Every query's status,
    supersteps and result (`-1` rows for an evicted one), by uid."""
    b = GraphQueryBatcher(_serve_engine(kind, ag, comm), ag,
                          steps_per_tick=2)
    for i, s in enumerate(SERVE_FIRST):
        b.submit(s, max_supersteps=2 if i == 2 else None)
    b.run()
    for s in SERVE_SECOND[:3]:
        b.submit(s)
    b.pump()
    b.tick()                       # residents when the delta comes
    b.apply_delta(EdgeDelta(**delta), policy="finish")
    for s in SERVE_SECOND[3:]:
        b.submit(s)
    b.run()
    out = {}
    for q in b.finished:
        out[f"{q.uid}/status"] = np.asarray(q.status)
        out[f"{q.uid}/steps"] = np.asarray(q.supersteps_used)
        out[f"{q.uid}/result"] = (np.asarray(q.result)
                                  if q.result is not None
                                  else np.full(1, -1.0))
    out["host_reads"] = np.asarray(b.host_reads)
    return out


def serving_cases(ags, delta, comm) -> dict:
    """`serving_case` of every kind on the directed agent graph, keyed
    `<kind>/<field>`."""
    return {f"{kind}/{f}": v for kind in SERVE_KINDS
            for f, v in serving_case(ags[False], delta, kind, comm).items()}


def serving_rank_main(comm, ags, delta, out_dir) -> int:
    """A rank of the serving world: `serving_cases` to `rank<r>.npz`."""
    np.savez(Path(out_dir) / f"rank{comm.rank}.npz",
             **serving_cases(ags, delta, comm))
    return comm.rank


def all_cases(ags, delta, gnn_in, params, cases, comm) -> dict:
    """Every case on the shards `comm` holds, keyed `<case>/<field>`."""
    out = {}

    def put(prefix, rec):
        out.update({f"{prefix}/{f}": v for f, v in rec.items()})

    for name, backend in cases:
        put(f"{name}/{backend}", program_case(ags, name, backend, comm))
    for exchange in TICK_EXCHANGES:
        put(f"tick/{exchange}", tick_case(ags, exchange, comm))
    for name in INCREMENTAL:
        put(f"incremental/{name}", incremental_case(ags, delta, name, comm))
    for arch in GNN_ARCHS:
        put(f"gnn/{arch}", gnn_case(gnn_in, arch, params[arch], comm))
    return out


def stacked_cases(ags, delta, gnn_in, params, cases) -> dict:
    """`all_cases` on k = 4 shards stacked in this process."""
    return all_cases(ags, delta, gnn_in, params, cases, StackedComm(JAX_K))


def rank_main(comm, ags, delta, gnn_in, params, cases, out_dir) -> int:
    """A rank of the world: every case, written to `rank<r>.npz`."""
    out = all_cases(ags, delta, gnn_in, params, cases, comm)
    np.savez(Path(out_dir) / f"rank{comm.rank}.npz", **out)
    return comm.rank


# ------------------------------------------------ DimeNet over the shards
def molecule_inputs(n_graphs=6, n_atoms=12, n_edges=30, seed=0,
                    shuffle=False):
    """A union of `random_geometric_molecule` graphs (numpy seeds 0..),
    species in [0, 16), every ninth edge masked, targets, and the union's
    triplets padded by 7 at the end (`shuffle`: the live triplets in a
    random order, so `tri_ji` is unsorted)."""
    rng = np.random.default_rng(seed)
    pos, src, dst = [], [], []
    for g in range(n_graphs):
        p, s, d = random_geometric_molecule(n_atoms, n_edges, seed=g)
        pos.append(p)
        src.append(s + g * n_atoms)
        dst.append(d + g * n_atoms)
    src, dst = np.concatenate(src), np.concatenate(dst)
    kj, ji, tm = dimenet.build_triplets(src, dst, n_graphs * n_atoms)
    if shuffle:
        order = rng.permutation(kj.shape[0])
        kj, ji, tm = kj[order], ji[order], tm[order]
    pad = 7
    kj, ji = np.r_[kj, np.zeros(pad, np.int32)], np.r_[ji, np.zeros(pad, np.int32)]
    tm = np.r_[tm, np.zeros(pad, bool)]
    emask = np.ones(src.shape[0], bool)
    emask[::9] = False
    v = n_graphs * n_atoms
    return {"pos": np.concatenate(pos), "species":
            rng.integers(0, 16, v).astype(np.int32), "src": src, "dst": dst,
            "edge_mask": emask, "tri_kj": kj, "tri_ji": ji, "tri_mask": tm,
            "target": rng.normal(size=(v, 1)).astype(np.float32)}


def dimenet_sharded_case(mol, cfg, params_np, comm) -> dict:
    """`dimenet_forward_sharded` over the shards `comm` holds: the node
    outputs in original order, the MSE over every node (each process's
    share summed in rank order) and every parameter's gradient summed over
    the processes."""
    sh = dimenet.shard_molecule_graph(
        mol["pos"], mol["species"], mol["src"], mol["dst"],
        mol["edge_mask"], mol["tri_kj"], mol["tri_ji"], mol["tri_mask"],
        cfg, comm, device="cpu")
    params = dimenet.params_from_numpy(params_np, cfg, device="cpu")
    out = dimenet.dimenet_forward_sharded(params, sh, cfg)
    target = sh.node_rows(torch.from_numpy(mol["target"]))
    sq = torch.where(sh.node_masters[:, None], (out - target) ** 2, 0.0)
    loss = sq.sum() / mol["pos"].shape[0]
    loss.backward()
    gnn.psum_grads(params, comm)
    res = {"out": sh.original_order(out),
           "loss": gnn.psum_shares(comm, loss.detach()).numpy()}
    for i, p in enumerate(gnn.parameters(params)):
        res[f"grad{i}"] = p.grad.numpy()
    return res


def dimenet_rank_main(comm, mol, cfg, params_np, out_dir) -> int:
    np.savez(Path(out_dir) / f"rank{comm.rank}.npz",
             **dimenet_sharded_case(mol, cfg, params_np, comm))
    return comm.rank


# ------------------------------------------ AutoInt's row-sharded lookup
def autoint_sharded_case(table, ids, params_np, cfg, comm) -> dict:
    """The row-sharded lookup of `ids` over the shards of `table [N, d]`
    that `comm` holds, and AutoInt's logits through it."""
    rows = table.shape[0] // comm.k
    held = torch.from_numpy(table[comm.shards.start * rows:
                                  comm.shards.stop * rows]).reshape(
        len(comm.shards), rows, -1)
    ids_t = torch.from_numpy(ids)
    params = autoint.params_from_numpy(params_np, cfg, device="cpu")
    logits = autoint.autoint_logits(
        params, ids_t, cfg,
        lookup_fn=lambda _, i: sharded_embedding_lookup(held, i, comm))
    return {"lookup": sharded_embedding_lookup(held, ids_t, comm).numpy(),
            "logits": logits.detach().numpy()}


def autoint_rank_main(comm, table, ids, params_np, cfg, out_dir) -> int:
    np.savez(Path(out_dir) / f"rank{comm.rank}.npz",
             **autoint_sharded_case(table, ids, params_np, cfg, comm))
    return comm.rank


# --------------------------------------------- MoE, experts sharded over ranks
def moe_sharded_case(params_np, x, top_k, n_experts, cf, comm) -> dict:
    """`moe_ffn` with the experts split evenly over `comm`'s shards, each
    process holding its own: the whole output and the aux loss."""
    from repro_torch.nn.moe import moe_ffn
    e_loc = n_experts // comm.k
    shards = [{name: torch.from_numpy(a if name == "router" else
                                      a[s * e_loc:(s + 1) * e_loc])
               for name, a in params_np.items()} for s in comm.shards]
    out, aux = moe_ffn(shards, torch.from_numpy(x), top_k, n_experts, cf,
                       comm=comm)
    return {"out": out.numpy(), "aux": aux.numpy()}


def moe_rank_main(comm, params_np, x, top_k, n_experts, cf, out_dir) -> int:
    np.savez(Path(out_dir) / f"rank{comm.rank}.npz",
             **moe_sharded_case(params_np, x, top_k, n_experts, cf, comm))
    return comm.rank
