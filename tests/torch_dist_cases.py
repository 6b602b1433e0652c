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
from repro_torch.graph.generators import rmat_edges
from repro_torch.graph.structures import EdgeDelta, Graph
from repro_torch.models import gnn

from torch_parity import (BACKENDS, JAX_K, PROGRAMS, SOURCES4, make_program,
                          mutation_delta)

PR_STEPS, MAX_STEPS = 20, 300
TICK_EXCHANGES = ("agent", "pipelined")
TICKS = 12
INCREMENTAL = ("sssp", "bfs")
INC_FRAC, INC_SEED = 0.01, 3
GNN_ARCHS = ("gcn-cora", "gin-tu")


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
