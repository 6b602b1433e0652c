"""The port's distributed engine (`repro_torch.core.dist_engine`, k shards
stacked on one device, here the CPU) against the JAX package.

1. Against the JAX single-shard `GREEngine`, in process: every backend
   (agent with overlap off and on, dense, pipelined, async at staleness
   1-3, null at k = 1) x SSSP, BFS (1 and 4 lanes), CC and PageRank (not
   async) x the dense, compact and auto frontiers.  Min programs must
   match bitwise, and take the same supersteps under the sync and
   pipelined backends (async reaches the same fixed point on another
   trajectory).  PageRank's two-stage ⊕ sums in another order: rtol 1e-5,
   atol 1e-6, the JAX package's own tolerance for it
   (tests/test_pipeline_overlap.py).
2. Against the JAX `DistGREEngine` at k = 4 on four simulated CPU devices:
   one module-scoped subprocess runs it and writes an `.npz`.  The sync
   backends on every program, pipelined and async on the min programs
   only (the JAX package's own PageRank differs between its backends in
   the last bit): min values bitwise and step counts equal, PageRank within
   the tolerance above.
3. The initial stacked state and the carry-across from the JAX package's
   arrays, and the refusals.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from repro.core import algorithms as jalg
from repro.core.agent_graph import build_agent_graph as jax_build
from repro.core.dist_engine import DistGREEngine as JaxDist
from repro.core.engine import DevicePartition as JaxPartition
from repro.core.engine import GREEngine as JaxEngine
from repro.graph.structures import Graph as JaxGraph
from repro_torch.core import algorithms
from repro_torch.core.agent_graph import build_agent_graph
from repro_torch.core.dist_engine import (DistGREEngine, original_order,
                                          stacked_from_arrays)
from repro_torch.graph.generators import rmat_edges

from torch_parity import state_arrays, to_graph

SRC = str(Path(__file__).resolve().parent.parent / "src")
K = 3
SOURCES4 = [0, 5, None, 77]
PR_STEPS, MAX_STEPS = 20, 300
PR_RTOL, PR_ATOL = 1e-5, 1e-6

PROGRAMS = {
    "sssp": (algorithms.sssp_program, jalg.sssp_program, 0, False),
    "bfs": (algorithms.bfs_program, jalg.bfs_program, 0, False),
    "bfs_x4": (lambda: algorithms.bfs_program(4),
               lambda: jalg.bfs_program(4), SOURCES4, False),
    "cc": (algorithms.cc_program, jalg.cc_program, None, True),
    "pagerank": (algorithms.pagerank_program, jalg.pagerank_program, None,
                 False),
}
BACKENDS = {
    "agent": ("agent", {}),
    "agent_overlap": ("agent", {"overlap": True}),
    "dense": ("dense", {}),
    "pipelined": ("pipelined", {}),
    "async_s1": ("async", {"staleness": 1}),
    "async_s2": ("async", {"staleness": 2}),
    "async_s3": ("async", {"staleness": 3}),
    "null": ("null", {}),
}
FRONTIERS = ("dense", "compact", "auto")


@pytest.fixture(scope="module")
def graphs():
    g = rmat_edges(scale=8, edge_factor=8, seed=1, weights=True).dedup()
    return g, g.as_undirected()


@pytest.fixture(scope="module")
def agent_graphs(graphs):
    """HDRF agent graphs of the directed and undirected graph at k = K and
    k = 1; the shards' combiner counts differ, so a slip in a shard's
    compact exchange space would show."""
    g, gu = graphs
    ags = {(u, k): build_agent_graph(x, "hdrf", k)
           for u, x in ((False, g), (True, gu)) for k in (1, K)}
    assert len(set(ags[False, K].num_combiner.tolist())) == K
    return ags


@pytest.fixture(scope="module")
def single_shard(graphs):
    """JAX single-shard results: name -> (vertex data, supersteps)."""
    refs = {}
    for name, (_, jmk, source, undirected) in PROGRAMS.items():
        g = graphs[1] if undirected else graphs[0]
        part = JaxPartition.from_graph(to_graph(g, JaxGraph))
        eng = JaxEngine(jmk())
        st = eng.run(part, eng.init_state(part, source=source),
                     max_steps=PR_STEPS if name == "pagerank" else MAX_STEPS)
        refs[name] = (np.asarray(st.vertex_data), int(st.step))
    return refs


def run_port(agent_graphs, name, backend, frontier, k):
    mk, _, source, undirected = PROGRAMS[name]
    exchange, kw = BACKENDS[backend]
    eng = DistGREEngine(mk(), k, exchange=exchange, frontier=frontier,
                        device="cpu", **kw)
    return eng.run(agent_graphs[undirected, k], source=source,
                   max_steps=PR_STEPS if name == "pagerank" else MAX_STEPS)


def hold(name, got, want):
    if name == "pagerank":
        np.testing.assert_allclose(got, want, rtol=PR_RTOL, atol=PR_ATOL)
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


MATRIX = [(n, b, f) for n in PROGRAMS for b in BACKENDS for f in FRONTIERS
          if not (n == "pagerank" and b.startswith("async"))]


@pytest.mark.parametrize("name,backend,frontier", MATRIX)
def test_backend_matches_single_shard(agent_graphs, single_shard, name,
                                      backend, frontier):
    k = 1 if backend == "null" else K
    got, st = run_port(agent_graphs, name, backend, frontier, k)
    want, steps = single_shard[name]
    hold(name, got, want)
    if not backend.startswith("async"):
        assert st.step == steps


# ------------------------------------------- against JAX's DistGREEngine
JAX_K = 4
JAX_BACKENDS = ("agent", "agent_overlap", "dense", "pipelined", "async_s2",
                "async_s3")
JAX_CASES = [(n, b) for n in PROGRAMS for b in JAX_BACKENDS
             if n != "pagerank" or b in ("agent", "agent_overlap", "dense")]

JAX_SCRIPT = r"""
import os, sys, time
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[1])
t0 = time.perf_counter()
import numpy as np
import jax
from repro.core import algorithms
from repro.core.agent_graph import build_agent_graph
from repro.core.dist_engine import DistGREEngine
from repro.graph.generators import rmat_edges

g = rmat_edges(scale=8, edge_factor=8, seed=1, weights=True).dedup()
ags = {False: build_agent_graph(g, "hdrf", 4),
       True: build_agent_graph(g.as_undirected(), "hdrf", 4)}
mesh = jax.make_mesh((4,), ("graph",))
programs = {"sssp": (algorithms.sssp_program, 0, False),
            "bfs": (algorithms.bfs_program, 0, False),
            "bfs_x4": (lambda: algorithms.bfs_program(4), SOURCES4, False),
            "cc": (algorithms.cc_program, None, True),
            "pagerank": (algorithms.pagerank_program, None, False)}
backends = BACKENDS
out = {}
for name, backend in CASES:
    mk, source, undirected = programs[name]
    exchange, kw = backends[backend]
    eng = DistGREEngine(mk(), mesh, ("graph",), exchange=exchange, **kw)
    res, st = eng.run(ags[undirected], source=source,
                      max_steps=20 if name == "pagerank" else 300)
    out[name + "/" + backend + "/vd"] = res
    out[name + "/" + backend + "/step"] = np.asarray(st.step)
from repro.core.dist_engine import _squeeze0
for ex in ("agent", "pipelined"):
    for strat in PLAN_STRATEGIES:
        eng = DistGREEngine(algorithms.sssp_program(), mesh, ("graph",),
                            exchange=ex, frontier=strat,
                            frontier_cap=PLAN_CAP)
        topo = eng.device_topology(ags[False])
        parts = ([topo.part] if ex == "agent"
                 else [topo.tiles.part_remote, topo.tiles.part_local])
        key = "plan/" + ex + "/" + strat
        out[key + "/cap"] = np.asarray(eng.plan.frontier_cap)
        out[key + "/strategy"] = np.asarray(eng.plan.strategy)
        for t, p in enumerate(parts):
            fp = eng.plan.frontier(_squeeze0(p))
            out[key + "/" + str(t) + "/kind"] = np.asarray(fp.kind)
            out[key + "/" + str(t) + "/caps"] = np.asarray(
                -1 if fp.caps is None else fp.caps)
np.savez(sys.argv[2], **out)
print("JAX_DIST_S", time.perf_counter() - t0)
"""


@pytest.fixture(scope="module")
def jax_dist(tmp_path_factory):
    """JAX `DistGREEngine` results at k = 4 (one subprocess: the simulated
    devices must be set before JAX starts)."""
    path = tmp_path_factory.mktemp("jax_dist") / "dist.npz"
    script = (JAX_SCRIPT.replace("SOURCES4", repr(SOURCES4))
              .replace("PLAN_STRATEGIES", repr(PLAN_STRATEGIES))
              .replace("PLAN_CAP", repr(PLAN_CAP))
              .replace("BACKENDS", repr({b: BACKENDS[b]
                                         for b in JAX_BACKENDS}))
              .replace("CASES", repr(JAX_CASES)))
    proc = subprocess.run([sys.executable, "-c", script, SRC, str(path)],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with np.load(path) as z:
        return dict(z)


@pytest.fixture(scope="module")
def agent_graphs_k4(graphs):
    g, gu = graphs
    return {(False, JAX_K): build_agent_graph(g, "hdrf", JAX_K),
            (True, JAX_K): build_agent_graph(gu, "hdrf", JAX_K)}


PLAN_CAP = 16
PLAN_STRATEGIES = ("dense", "flat", "compact")


@pytest.mark.parametrize("strategy", PLAN_STRATEGIES)
@pytest.mark.parametrize("exchange", ["agent", "pipelined"])
def test_explicit_frontier_cap_is_per_shard(jax_dist, agent_graphs_k4,
                                            exchange, strategy):
    """An explicit `frontier_cap` is each shard's capacity, as in the JAX
    `DistGREEngine`: the stacked plan holds k times it, and each partition
    the backend scans resolves to JAX's plan kind, a flat tile to k times
    JAX's per-shard capacity and a bucketed one to as many buckets."""
    eng = DistGREEngine(algorithms.sssp_program(), JAX_K, exchange=exchange,
                        frontier=strategy, frontier_cap=PLAN_CAP,
                        device="cpu")
    key = f"plan/{exchange}/{strategy}"
    assert eng.frontier_cap == int(jax_dist[key + "/cap"]) == PLAN_CAP
    assert eng.plan.frontier_cap == JAX_K * PLAN_CAP
    assert eng.plan.strategy == str(jax_dist[key + "/strategy"])
    topo = eng.device_topology(agent_graphs_k4[False, JAX_K])
    parts = ([topo.part] if exchange == "agent"
             else [topo.tiles.part_remote, topo.tiles.part_local])
    for t, part in enumerate(parts):
        fp = eng.plan.frontier(part)
        assert fp.kind == str(jax_dist[f"{key}/{t}/kind"])
        jcaps = jax_dist[f"{key}/{t}/caps"]
        if fp.kind == "flat":
            assert fp.caps == JAX_K * int(jcaps)
        elif fp.kind == "bucketed":
            assert len(fp.caps) == jcaps.shape[0]


@pytest.mark.parametrize("name,backend", JAX_CASES)
def test_backend_matches_jax_dist_engine(jax_dist, agent_graphs_k4, name,
                                         backend):
    got, st = run_port(agent_graphs_k4, name, backend, "auto", JAX_K)
    want = jax_dist[f"{name}/{backend}/vd"]
    steps = jax_dist[f"{name}/{backend}/step"]
    hold(name, got, want)
    assert np.all(steps == st.step)


# ------------------------------------------------ state and carry-across
def _jax_state(graphs, ag_t, **kw):
    """The JAX package's stacked initial state for the same agent graph
    (init_state reads no mesh: a one-device mesh serves any k)."""
    g = graphs[0]
    jag = jax_build(to_graph(g, JaxGraph), "hdrf", ag_t.k)
    mesh = jax.make_mesh((1,), ("graph",))
    prog = kw.pop("jprog")
    return jag, JaxDist(prog, mesh, ("graph",)).init_state(jag, **kw)


INIT_CASES = {
    "single": (algorithms.sssp_program, jalg.sssp_program, {"source": 7}),
    "all_active": (algorithms.cc_program, jalg.cc_program, {}),
    "pagerank": (algorithms.pagerank_program, jalg.pagerank_program, {}),
    "multi": (lambda: algorithms.bfs_program(4),
              lambda: jalg.bfs_program(4), {"source": SOURCES4}),
    "lane_tracking": (lambda: algorithms.bfs_program(4),
                      lambda: jalg.bfs_program(4),
                      {"source": SOURCES4, "lane_tracking": True}),
}


@pytest.mark.parametrize("case", sorted(INIT_CASES))
def test_init_state_equals_jax(graphs, agent_graphs, case):
    mk, jmk, kw = INIT_CASES[case]
    ag = agent_graphs[False, K]
    eng = DistGREEngine(mk(), K, device="cpu")
    st = eng.init_state(ag, **kw)
    _, jst = _jax_state(graphs, ag, jprog=jmk(), **kw)
    want = state_arrays(jst)
    for field in ("vertex_data", "scatter_data", "active_scatter"):
        w = want[field]
        np.testing.assert_array_equal(
            getattr(st, field).numpy(), w.reshape((-1,) + w.shape[2:]),
            err_msg=field)
    assert st.step == 0 and np.all(want["step"] == 0)
    if want["lane_active"] is None:
        assert st.lane_active is None
    else:
        np.testing.assert_array_equal(st.lane_active.numpy(),
                                      want["lane_active"])


@pytest.mark.parametrize("exchange", ["agent", "pipelined"])
def test_carry_across_from_jax_arrays(graphs, agent_graphs, exchange):
    """`stacked_from_arrays` rebuilds the port's graph, topology and state
    from the JAX package's AgentGraph and stacked EngineState; a run from
    them equals the port's own run."""
    ag = agent_graphs[False, K]
    jag, jst = _jax_state(graphs, ag, jprog=jalg.bfs_program(4),
                          source=SOURCES4)
    eng = DistGREEngine(algorithms.bfs_program(4), K, exchange=exchange,
                        device="cpu")
    ag2, topo, st = stacked_from_arrays(eng, vars(jag), state_arrays(jst))
    own = eng.init_state(ag, source=SOURCES4)
    for field in ("vertex_data", "scatter_data", "active_scatter"):
        assert torch.equal(getattr(st, field), getattr(own, field)), field
    out = eng.make_run(ag2, max_steps=MAX_STEPS)(topo, st)
    want, _ = eng.run(ag, source=SOURCES4, max_steps=MAX_STEPS)
    np.testing.assert_array_equal(out.vertex_data.numpy()[ag.old2new], want)


def test_topology_indices_equal_jax(graphs, agent_graphs):
    """The pipelined backend's compact exchange indices are JAX's, offset
    by each shard's block (padding sends to the identity slot c_pad)."""
    ag = agent_graphs[False, K]
    jag = jax_build(to_graph(graphs[0], JaxGraph), "hdrf", K)
    mesh = jax.make_mesh((1,), ("graph",))
    jt = JaxDist(jalg.bfs_program(), mesh, ("graph",),
                 exchange="pipelined").device_topology(jag)
    topo = DistGREEngine(algorithms.bfs_program(), K, exchange="pipelined",
                         device="cpu").device_topology(ag)
    off = (np.arange(K) * (ag.c_pad + 1))[:, None, None]
    np.testing.assert_array_equal(topo.tiles.comb_send.numpy(),
                                  np.asarray(jt.tiles.comb_send_compact)
                                  + off)
    recv = np.asarray(jt.tiles.comb_recv_master)      # [k, k, x] on j
    real = recv < ag.cap
    tgt = (recv + (np.arange(K) * (ag.cap + 1))[:, None, None])[real]
    assert sorted(topo.tiles.comb_recv.dst.tolist()) == sorted(tgt.tolist())
    assert topo.part.src is None and topo.part.device.type == "cpu"


@pytest.mark.parametrize("exchange", ["agent", "pipelined"])
def test_stacked_csr_is_csr_of_stacked_columns(agent_graphs, exchange):
    """The stacked partitions' CSR index, assembled from the shards' own,
    is `csr_layout` of the stacked columns, and its degree buckets are
    those of the stacked slot space."""
    from repro_torch.graph.structures import csr_layout, degree_buckets
    ag = agent_graphs[False, K]
    topo = DistGREEngine(algorithms.bfs_program(), K, exchange=exchange,
                         device="cpu").device_topology(ag)
    parts = ([topo.part] if exchange == "agent"
             else [topo.tiles.part_remote, topo.tiles.part_local])
    for part in parts:
        ptr, ex, deg = csr_layout(part.src.numpy(), part.edge_mask.numpy(),
                                  part.num_slots)
        np.testing.assert_array_equal(part.csr_indptr.numpy(), ptr)
        np.testing.assert_array_equal(part.csr_eidx.numpy(), ex)
        assert part.csr_max_deg == deg
        bid, sizes, max_degs = degree_buckets(ptr, part.num_slots)
        np.testing.assert_array_equal(part.bucket_id.numpy(), bid)
        assert (part.bucket_sizes, part.bucket_max_deg) == (sizes, max_degs)
        assert part.shards == K and part.num_masters == ag.cap


# ------------------------------------------------------------ refusals
def test_refusals(agent_graphs):
    pr, bfs = algorithms.pagerank_program(), algorithms.bfs_program()
    with pytest.raises(ValueError, match="monotone"):
        DistGREEngine(pr, K, exchange="async", device="cpu")
    with pytest.raises(ValueError, match="staleness"):
        DistGREEngine(bfs, K, exchange="async", staleness=0, device="cpu")
    with pytest.raises(ValueError, match="k == 1"):
        DistGREEngine(bfs, K, exchange="null", device="cpu")
    with pytest.raises(ValueError, match="exchange"):
        DistGREEngine(bfs, K, exchange="ring", device="cpu")
    with pytest.raises(ValueError, match="shards"):
        DistGREEngine(bfs, K + 1, device="cpu").run(agent_graphs[False, K],
                                                    source=0)
    eng = DistGREEngine(bfs, K, exchange="async", device="cpu")
    with pytest.raises(NotImplementedError):
        topo = eng.device_topology(agent_graphs[False, K])
        eng.make_exchange(topo).reduce(eng.local, topo.part, None)


def test_plan_phases(agent_graphs):
    """The engine's plan names the phase shape, which picks the backend and
    the topology's edge layout; the plan refuses a staleness that nothing
    would execute."""
    from repro_torch.core import exchange as ex
    from repro_torch.core.plan import SuperstepPlan
    bfs = algorithms.bfs_program()
    ag = agent_graphs[False, K]
    for exchange, kw, phases, backend in (
            ("agent", {}, "sync", ex.AgentExchange),
            ("agent", {"overlap": True}, "pipelined",
             ex.PipelinedAgentExchange),
            ("dense", {}, "sync", ex.DenseExchange),
            ("pipelined", {}, "pipelined", ex.PipelinedAgentExchange),
            ("async", {}, "async", ex.AsyncAgentExchange)):
        eng = DistGREEngine(bfs, K, exchange=exchange, staleness=3,
                            device="cpu", **kw)
        plan = eng.plan
        assert plan.phases == phases
        assert plan.staleness == (3 if phases == "async" else 0)
        topo = eng.device_topology(ag)
        assert type(eng.make_exchange(topo)) is backend
        assert (topo.tiles is None) == (phases == "sync")
        assert (topo.part.src is None) == (phases != "sync")
    with pytest.raises(ValueError, match="staleness"):
        SuperstepPlan(phases="async")
    with pytest.raises(ValueError, match="staleness"):
        SuperstepPlan(phases="sync", staleness=2)
    with pytest.raises(ValueError, match="phases"):
        SuperstepPlan(phases="ring")


def test_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: CUDA is a valid request here")
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DistGREEngine(algorithms.bfs_program(), K, **kw)
    assert DistGREEngine(algorithms.bfs_program(), K,
                         device="cpu").device.type == "cpu"


# ------------------------------------------------------------ incremental
MUT_BACKENDS = ("agent", "dense", "pipelined")
MUT_PROGRAMS = ("bfs", "sssp", "cc")


@pytest.fixture(scope="module")
def mutation_inputs():
    """Small directed and undirected graphs, their churn deltas, their HDRF
    agent graphs at k = 4 with slack in the pads (the fast path) and their
    hash agent graphs with tight pads (the compaction path), and the JAX
    single-shard cold results on the mutated graphs."""
    from repro.graph.structures import EdgeDelta as JaxDelta
    from torch_parity import mutation_delta
    g = rmat_edges(scale=7, edge_factor=4, seed=11, weights=True).dedup()
    gu = rmat_edges(scale=7, edge_factor=4, seed=5).dedup().as_undirected()
    out = {}
    for undirected, gg in ((False, g), (True, gu)):
        fields = mutation_delta(gg, seed=33 if undirected else 21,
                                frac=0.08, undirected=undirected)
        jg2 = to_graph(gg, JaxGraph).apply_edge_delta(JaxDelta(**fields))
        ags = {"fast": build_agent_graph(gg, "hdrf", JAX_K,
                                         pad_multiple=64),
               "compaction": build_agent_graph(gg, "hash", JAX_K)}
        out[undirected] = (fields, ags, JaxPartition.from_graph(jg2))
    return out


@pytest.mark.parametrize("path", ["fast", "compaction"])
@pytest.mark.parametrize("backend", MUT_BACKENDS)
@pytest.mark.parametrize("name", MUT_PROGRAMS)
def test_rerun_incremental_equals_cold(mutation_inputs, name, backend,
                                       path):
    """`rerun_incremental` at k = 4 with an explicit per-shard
    `frontier_cap` lands bitwise on the JAX package's cold single-shard
    result on the mutated graph (tests/test_conformance.py's mutation rows),
    through the delta ingress's fast path and its compaction."""
    from repro_torch.graph.structures import EdgeDelta
    mk, jmk, source, undirected = PROGRAMS[name]
    fields, ags, cold_part = mutation_inputs[undirected]
    ag = ags[path]
    eng = DistGREEngine(mk(), JAX_K, exchange=backend, frontier_cap=16,
                        device="cpu")
    _, prev = eng.run(ag, source=source, max_steps=MAX_STEPS)
    new_ag, got, out, report = eng.rerun_incremental(
        ag, prev, EdgeDelta(**fields), source=source, max_steps=MAX_STEPS)
    assert report.compacted == (path == "compaction")
    assert np.array_equal(new_ag.old2new, ag.old2new)
    jeng = JaxEngine(jmk())
    want = jeng.run(cold_part, jeng.init_state(cold_part, source=source),
                    MAX_STEPS)
    hold(name, got, np.asarray(want.vertex_data))
    assert set(eng.last_rerun_s) == {"apply_edge_delta", "warm_start_state",
                                     "device_topology", "run"}


def test_pagerank_warm_start_stacked(mutation_inputs):
    """PageRank's distributed warm start carries the stacked values forward
    and converges to the cold run's fixed point on the mutated graph."""
    from repro_torch.graph.structures import EdgeDelta
    fields, ags, cold_part = mutation_inputs[False]
    eng = DistGREEngine(algorithms.pagerank_program(), JAX_K, device="cpu")
    _, prev = eng.run(ags["fast"], max_steps=60)
    _, got, _, _ = eng.rerun_incremental(ags["fast"], prev,
                                         EdgeDelta(**fields), max_steps=60)
    jeng = JaxEngine(jalg.pagerank_program())
    want = jeng.run(cold_part, jeng.init_state(cold_part), 60)
    np.testing.assert_allclose(got, np.asarray(want.vertex_data), rtol=0,
                               atol=2e-3)


def test_serving_tick_refuses_async(agent_graphs):
    eng = DistGREEngine(algorithms.bfs_program(4), K, exchange="async",
                        device="cpu")
    with pytest.raises(ValueError, match="serving tick"):
        eng.make_superstep(agent_graphs[False, K])


@pytest.mark.parametrize("backend", ["pipelined", "agent_overlap",
                                     "async_s2", "agent"])
def test_split_tiles_pass_their_valid_lane_count(agent_graphs, monkeypatch,
                                                 backend):
    """Every tile-route call, on the split tiles' compact spaces as on the
    stacked slot space, carries its count of valid lanes, so the route
    never reads it back from the device; the plain route checks the count
    against the tile (a wrong one raises), so these runs prove that every
    real edge of a split tile lands inside its compact space."""
    from repro_torch.kernels import ops
    calls = []
    tile = ops.tile_segment_combine

    def record(msgs, dst, num_segments, op="sum", valid=None):
        calls.append((num_segments, valid))
        return tile(msgs, dst, num_segments, op, valid)

    monkeypatch.setattr(ops, "tile_segment_combine", record)
    ag = agent_graphs[False, K]
    got, _ = run_port(agent_graphs, "bfs_x4", backend, "compact", K)
    want = {K * (ag.c_pad + 1), K * (ag.cap + 1)}
    spaces = {n for n, _ in calls}
    assert calls and all(v is not None for _, v in calls)
    if backend != "agent":
        assert want <= spaces
    else:
        assert spaces == {K * ag.num_slots}
    _, want_state = run_port(agent_graphs, "bfs_x4", "agent", "dense", K)
    np.testing.assert_array_equal(got, original_order(
        ag, want_state.vertex_data))
