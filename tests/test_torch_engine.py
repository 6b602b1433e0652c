"""The port's single-shard engine: exact oracles (networkx/numpy), as
`tests/test_engine.py` checks the JAX package, and parity with the JAX
`GREEngine` on the same graphs.

Tolerances: BFS, SSSP and CC are min programs whose messages are exact f32
sums, so they must match bitwise with equal step counts on every frontier
strategy.  PageRank sums in another order than XLA's `segment_sum`, so it
matches within rtol = atol = 1e-5.
"""
import networkx as nx
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import algorithms as jalg
from repro.core.engine import DevicePartition as JaxPartition
from repro.core.engine import EngineState as JaxState
from repro.core.engine import GREEngine as JaxEngine
from repro.graph.structures import Graph as JaxGraph
from repro_torch.core import algorithms
from repro_torch.core.engine import DevicePartition, EngineState, GREEngine
from repro_torch.graph.generators import ring_graph, rmat_edges
from repro_torch.kernels.segment_combine import LAUNCHES

from torch_parity import partition_arrays, state_arrays, to_graph

FRONTIERS = ["dense", "compact", "flat", "auto"]


@pytest.fixture(scope="module")
def graph():
    return rmat_edges(scale=8, edge_factor=8, seed=1, weights=True).dedup()


@pytest.fixture(scope="module")
def part(graph):
    return DevicePartition.from_graph(graph, device="cpu")


@pytest.fixture(scope="module")
def nxg(graph):
    g = nx.DiGraph()
    g.add_nodes_from(range(graph.num_vertices))
    for s, d, w in zip(graph.src, graph.dst, graph.edge_props["weight"]):
        g.add_edge(int(s), int(d), weight=float(w))
    return g


# ------------------------------------------------------------ exact oracles
def test_pagerank_matches_paper_formula(graph, part):
    """GRE's PageRank is the fixed point of Eq. 2 (non-normalized form)."""
    eng = GREEngine(algorithms.pagerank_program())
    out = eng.run(part, eng.init_state(part), max_steps=50)
    prv = np.ones(graph.num_vertices, np.float32)
    outdeg = np.maximum(graph.out_degree(), 1).astype(np.float32)
    for _ in range(50):
        s = np.zeros(graph.num_vertices, np.float32)
        np.add.at(s, graph.dst, (prv / outdeg)[graph.src])
        prv = 0.15 + 0.85 * s
    np.testing.assert_allclose(out.vertex_data.numpy(), prv, rtol=1e-4,
                               atol=1e-4)
    assert out.step == 50


def test_sssp_matches_dijkstra(graph, part, nxg):
    eng = GREEngine(algorithms.sssp_program())
    out = eng.run(part, eng.init_state(part, source=0), max_steps=300)
    dist = out.vertex_data.numpy()
    ref = np.full(graph.num_vertices, np.inf)
    for v, d in nx.single_source_dijkstra_path_length(
            nxg, 0, weight="weight").items():
        ref[v] = d
    assert np.array_equal(np.isinf(ref), np.isinf(dist))
    mask = ~np.isinf(ref)
    np.testing.assert_allclose(dist[mask], ref[mask], rtol=1e-6)


def test_sssp_halts_before_max_steps(part):
    eng = GREEngine(algorithms.sssp_program())
    out = eng.run(part, eng.init_state(part, source=0), max_steps=10_000)
    assert out.step < 10_000  # assert_to_halt terminated the BSP loop


def test_cc_matches_networkx(graph, nxg):
    part = DevicePartition.from_graph(graph.as_undirected(), device="cpu")
    eng = GREEngine(algorithms.cc_program())
    out = eng.run(part, eng.init_state(part), max_steps=500)
    label = out.vertex_data.numpy().astype(np.int64)
    for comp in nx.connected_components(nxg.to_undirected()):
        assert {label[v] for v in comp} == {min(comp)}


def test_bfs_matches_networkx(graph, part, nxg):
    eng = GREEngine(algorithms.bfs_program())
    out = eng.run(part, eng.init_state(part, source=0), max_steps=200)
    depth = out.vertex_data.numpy()
    ref = np.full(graph.num_vertices, np.inf)
    for v, d in nx.single_source_shortest_path_length(nxg, 0).items():
        ref[v] = d
    assert np.array_equal(np.where(np.isinf(ref), -1, ref),
                          np.where(np.isinf(depth), -1, depth))


def test_gas_equals_scatter_combine(part):
    """Paper §2.2: the fused one-sided path computes the same result as the
    two-phase GAS emulation with intermediate edge storage."""
    eng = GREEngine(algorithms.pagerank_program())
    st_sc = eng.init_state(part)
    st_gas = eng.init_state(part)
    edge_state = torch.zeros(part.src.shape[0])
    for _ in range(5):
        st_sc = eng.superstep(part, st_sc)
        st_gas, edge_state = eng.gas_superstep(part, st_gas, edge_state)
    np.testing.assert_allclose(st_sc.vertex_data.numpy(),
                               st_gas.vertex_data.numpy(), rtol=1e-6)


def test_degree_program(graph, part):
    eng = GREEngine(algorithms.degree_program())
    st = eng.superstep(part, eng.init_state(part))
    np.testing.assert_array_equal(st.vertex_data.numpy(),
                                  graph.in_degree().astype(np.float32))


def test_ring_sssp_exact_steps():
    """On a directed ring the frontier advances one vertex per superstep."""
    part = DevicePartition.from_graph(ring_graph(16, weights=True),
                                      device="cpu")
    eng = GREEngine(algorithms.sssp_program())
    out = eng.run(part, eng.init_state(part, source=0), max_steps=100)
    np.testing.assert_array_equal(out.vertex_data.numpy(),
                                  np.arange(16, dtype=np.float32))
    assert out.step == 16  # 15 improving supersteps + the quiet one


def test_empty_frontier_runs_no_superstep(part):
    eng = GREEngine(algorithms.bfs_program(4))
    st = eng.init_state(part, source=[None, -1, None, None])
    out = eng.run(part, st, max_steps=10)
    assert out.step == 0 and not bool(out.active_scatter.any())


def test_cpu_run_launches_no_kernel(part):
    before = dict(LAUNCHES)
    eng = GREEngine(algorithms.bfs_program(), frontier="compact")
    eng.run(part, eng.init_state(part, source=0), max_steps=50)
    assert LAUNCHES == before


@pytest.mark.parametrize("density", [0.0, 0.03, 0.4, 1.0])
def test_frontier_counts_match_numpy(part, density):
    """`frontier_counts`' live members and out-edge totals, overall and per
    degree bucket, equal a numpy count over the CSR degrees."""
    from repro_torch.core import frontier
    rng = np.random.default_rng(int(density * 100))
    active = rng.random(part.num_slots) < density
    got = frontier.frontier_counts(part, torch.from_numpy(active))
    deg = np.diff(part.csr_indptr.numpy()).astype(np.int64)
    bucket = part.bucket_id.numpy()
    assert got.live == int(active.sum())
    assert got.edges == int(deg[active].sum())
    nb = len(part.bucket_max_deg)
    assert got.members == tuple(int((active & (bucket == b)).sum())
                                for b in range(nb))
    assert got.bucket_edges == tuple(int(deg[active & (bucket == b)].sum())
                                     for b in range(nb))


@pytest.mark.parametrize("frontier", ["compact", "flat"])
def test_tile_route_gets_the_valid_lane_count(part, frontier, monkeypatch):
    """Every compacted tile reaches the tile route with its count of lanes
    routed to a segment, taken from the frontier counts (no sync of its
    own), and that count is the tile's."""
    from repro_torch.core import frontier as fr
    seen = []
    real = fr.kernel_ops.tile_segment_combine

    def spy(msgs, dst, num_segments, op, valid=None):
        seen.append((valid, int((dst < num_segments).sum())))
        return real(msgs, dst, num_segments, op, valid)

    monkeypatch.setattr(fr.kernel_ops, "tile_segment_combine", spy)
    eng = GREEngine(algorithms.bfs_program(), frontier=frontier)
    out = eng.run(part, eng.init_state(part, source=0), max_steps=50)
    dense = GREEngine(algorithms.bfs_program(), frontier="dense")
    want = dense.run(part, dense.init_state(part, source=0), max_steps=50)
    assert torch.equal(out.vertex_data, want.vertex_data)
    assert seen and all(v == n for v, n in seen), seen


# ------------------------------------------------------ parity with JAX
@pytest.fixture(scope="module")
def parts(graph):
    """(port, jax) partitions of the directed and the undirected graph."""
    out = {}
    for key, g in (("directed", graph), ("undirected", graph.as_undirected())):
        out[key] = (DevicePartition.from_graph(g, device="cpu"),
                    JaxPartition.from_graph(to_graph(g, JaxGraph)))
    return out


TRAVERSALS = {
    "bfs": ("directed", "bfs_program", 0),
    "sssp": ("directed", "sssp_program", 0),
    "cc": ("undirected", "cc_program", None),
}


def _run_both(parts, name, frontier, max_steps=300, use_pallas=False,
              args=(), source=None, **kw):
    key, prog, default_src = TRAVERSALS.get(name, ("directed", name, None))
    src = default_src if source is None else source
    tpart, jpart = parts[key]
    teng = GREEngine(getattr(algorithms, prog)(*args), frontier=frontier,
                     **kw)
    jeng = JaxEngine(getattr(jalg, prog)(*args), frontier=frontier,
                     use_pallas=use_pallas, **kw)
    assert tuple(teng.make_plan().frontier(tpart)) == \
        tuple(jeng.make_plan().frontier(jpart))
    tout = teng.run(tpart, teng.init_state(tpart, source=src), max_steps)
    jout = jeng.run(jpart, jeng.init_state(jpart, source=src), max_steps)
    return tout, jout


def _assert_bitwise(tout, jout):
    t, j = state_arrays(tout), state_arrays(jout)
    assert int(t["step"]) == int(j["step"])
    for k in ("vertex_data", "scatter_data", "active_scatter"):
        assert t[k].dtype == j[k].dtype, k
        assert t[k].tobytes() == j[k].tobytes(), k


@pytest.mark.parametrize("frontier", FRONTIERS)
@pytest.mark.parametrize("name", sorted(TRAVERSALS))
def test_traversal_bitwise_equal_jax(parts, name, frontier):
    _assert_bitwise(*_run_both(parts, name, frontier))


@pytest.mark.parametrize("name", sorted(TRAVERSALS))
def test_traversal_bitwise_equal_jax_pallas_compact(parts, name):
    """The JAX engine's Pallas tile combine (interpret mode) on the compact
    route gives the same bits as the port."""
    _assert_bitwise(*_run_both(parts, name, "compact", use_pallas=True))


@pytest.mark.parametrize("frontier", ["auto", "compact"])
@pytest.mark.parametrize("prog", ["bfs_program", "sssp_program"])
def test_multi_source_bitwise_equal_jax(parts, prog, frontier):
    """Eight payload lanes, three of them unseeded (None / -1)."""
    sources = [0, None, 5, -1, 17, 3, None, 40]
    _assert_bitwise(*_run_both(parts, prog, frontier, args=(8,),
                               source=sources))


def test_max_steps_cut_equal_jax(parts):
    tout, jout = _run_both(parts, "sssp", "compact", max_steps=3)
    assert tout.step == 3
    _assert_bitwise(tout, jout)


def test_pagerank_close_to_jax(parts):
    tout, jout = _run_both(parts, "pagerank_program", "auto", max_steps=30)
    assert tout.step == int(jout.step) == 30
    np.testing.assert_allclose(tout.vertex_data.numpy(),
                               np.asarray(jout.vertex_data),
                               rtol=1e-5, atol=1e-5)


ONE_STEP = {
    "bfs": ("bfs_program", (), 0, "compact"),
    "sssp": ("sssp_program", (), 0, "compact"),
    "cc": ("cc_program", (), None, "auto"),
    "bfs_x8": ("bfs_program", (8,), [0, None, 5, 9, 17, 3, -1, 40], "compact"),
    "pagerank": ("pagerank_program", (), None, "auto"),
}


@pytest.mark.parametrize("case", sorted(ONE_STEP))
def test_one_superstep_from_carried_state(parts, case):
    """An identical mid-run state (two JAX supersteps) carried into the port
    with `from_arrays`; one superstep in each package must agree."""
    prog, args, src, frontier = ONE_STEP[case]
    key = "undirected" if case == "cc" else "directed"
    jpart = parts[key][1]
    jeng = JaxEngine(getattr(jalg, prog)(*args), frontier=frontier)
    js = jeng.init_state(jpart, source=src)
    for _ in range(2):
        js = jeng.superstep(jpart, js)
    tpart = DevicePartition.from_arrays(*partition_arrays(jpart),
                                        device="cpu")
    teng = GREEngine(getattr(algorithms, prog)(*args), frontier=frontier)
    ts = EngineState.from_arrays(state_arrays(js), device="cpu")
    assert ts.step == 2
    tnext = teng.superstep(tpart, ts)
    jnext = jeng.superstep(jpart, JaxState(
        *(jnp.asarray(a) if a is not None else None
          for a in state_arrays(js).values())))
    if case == "pagerank":
        np.testing.assert_allclose(tnext.vertex_data.numpy(),
                                   np.asarray(jnext.vertex_data),
                                   rtol=1e-5, atol=1e-5)
        assert tnext.step == int(jnext.step)
    else:
        _assert_bitwise(tnext, jnext)


def test_calibrated_cap_matches_jax(parts):
    tpart, jpart = parts["directed"]
    teng = GREEngine(algorithms.bfs_program(), frontier="compact")
    jeng = JaxEngine(jalg.bfs_program(), frontier="compact")
    th = teng.calibrate_frontier_cap(tpart, teng.init_state(tpart, source=0),
                                     probe_steps=3)
    jh = jeng.calibrate_frontier_cap(jpart, jeng.init_state(jpart, source=0),
                                     probe_steps=3)
    assert th == jh and teng.frontier_cap == jeng.frontier_cap


# --------------------------------------- overflow and sparse-frontier cases
def _star_graph(n: int):
    """Hub 0 -> every leaf, every leaf -> hub (so leaves scatter too)."""
    src = np.zeros(n - 1, dtype=np.int64)
    dst = np.arange(1, n, dtype=np.int64)
    from repro_torch.graph.structures import Graph
    return Graph(n, np.concatenate([src, dst]), np.concatenate([dst, src]))


def test_bucket_overflow_mixed_branches_equal_dense_and_jax(monkeypatch):
    """One bucket exceeds its cap while the hub's bucket stays compact: the
    overflowing bucket's partial comes from the restricted dense scan, and
    the total equals the dense scan and the JAX bucketed combine bitwise."""
    from repro.core.frontier import bucketed_scatter_combine as jax_bucketed
    from repro_torch.core import frontier
    n = 300  # hub degree 299 and 299 leaves of degree 1: two buckets
    g = _star_graph(n)
    part = DevicePartition.from_graph(g, device="cpu")
    jpart = JaxPartition.from_graph(to_graph(g, JaxGraph))
    caps = frontier.bucket_caps(part.bucket_sizes, 8)
    leaves_b, hub_b = int(part.bucket_id[1]), int(part.bucket_id[0])
    assert part.bucket_sizes[leaves_b] > caps[leaves_b]
    assert part.bucket_sizes[hub_b] <= caps[hub_b]
    prog = algorithms.bfs_program()
    eng = GREEngine(prog, frontier="dense")
    st0 = eng.init_state(part)
    sd = st0.scatter_data.clone()
    sd[:n] = torch.arange(n, dtype=torch.float32)
    active = torch.zeros(part.num_slots, dtype=torch.bool)
    active[:n] = True
    state = EngineState(st0.vertex_data, sd, active, 0)
    calls = []
    real = frontier.dense_masked_combine
    monkeypatch.setattr(frontier, "dense_masked_combine",
                        lambda *a: calls.append(1) or real(*a))
    counts = frontier.frontier_counts(part, active)
    got = frontier.bucketed_scatter_combine(prog, part, state,
                                            part.num_slots, caps,
                                            counts.members,
                                            counts.bucket_edges)
    assert calls == [1]                      # only the leaves' bucket
    dense = eng.dense_scatter_combine(part, state, part.num_slots)
    assert torch.equal(got, dense)
    jstate = JaxState(*(jnp.asarray(a) if a is not None else None
                        for a in state_arrays(state).values()))
    want = jax_bucketed(jalg.bfs_program(), jpart, jstate, part.num_slots,
                        caps)
    assert got.numpy().tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("frontier", ["compact", "flat"])
@pytest.mark.parametrize("case", ["star", "circulant"])
def test_small_cap_runs_bitwise_equal_jax(case, frontier):
    """Small capacities force the whole-frontier overflow (star: the hub
    activates every leaf at once) and per-superstep switches between the
    compacted and dense branches (circulant, SSSP)."""
    if case == "star":
        g, prog, cap = _star_graph(200), "bfs_program", 8
    else:
        from repro_torch.graph.generators import circulant_graph
        g, prog, cap = (circulant_graph(512, degree=8, weights=True, seed=1),
                        "sssp_program", 16)
    tpart = DevicePartition.from_graph(g, device="cpu")
    jpart = JaxPartition.from_graph(to_graph(g, JaxGraph))
    teng = GREEngine(getattr(algorithms, prog)(), frontier=frontier,
                     frontier_cap=cap)
    jeng = JaxEngine(getattr(jalg, prog)(), frontier=frontier,
                     frontier_cap=cap)
    tout = teng.run(tpart, teng.init_state(tpart, source=3), 300)
    jout = jeng.run(jpart, jeng.init_state(jpart, source=3), 300)
    _assert_bitwise(tout, jout)
