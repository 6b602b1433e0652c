"""The port's graph-query serving (`repro_torch.serving.graph_scheduler`)
against the JAX package's on the same streams, and its own invariants.

Tolerances: BFS and SSSP are min programs of exact f32 sums, so served
results equal the JAX package's null-backend batcher and fresh single runs
bitwise.  PPR sums float residuals: within the port a recycled lane equals
a fresh one bitwise (the dense scan folds in a fixed order), and it equals
the JAX package's within 1e-6, since XLA sums in another order.  The agent
and pipelined backends at k = 4 are held against the port's own null
results (the JAX package's distributed admission is broken under its JAX
version: ROADMAP Queue 3): min programs bitwise, PPR within 1e-6.
"""
import numpy as np
import pytest

from repro.core import algorithms as jalg
from repro.core.engine import DevicePartition as JaxPartition
from repro.core.engine import GREEngine as JaxEngine
from repro.graph.structures import EdgeDelta as JaxDelta
from repro.graph.structures import Graph as JaxGraph
from repro.serving import GraphQueryBatcher as JaxBatcher
from repro.serving.graph_scheduler import _percentile as jax_percentile
from repro.serving.graph_scheduler import poisson_ticks as jax_poisson
from repro_torch.core import algorithms
from repro_torch.core.agent_graph import build_agent_graph
from repro_torch.core.dist_engine import DistGREEngine
from repro_torch.core.engine import DevicePartition, GREEngine
from repro_torch.graph.generators import circulant_graph, rmat_edges
from repro_torch.graph.structures import EdgeDelta
from repro_torch.serving import (GraphQueryBatcher, ServingFrontend,
                                 poisson_ticks)
from repro_torch.serving.graph_scheduler import _percentile

from torch_parity import to_graph

D = 4
K = 4
SOURCES = [0, 3, 17, 42, 99, 7, 55, 123]
PROGRAMS = {   # kind -> (port factory, JAX factory, engine options)
    "bfs": (lambda: algorithms.bfs_program(D),
            lambda: jalg.bfs_program(D), {}),
    "sssp": (lambda: algorithms.sssp_program(D),
             lambda: jalg.sssp_program(D), {}),
    "ppr": (lambda: algorithms.ppr_push_program(D),
            lambda: jalg.ppr_push_program(D), {"frontier": "dense"}),
}
PPR_ATOL = 1e-6


def _fix(x):
    return np.nan_to_num(np.asarray(x), posinf=-1.0)


@pytest.fixture(scope="module")
def rmat():
    return rmat_edges(scale=8, edge_factor=6, seed=3, weights=True).dedup()


@pytest.fixture(scope="module")
def ring():
    return circulant_graph(128, degree=2, weights=True, seed=0)


def batcher(kind, g, backend="null", **kw):
    """A port batcher over `g` on the single shard or k = 4 stacked HDRF
    shards."""
    mk, _, opts = PROGRAMS[kind]
    if backend == "null":
        return GraphQueryBatcher(GREEngine(mk(), **opts),
                                 DevicePartition.from_graph(g, device="cpu"),
                                 **kw)
    eng = DistGREEngine(mk(), K, exchange=backend, device="cpu", **opts)
    return GraphQueryBatcher(eng, build_agent_graph(g, "hdrf", K), **kw)


def fresh(kind, g, source, backend="null"):
    """The query served alone in a fresh batcher."""
    b = batcher(kind, g, backend)
    b.submit(source)
    (q,) = b.run()
    return q.result


def hold(kind, got, want):
    if kind == "ppr":
        np.testing.assert_allclose(got, want, rtol=0, atol=PPR_ATOL)
    else:
        assert np.array_equal(_fix(got), _fix(want))


def test_poisson_ticks_and_percentile_equal_jax():
    for rate in (0.5, 2.0, 7.0):
        assert np.array_equal(
            poisson_ticks(40, rate, np.random.default_rng(3)),
            jax_poisson(40, rate, np.random.default_rng(3)))
    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 19, 100):
        vals = sorted(rng.normal(size=n).tolist())
        for q in (0.0, 0.5, 0.95, 0.99, 1.0):
            got, want = _percentile(vals, q), jax_percentile(vals, q)
            assert got == want or (np.isnan(got) and np.isnan(want))


@pytest.mark.parametrize("kind", sorted(PROGRAMS))
def test_null_backend_equals_jax(rmat, kind):
    """The same stream through the port's and the JAX package's null-backend
    batchers: the same lanes, supersteps and results; every finished query
    also equals a fresh single run (a recycled lane equals a fresh one)."""
    _, jmk, opts = PROGRAMS[kind]
    b = batcher(kind, rmat)
    jb = JaxBatcher(JaxEngine(jmk(), **opts),
                    JaxPartition.from_graph(to_graph(rmat, JaxGraph)))
    for s in SOURCES:
        b.submit(s)
        jb.submit(s)
    done, jdone = b.run(), jb.run()
    assert [q.status for q in done] == ["done"] * len(SOURCES)
    assert [(q.source, q.lane, q.supersteps_used) for q in done] == \
        [(q.source, q.lane, q.supersteps_used) for q in jdone]
    assert b.ticks == jb.ticks
    for q, jq in zip(done, jdone):
        assert q.result.dtype == np.float32
        hold(kind, q.result, jq.result)
        assert np.array_equal(_fix(q.result),
                              _fix(fresh(kind, rmat, q.source))), q.uid
    if kind == "ppr":
        assert all(q.result[q.source] > 0 for q in done)
    assert b.host_reads == b.ticks + 1 + len(SOURCES)


@pytest.mark.parametrize("backend", ["agent", "pipelined"])
@pytest.mark.parametrize("kind", sorted(PROGRAMS))
def test_stacked_backends_equal_null(rmat, kind, backend):
    """k = 4 stacked shards serve the stream with the null backend's
    results; a recycled lane there equals a fresh one too."""
    b = batcher(kind, rmat, backend)
    null = batcher(kind, rmat)
    for s in SOURCES:
        b.submit(s)
        null.submit(s)
    done = b.run()
    want = {q.source: q.result for q in null.run()}
    assert [q.status for q in done] == ["done"] * len(SOURCES)
    for q in done:
        hold(kind, q.result, want[q.source])
    last = done[-1]
    assert np.array_equal(_fix(last.result),
                          _fix(fresh(kind, rmat, last.source, backend)))


@pytest.mark.parametrize("backend", ["null", "agent", "pipelined"])
def test_budget_eviction_keeps_neighbors_intact(ring, backend):
    """A query over its superstep budget is evicted (no result) and its lane
    reset, without corrupting the queries in the other lanes."""
    b = batcher("bfs", ring, backend)
    victims = [b.submit(s) for s in (0, 31)]
    doomed = b.submit(64, max_supersteps=3)      # ring eccentricity >> 3
    late = b.submit(97)                          # recycles the evicted lane
    b.run()
    assert doomed.status == "evicted" and doomed.result is None
    for q in victims + [late]:
        assert q.status == "done"
        assert np.array_equal(_fix(q.result),
                              _fix(fresh("bfs", ring, q.source)))


def test_unconverged_lane_never_retired(ring):
    b = batcher("bfs", ring)
    q = b.submit(0)
    b.run()
    depths = _fix(q.result)
    assert int(depths.max()) > 10 and q.supersteps_used >= int(depths.max())


def _ring_delta():
    return dict(add_src=[0, 64], add_dst=[64, 0],
                add_props={"weight": [1.0, 1.0]},
                rem_src=[10, 11], rem_dst=[11, 13])


@pytest.mark.parametrize("backend", ["null", "agent", "pipelined"])
@pytest.mark.parametrize("policy", ["finish", "reseed"])
def test_apply_delta_mid_flight_never_torn(ring, backend, policy):
    """A delta landing while a query is mid-flight never tears it: under
    "finish" the resident completes on the pre-delta graph, under "reseed"
    it restarts on the mutated one; queries admitted after the delta see
    the mutated graph."""
    g2 = ring.apply_edge_delta(EdgeDelta(**_ring_delta()))
    b = batcher("bfs", ring, backend)
    q_old = b.submit(0)
    b.pump()
    for _ in range(3):
        b.tick()
    b.apply_delta(EdgeDelta(**_ring_delta()), policy=policy)
    q_new = b.submit(5)
    b.run()
    assert q_old.status == "done" and q_new.status == "done"
    snapshot = ring if policy == "finish" else g2
    assert np.array_equal(_fix(q_old.result), _fix(fresh("bfs", snapshot, 0)))
    assert np.array_equal(_fix(q_new.result), _fix(fresh("bfs", g2, 5)))
    assert not np.array_equal(_fix(q_new.result), _fix(fresh("bfs", ring, 5)))


def test_apply_delta_holds_admissions_until_swap(ring):
    """Under "finish", a query submitted while a delta is pending waits for
    the residents to drain and runs on the mutated graph; an idle batcher
    swaps at once.  The JAX package's batcher serves the same answers."""
    g2 = ring.apply_edge_delta(EdgeDelta(**_ring_delta()))
    b = batcher("bfs", ring)
    jb = JaxBatcher(JaxEngine(jalg.bfs_program(D)),
                    JaxPartition.from_graph(to_graph(ring, JaxGraph)))
    qa, jqa = b.submit(0), jb.submit(0)
    for x in (b, jb):
        x.pump()
        x.tick()
    b.apply_delta(EdgeDelta(**_ring_delta()))
    jb.apply_delta(JaxDelta(**_ring_delta()))
    assert b._pending_deltas
    qb, jqb = b.submit(5), jb.submit(5)
    b.run()
    jb.run()
    assert not b._pending_deltas
    for q, jq, snapshot, src in ((qa, jqa, ring, 0), (qb, jqb, g2, 5)):
        assert np.array_equal(_fix(q.result), _fix(fresh("bfs", snapshot,
                                                         src)))
        assert np.array_equal(_fix(q.result), _fix(jq.result))
        assert q.supersteps_used == jq.supersteps_used
    b2 = batcher("bfs", ring)
    b2.apply_delta(EdgeDelta(**_ring_delta()))
    assert not b2._pending_deltas


@pytest.mark.parametrize("kind", ["bfs", "ppr"])
def test_recycled_lane_after_delta_bitwise(rmat, kind):
    """Lanes recycled after a delta answer as fresh runs on the mutated
    graph do."""
    rng = np.random.default_rng(7)
    pick = rng.choice(rmat.num_edges, size=8, replace=False)
    fields = dict(add_src=rng.integers(0, rmat.num_vertices, size=8),
                  add_dst=rng.integers(0, rmat.num_vertices, size=8),
                  add_props={"weight": np.ones(8, np.float32)},
                  rem_src=rmat.src[pick], rem_dst=rmat.dst[pick])
    g2 = rmat.apply_edge_delta(EdgeDelta(**fields))
    b = batcher(kind, rmat)
    b.apply_delta(EdgeDelta(**fields))
    for s in SOURCES:
        b.submit(s)
    done = b.run()
    for q in done:
        assert np.array_equal(_fix(q.result), _fix(fresh(kind, g2,
                                                         q.source)))


@pytest.mark.parametrize("backend", ["null", "agent"])
def test_lane_buffers_never_reallocated(rmat, backend):
    """Admissions and evictions update the lane state in place: every state
    tensor keeps its storage across the pumps between ticks (the port's
    counterpart of the JAX package's one-compilation check)."""
    b = batcher("ppr", rmat, backend)
    fields = ("vertex_data", "scatter_data", "active_scatter", "lane_active")
    rng = np.random.default_rng(0)
    for s in rng.integers(0, rmat.num_vertices, size=12):
        b.submit(int(s), max_supersteps=None if s % 3 else 2)
    admits = 0
    while b.queue or b.busy:
        ptrs = [getattr(b.state, f).data_ptr() for f in fields]
        before = len(b.queue)
        b.pump()
        admits += before - len(b.queue)
        assert [getattr(b.state, f).data_ptr() for f in fields] == ptrs
        if b.busy:
            b.tick()
    assert admits == 12


def test_sum_monoid_plan_clamped_to_dense(rmat):
    """A PPR engine handed a compacted frontier is pinned to the dense scan
    (an order-fixed fold); its lanes then recycle bitwise."""
    eng = GREEngine(algorithms.ppr_push_program(D), frontier="compact",
                    frontier_cap=64)
    b = GraphQueryBatcher(eng, DevicePartition.from_graph(rmat,
                                                          device="cpu"))
    assert eng.frontier == "dense" and eng.frontier_cap is None
    assert not eng.dense_frontier
    deng = DistGREEngine(algorithms.ppr_push_program(D), K,
                         frontier="compact", frontier_cap=8, device="cpu")
    GraphQueryBatcher(deng, build_agent_graph(rmat, "hdrf", K))
    assert deng.local.frontier == "dense" and deng.local.frontier_cap is None
    for s in SOURCES[:6]:
        b.submit(s)
    for q in b.run():
        assert np.array_equal(q.result, fresh("ppr", rmat, q.source))


def test_refusals(rmat):
    with pytest.raises(ValueError, match="lane_activates"):
        GraphQueryBatcher(GREEngine(algorithms.bfs_program()),
                          DevicePartition.from_graph(rmat, device="cpu"))
    eng = DistGREEngine(algorithms.bfs_program(D), K, exchange="async",
                        device="cpu")
    with pytest.raises(ValueError, match="serving tick"):
        GraphQueryBatcher(eng, build_agent_graph(rmat, "hdrf", K))
    with pytest.raises(ValueError, match="policy"):
        batcher("bfs", rmat).apply_delta(EdgeDelta(), policy="later")


def test_frontend_metrics(rmat):
    """A mixed-kind frontend drains every batcher; the metrics are set."""
    fe = ServingFrontend({kind: batcher(kind, rmat, steps_per_tick=2)
                          for kind in PROGRAMS})
    rng = np.random.default_rng(1)
    kinds = sorted(PROGRAMS)
    for i in range(12):
        fe.submit(kinds[i % 3], int(rng.integers(0, rmat.num_vertices)))
    done = fe.run()
    assert len(done) == 12 and all(q.status == "done" for q in done)
    for kind, m in fe.metrics().items():
        assert m["queries_done"] == 4.0
        assert 0.0 < m["lane_occupancy"] <= 1.0
        assert m["latency_p95_s"] >= m["latency_p50_s"] >= 0.0
        assert m["supersteps_p50"] >= 2.0 and m["supersteps"] % 2 == 0
        assert np.isfinite(m["qps"]) and m["qps"] > 0
